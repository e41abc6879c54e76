"""The port's AugMix (``fav_tpu_torch.ops.augment``) and the CPU side of
K9a/K9b's wrappers against ``fav_tpu/ops/augment.py``.

The same numpy images and the same shifts, knobs, magnitudes and draws go
through both packages. ``torch.Generator`` cannot replay ``jax.random``, so
the AugMix parity replays ``augmix``'s key schedule with JAX in the test
(``augment.py:465-506``, ``_chain`` :310-348) and feeds those draws to
``augmix_apply``; the port's own draws are held to the same laws.

Tolerance classes:

* exact: the shear passes against eager ``_shift_rows``/``_shift_cols``
  (the same three roundings of ``(1 - f) * a + f * b``); under ``jax.jit``
  XLA contracts ``f * b + ...`` into an FMA on the CPU, so against the
  jitted form the limit is one float32 ulp of [0, 1] values (6e-8);
  posterize and solarize fed the same magnitudes; the affine at every knob
  0 (the identity);
* 1e-6: autocontrast (the division's rounding under XLA's fusion);
* 1e-5: the affine against ``_affine_scanline`` and against
  ``affine_scanline_pallas(interpret=True)``, the bar ``fav_tpu`` holds its
  own Pallas route to (``tests/test_augment.py``): ``tan``/``sin`` and the
  shift arithmetic round differently in the two libraries;
* 2e-5: AugMix fed ``fav_tpu``'s draws (the affine's bar, through
  posterize, autocontrast and the mix), except where a chain's posterize
  meets a rounding tie: there one ulp of the affine between the libraries
  moves ``round(x (L - 1))`` by a whole level (seen once in 24,576
  elements). Each such element is asserted to lie at a tie of some chain
  (within 1e-3 of a half level), and they number at most 1e-3 of all;
* 1e-6 relative: ``js_consistency``;
* statistical: the port's own draws, each law within about seven standard
  errors of its sample.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fav_tpu.ops import augment as ja
from fav_tpu.ops.augment_pallas import affine_scanline_pallas
from fav_tpu_torch.ops import augment as ta
from fav_tpu_torch.ops import augment_cuda

F32_ULP_1 = float(np.spacing(np.float32(1.0)) / 2)  # one ulp of values in [0.5, 1)
AFFINE_ATOL = 1e-5
AUGMIX_ATOL = 2e-5
POSTERIZE_TIE_FRACTION = 1e-3


def _images(seed: int, n: int = 8) -> np.ndarray:
    return np.random.default_rng(seed).random((n, 32, 32, 3), dtype=np.float32)


def _deltas(m: int, b: int, n: int, seed: int) -> np.ndarray:
    """Shifts past the clip limits, at them, integers and 0."""
    d = np.random.default_rng(seed).uniform(-m - 4, m + 4, (b, n)).astype(np.float32)
    d[0] = np.round(d[0])
    d[1] = 0.0
    d[2, : n // 2] = -m
    d[2, n // 2:] = m - 1
    d[3, ::2] = m - 1 + 0.5  # clipped down to m - 1
    return d


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("m", [18, 22])
@pytest.mark.parametrize("axis", ["rows", "cols"])
def test_shift_matches_fav_tpu(m, axis):
    x = _images(1, 6)
    d = _deltas(m, 6, 32, m)
    jfn = getattr(ja, f"_shift_{axis}")
    got = getattr(ta, f"shift_{axis}")(_t(x), _t(d), m).numpy()
    eager = np.asarray(jfn(jnp.asarray(x), jnp.asarray(d), m), np.float32)
    jitted = np.asarray(jax.jit(jfn, static_argnums=2)(jnp.asarray(x), jnp.asarray(d), m), np.float32)
    np.testing.assert_array_equal(got, eager)
    np.testing.assert_allclose(got, jitted, atol=F32_ULP_1, rtol=0)
    # the wrapper of the kernel takes the plain version for a CPU tensor
    wrapper = getattr(augment_cuda, f"shear_{axis}")
    np.testing.assert_array_equal(wrapper(_t(x), _t(d), m).numpy(), got)


def test_shift_rows_matches_the_window_oracle():
    x, d = _images(2, 4), _deltas(18, 4, 32, 2)
    want = np.asarray(ja._shift_rows_windows(jnp.asarray(x), jnp.asarray(d), 18), np.float32)
    np.testing.assert_array_equal(ta.shift_rows(_t(x), _t(d), 18).numpy(), want)


def test_shear_wrappers_check_their_input():
    x = torch.zeros(2, 32, 32, 3)
    with pytest.raises(ValueError, match="delta"):
        augment_cuda.shear_rows(x, torch.zeros(2, 31), 18)
    with pytest.raises(ValueError, match="delta"):
        augment_cuda.shear_cols(x, torch.zeros(2, 32, dtype=torch.float64), 22)
    with pytest.raises(ValueError, match="NHWC"):
        augment_cuda.shear_rows(torch.zeros(2, 32, 32), torch.zeros(2, 32), 18)
    with pytest.raises(ValueError, match="contiguous"):
        augment_cuda.shear_rows(x.transpose(1, 2), torch.zeros(2, 32), 18)


def test_shift_bounds_equal_the_pallas_margins():
    assert ta.shift_bounds(32, 32) == (18, 22)


def _knobs(seed: int, b: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    mags = rng.random((5, b)).astype(np.float32) * (rng.random((5, b)) < 0.6)
    signs = np.where(rng.random((5, b)) < 0.5, 1.0, -1.0).astype(np.float32)
    scale = np.array([ja._MAX_ROT, ja._MAX_SHEAR, ja._MAX_SHEAR, ja._MAX_TRANSLATE * 32,
                      ja._MAX_TRANSLATE * 32], np.float32)[:, None]
    return list((signs * mags * scale).astype(np.float32))


def test_affine_matches_fav_tpu_xla_route():
    x, knobs = _images(3, 16), _knobs(3, 16)
    got = ta.affine_scanline(_t(x), *map(_t, knobs)).numpy()
    want = np.asarray(jax.jit(ja._affine_scanline)(jnp.asarray(x), *map(jnp.asarray, knobs)), np.float32)
    np.testing.assert_allclose(got, want, atol=AFFINE_ATOL, rtol=0)


def test_affine_matches_fav_tpu_pallas_interpret():
    x, knobs = _images(4, 4), _knobs(4, 4)
    got = ta.affine_scanline(_t(x), *map(_t, knobs)).numpy()
    want = np.asarray(affine_scanline_pallas(jnp.asarray(x), *map(jnp.asarray, knobs), interpret=True),
                      np.float32)
    np.testing.assert_allclose(got, want, atol=AFFINE_ATOL, rtol=0)


def test_affine_identity_at_zero_knobs():
    x = _t(_images(5, 3))
    z = torch.zeros(3)
    np.testing.assert_array_equal(ta.affine_scanline(x, z, z, z, z, z).numpy(), x.numpy())
    np.testing.assert_array_equal(ta.affine_scanline(x, z, z, z, z, z, plain=True).numpy(), x.numpy())


def _mags(seed: int, b: int) -> np.ndarray:
    m = np.random.default_rng(seed).random(b).astype(np.float32)
    m[0], m[1] = 0.0, 1.0
    return m


@pytest.mark.parametrize("op,atol", [("posterize", 0.0), ("solarize", 0.0), ("autocontrast", 1e-6)])
def test_pointwise_ops_match_fav_tpu(op, atol):
    x, mag = _images(6, 12), _mags(6, 12)
    x[2] = 0.5  # a flat image: autocontrast's 1e-6 floor
    got = getattr(ta, op)(_t(x), _t(mag)).numpy()
    want = np.asarray(jax.jit(getattr(ja, f"_{op}"))(jnp.asarray(x), jnp.asarray(mag)), np.float32)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    if op != "posterize":  # magnitude 0 is the identity (posterize: on 8-bit values only)
        np.testing.assert_array_equal(got[0], x[0])


GATE_P = (1.0 + 3) / 2.0 / ja.NUM_OPS


@jax.jit
def jax_draws(key, images):
    """``augmix``'s draws for ``key`` (width 3, max_depth 3, alpha 1), by
    its own key schedule."""
    b, h, w, _ = images.shape
    width, n = 3, 3 * images.shape[0]
    k_dir, k_beta, k_chains = jax.random.split(key, 3)
    e = -jnp.log(jax.random.uniform(k_dir, (b, width), jnp.float32, jnp.finfo(jnp.float32).tiny, 1.0))
    ws = e / jnp.sum(e, axis=-1, keepdims=True)
    blend = jax.random.uniform(k_beta, (b,), jnp.float32)
    k_gate, k_mag, k_sign, _ = jax.random.split(k_chains, 4)
    gates = jax.random.bernoulli(k_gate, GATE_P, (ja.NUM_OPS, n)).astype(jnp.float32)
    mags = jax.random.uniform(k_mag, (ja.NUM_OPS, n), jnp.float32) * gates
    signs = jax.random.split(k_sign, 5)
    return {
        "ws": ws, "blend": blend,
        "theta": ja._signed(signs[0], mags[0]) * ja._MAX_ROT,
        "shear_x": ja._signed(signs[1], mags[1]) * ja._MAX_SHEAR,
        "shear_y": ja._signed(signs[2], mags[2]) * ja._MAX_SHEAR,
        "tx": ja._signed(signs[3], mags[3]) * ja._MAX_TRANSLATE * w,
        "ty": ja._signed(signs[4], mags[4]) * ja._MAX_TRANSLATE * h,
        "posterize": mags[5], "solarize": mags[6], "autocontrast": mags[7],
    }


def _posterize_ties(x: np.ndarray, draws: ta.AugMixDraws) -> np.ndarray:
    """Where some chain's posterize input lies within 1e-3 of a half level."""
    b = x.shape[0]
    rep = _t(np.tile(x, (3, 1, 1, 1)))
    aff = ta.affine_scanline(rep, draws.theta, draws.shear_x, draws.shear_y, draws.tx, draws.ty).numpy()
    levels = np.round(256.0 - 252.0 * draws.posterize.numpy()).reshape(-1, 1, 1, 1)
    v = aff * (levels - 1.0)
    tie = (np.abs(v - np.floor(v) - 0.5) < 1e-3) & (draws.posterize.numpy() > 0).reshape(-1, 1, 1, 1)
    return tie.reshape(3, b, *x.shape[1:]).any(axis=0)


def draws_to_torch(d: dict) -> ta.AugMixDraws:
    return ta.AugMixDraws(**{k: _t(np.asarray(d[k], np.float32)) for k in ta.AugMixDraws._fields})


@pytest.mark.parametrize("seed", [0, 1])
def test_augmix_apply_reproduces_fav_tpu_augmix(seed):
    x = _images(10 + seed, 8)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(ja.augmix(key, jnp.asarray(x)), np.float32)
    draws = draws_to_torch(jax_draws(key, jnp.asarray(x)))
    assert float(draws.posterize.gt(0).float().mean()) > 0.1  # the chains do change the images
    got = ta.augmix_apply(_t(x), draws).numpy()
    assert got.shape == want.shape == x.shape
    off = np.abs(got - want) > AUGMIX_ATOL
    assert off.mean() <= POSTERIZE_TIE_FRACTION
    if off.any():
        ties = _posterize_ties(x, draws)
        assert ties[off].all(), "an element off by more than 2e-5 lies at no posterize tie"
    np.testing.assert_array_equal(ta.augmix_apply(_t(x), draws, plain=True).numpy(), got)


def test_augmix_draws_follow_fav_tpu_laws():
    b = 4096
    d = ta.augmix_draws(torch.Generator().manual_seed(0), b)
    n = 3 * b
    assert d.ws.shape == (b, 3) and d.blend.shape == (b,) and d.theta.shape == (n,)
    # Dirichlet(1, 1, 1): on the simplex, marginals Beta(1, 2) (mean 1/3, var 2/36)
    assert bool((d.ws > 0).all()) and float((d.ws.sum(-1) - 1).abs().max()) < 1e-6
    np.testing.assert_allclose(d.ws.mean(0).numpy(), 1 / 3, atol=0.01)
    np.testing.assert_allclose(d.ws.var(0).numpy(), 2 / 36, atol=0.005)
    # blend U(0, 1): mean 1/2 (se 0.0045), var 1/12
    assert abs(float(d.blend.mean()) - 0.5) < 0.03 and abs(float(d.blend.var()) - 1 / 12) < 0.01
    # each op gated at (1 + max_depth) / 2 / 8 = 1/4 (se 0.0039 per op)
    ops = [d.theta, d.shear_x, d.shear_y, d.tx, d.ty, d.posterize, d.solarize, d.autocontrast]
    for v in ops:
        assert abs(float((v != 0).float().mean()) - 0.25) < 0.03
    # a gated magnitude is U(0, 1) (mean 1/2, se 0.005)
    for v, scale in zip(ops, [ta.MAX_ROT, ta.MAX_SHEAR, ta.MAX_SHEAR, 8.0, 8.0, 1.0, 1.0, 1.0]):
        live = v[v != 0] / scale
        assert float(live.abs().max()) <= 1.0 + 1e-6 and abs(float(live.abs().mean()) - 0.5) < 0.04
    # signs of the geometry knobs fair (se 0.009 per knob)
    for v in ops[:5]:
        live = v[v != 0]
        assert abs(float((live > 0).float().mean()) - 0.5) < 0.06
    assert float(d.posterize.min()) >= 0.0  # pointwise magnitudes are unsigned


def test_augmix_is_a_function_of_the_generator():
    x = torch.from_numpy(_images(12, 4))
    a = ta.augmix(torch.Generator().manual_seed(5), x)
    b = ta.augmix(torch.Generator().manual_seed(5), x, plain=True)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert a.shape == x.shape and float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    assert not torch.equal(a, ta.augmix(torch.Generator().manual_seed(6), x))


@pytest.mark.parametrize("kw", [{"alpha": 0.5}, {"freq": True}, {"occlude": True}, {"bars": True},
                                {"bf16": True}])
def test_augmix_refuses_what_is_not_ported(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ta.augmix(torch.Generator(), torch.zeros(2, 32, 32, 3), **kw)


def test_js_consistency_matches_fav_tpu():
    rng = np.random.default_rng(13)
    logits = [rng.normal(0, 3, (16, 10)).astype(np.float32) for _ in range(3)]
    got = float(ta.js_consistency(*map(_t, logits)))
    want = float(ja.js_consistency(*map(jnp.asarray, logits)))
    assert got > 0 and abs(got - want) <= 1e-6 * abs(want)
    same = float(ta.js_consistency(*[_t(logits[0])] * 3))
    assert abs(same) < 1e-7 and abs(float(ja.js_consistency(*[jnp.asarray(logits[0])] * 3))) < 1e-7
