"""The port's corruption transforms, Philox draws and router against fav_tpu.

Each randomized family of ``fav_tpu_torch.ops.corruptions`` is a transform of
its draws; here the transforms are fed the draws ``fav_tpu``'s own oracle
made (``jax.random``), so they are held to the oracle exactly. The port's
own Philox stream is checked against the Random123 known-answer vectors and
for its moments. Kernels run only on the card (``chip_smoke.py``); on the
CPU every wrapper takes its plain version, which is what these tests drive.

Tolerances: transforms given the oracle's draws are exact (the same float32
operations in the same order); contrast is held to 1e-6, the bar
``tests/test_pallas.py`` sets for the Pallas kernel, because the per-image
mean is summed in another order.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fav_tpu.ops import corruptions as jc
from fav_tpu.ops.corruptions_pallas import brightness_pallas, contrast_pallas
from fav_tpu_torch.ops import corruptions as tc
from fav_tpu_torch.ops import corruptions_cuda as cuda_ops
from fav_tpu_torch.ops.random import bits_to_uniform, philox4x32, random_words, uniform01

SEVERITIES = (1, 2, 3, 4, 5)


def _images(seed: int = 0, shape=(8, 16, 16, 3)) -> np.ndarray:
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _np(a) -> np.ndarray:
    # conftest turns on jax_enable_x64: cast oracle outputs before comparing
    return np.array(a, dtype=np.float32)


# ── severity tables and names ──────────────────────────────────────────────

@pytest.mark.parametrize("table", ["GAUSSIAN_SIGMA", "SHOT_C", "IMPULSE_AMOUNT", "BRIGHTNESS_C", "CONTRAST_C"])
def test_severity_table_equals_fav_tpu(table):
    assert getattr(tc, table) == getattr(jc, table)


def test_corruption_names_equal_fav_tpu():
    assert tuple(tc.CORRUPTION_NAMES) == tuple(jc.CORRUPTION_NAMES)


# ── transforms fed the oracle's draws ──────────────────────────────────────

@pytest.mark.parametrize("severity", SEVERITIES)
def test_gaussian_from_normal_equals_oracle(severity):
    x = _images(severity)
    key = jax.random.PRNGKey(100 + severity)
    z = jax.random.normal(key, x.shape, jnp.float32)
    want = _np(jc.gaussian_noise(key, jnp.asarray(x), severity))
    got = tc.gaussian_from_normal(torch.from_numpy(x), torch.from_numpy(_np(z)), severity).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("severity", SEVERITIES)
def test_impulse_from_uniform_equals_oracle(severity):
    x = _images(10 + severity)
    key = jax.random.PRNGKey(200 + severity)
    k1, _ = jax.random.split(key)  # the oracle's own draw (corruptions.py:98-104)
    u = jax.random.uniform(k1, x.shape, jnp.float32)
    want = _np(jc.impulse_noise(key, jnp.asarray(x), severity))
    got = tc.impulse_from_uniform(torch.from_numpy(x), torch.from_numpy(_np(u)), severity).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 1.0).any() and (got == 0.0).any()


@pytest.mark.parametrize("severity", SEVERITIES)
def test_brightness_equals_oracle_and_pallas(severity):
    x = _images(20 + severity)
    key = jax.random.PRNGKey(0)  # unused by the oracle
    got = tc.brightness(torch.from_numpy(x), severity).numpy()
    np.testing.assert_array_equal(got, _np(jc.brightness(key, jnp.asarray(x), severity)))
    np.testing.assert_array_equal(got, _np(brightness_pallas(7, jnp.asarray(x), severity, interpret=True)))


@pytest.mark.parametrize("severity", SEVERITIES)
def test_contrast_equals_oracle_and_pallas(severity):
    x = _images(30 + severity)
    key = jax.random.PRNGKey(0)
    got = tc.contrast(torch.from_numpy(x), severity).numpy()
    np.testing.assert_allclose(got, _np(jc.contrast(key, jnp.asarray(x), severity)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, _np(contrast_pallas(7, jnp.asarray(x), severity, interpret=True)),
                               atol=1e-6, rtol=0)


def test_photometric_skips_the_mean_at_contrast_one():
    """With c = 1 the output is clip(x + b) bit for bit: no (x - mu) + mu
    round trip."""
    x = torch.from_numpy(_images(3))
    np.testing.assert_array_equal(tc.photometric(x, 0.3, 1.0).numpy(), torch.clamp(x + 0.3, 0, 1).numpy())


def _poisson_counts_f64(lam: np.ndarray, u: np.ndarray, k_max: int):
    """Inverse CDF in float64: the number of partial sums cdf_k, k < k_max,
    that u exceeds; and each element's distance from its nearest partial sum."""
    count = np.zeros(lam.shape)
    gap = np.full(lam.shape, np.inf)
    cdf = np.zeros(lam.shape)
    log_lam = np.log(np.maximum(lam, 1e-300))
    for k in range(k_max):
        cdf = cdf + np.exp(k * log_lam - lam - math.lgamma(k + 1))
        count += u > cdf
        gap = np.minimum(gap, np.abs(u - cdf))
    return count, gap


@pytest.mark.parametrize("severity", SEVERITIES)
def test_shot_transform_equals_float64_inverse_cdf(severity):
    """Given the same uniforms, the float32 recurrence counts as the float64
    CDF does, except where u lies within 1e-4 of a partial sum: the float32
    log-pmf recurrence carries about k roundings of |log p_k| <= 70 into term
    k, up to some 1e-5 of the CDF at c = 60, and 1e-4 leaves room for that."""
    x = _images(40 + severity, (16, 16, 16, 3)).astype(np.float64)
    u = _np(uniform01(1000 + severity, x.size)).reshape(x.shape)
    c = tc.SHOT_C[severity - 1]
    k_max = tc.shot_k_max(severity)
    xt = torch.from_numpy(x.astype(np.float32))
    got = tc.poisson_inverse_cdf(xt * c, torch.from_numpy(u), k_max).numpy()
    want, gap = _poisson_counts_f64(x.astype(np.float32).astype(np.float64) * c, u.astype(np.float64), k_max)
    clear = gap > 1e-4
    np.testing.assert_array_equal(got[clear], want[clear])
    assert (~clear).mean() < 1e-2
    out = tc.shot_from_uniform(xt, torch.from_numpy(u), severity).numpy()
    np.testing.assert_array_equal(out, np.clip(got / np.float32(c), 0, 1).astype(np.float32))


def test_shot_k_max_matches_pallas_formula():
    for c in tc.SHOT_C:
        sev = tc.SHOT_C.index(c) + 1
        assert tc.shot_k_max(sev) == int(c + 10.0 * math.sqrt(c)) + 8
    assert tc.shot_k_max(3) == 54
    log_k = tc.shot_log_k(54)
    assert len(log_k) == 54 and log_k[1] == 0.0 and log_k[10] == float(np.float32(np.log(10)))


@pytest.mark.parametrize("severity", (1, 3, 5))
def test_shot_law_matches_jax_poisson(severity):
    """Per-pixel mean and variance of the port's shot noise (Philox draws,
    log-space inverse CDF) against jax.random.poisson's over 4096 draws of
    24 pixel values. Sampling bound: each mean differs by at most 6 standard
    errors of the difference of two independent means, each variance by at
    most 6 standard errors estimated from the fourth central moments."""
    n_draws = 4096
    pix = np.linspace(0.0, 1.0, 24, dtype=np.float32)
    x = np.broadcast_to(pix, (n_draws, 24)).copy()
    c = tc.SHOT_C[severity - 1]
    port = tc.shot_noise_plain(77 + severity, torch.from_numpy(x), severity).numpy().astype(np.float64)
    ref = _np(jc.shot_noise(jax.random.PRNGKey(severity), jnp.asarray(x)[:, None, :, None], severity))
    ref = ref.reshape(n_draws, 24).astype(np.float64)
    for a, b in ((port, ref),):
        ma, mb = a.mean(0), b.mean(0)
        va, vb = a.var(0), b.var(0)
        se_m = np.sqrt((va + vb) / n_draws) + 1e-12
        assert (np.abs(ma - mb) <= 6 * se_m).all(), (ma - mb) / se_m
        m4a = ((a - ma) ** 4).mean(0)
        m4b = ((b - mb) ** 4).mean(0)
        se_v = np.sqrt((m4a - va**2 + m4b - vb**2) / n_draws) + 1e-12
        assert (np.abs(va - vb) <= 6 * se_v).all(), (va - vb) / se_v
    # and both sit on Poisson(x c) / c where clipping at 1 cannot bite
    low = pix * c + 5 * np.sqrt(pix * c) < c
    np.testing.assert_allclose(port.mean(0)[low], pix[low], atol=6 * np.sqrt(pix[low] / c / n_draws).max() + 1e-9)


# ── Philox stream ──────────────────────────────────────────────────────────

_KAT = [  # Random123 known-answer vectors for Philox4x32-10
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", _KAT)
def test_philox_known_answers(counter, key, want):
    got = philox4x32(tuple(torch.tensor([c], dtype=torch.int64) for c in counter), key)
    assert tuple(int(w) for w in got) == want


def _philox_reference(counter, key):
    """Philox4x32-10 in Python integers, independent of the tensor version."""
    c = list(counter)
    k0, k1 = key
    m = 0xFFFFFFFF
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & m, (k1 + 0xBB67AE85) & m
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k0) & m, p1 & m, ((p0 >> 32) ^ c[3] ^ k1) & m, p0 & m]
    return c


@pytest.mark.parametrize("seed", [0, 1, 2**32 + 5, 2**63 + 12345])
def test_random_words_stream_layout(seed):
    """Element e of draw d is word e % 4 of philox((e // 4, 0, d, 0), seed)."""
    n, draw = 37, 1
    words = random_words(seed, n, draw).tolist()
    key = (seed & 0xFFFFFFFF, seed >> 32)
    for e in range(n):
        assert words[e] == _philox_reference((e // 4, 0, draw, 0), key)[e % 4]


def test_philox_counter_high_word_is_used():
    lo = philox4x32(tuple(torch.tensor([v]) for v in (5, 0, 0, 0)), (1, 2))
    hi = philox4x32(tuple(torch.tensor([v]) for v in (5, 1, 0, 0)), (1, 2))
    assert [int(a) for a in lo] != [int(b) for b in hi]
    assert [int(b) for b in hi] == _philox_reference((5, 1, 0, 0), (1, 2))


def test_uniforms_deterministic_and_seed_dependent():
    a = uniform01(11, 4096)
    np.testing.assert_array_equal(a.numpy(), uniform01(11, 4096).numpy())
    assert (a != uniform01(12, 4096)).float().mean() > 0.99
    assert (a != uniform01(11, 4096, draw=1)).float().mean() > 0.99
    # a prefix of a longer stream is the shorter stream
    np.testing.assert_array_equal(uniform01(11, 4099)[:4096].numpy(), a.numpy())


def test_uniform_moments():
    """Mean 1/2 and variance 1/12 within 6 standard errors over 2**18 draws."""
    n = 1 << 18
    u = uniform01(2024, n).double()
    assert abs(u.mean().item() - 0.5) < 6 * math.sqrt(1 / 12 / n)
    assert abs(u.var().item() - 1 / 12) < 6 * math.sqrt(1 / 180 / n)
    hist = torch.histc(u, bins=16, min=0, max=1)
    expected = n / 16
    assert ((hist - expected).abs() < 6 * math.sqrt(expected)).all()


def test_bits_to_uniform_excludes_zero():
    """(0, 1]: the least word maps to 2**-25, and the greatest,
    1 - 2**-25, rounds to 1.0 in float32 as on the TPU."""
    bits = torch.tensor([0, 255, 256, 0xFFFFFEFF, 0xFFFFFFFF], dtype=torch.int64)
    u = bits_to_uniform(bits)
    assert u.dtype == torch.float32
    assert u[0].item() == 0.5 / (1 << 24) and u[1].item() == u[0].item()
    assert u[2].item() == 1.5 / (1 << 24)
    assert u[3].item() < 1.0 and u[4].item() == 1.0
    assert torch.isfinite(torch.log(u)).all()


def test_box_muller_is_standard_normal():
    n = 1 << 17
    z = tc.box_muller(uniform01(5, n, 0), uniform01(5, n, 1)).double()
    assert abs(z.mean().item()) < 6 / math.sqrt(n)
    assert abs(z.var().item() - 1.0) < 6 * math.sqrt(2 / n)


# ── plain versions, wrappers and router ────────────────────────────────────

@pytest.mark.parametrize("name", tc.CORRUPTION_NAMES)
def test_router_returns_the_slice_families(name):
    fn = cuda_ops.corruption_fn(name)
    x = torch.from_numpy(_images(50))
    cuda_ops.reset_launch_counts()
    out = fn(9, x, 3)
    assert out.shape == x.shape and out.dtype == torch.float32
    assert 0.0 <= out.min().item() and out.max().item() <= 1.0
    # on a CPU tensor the wrapper is its plain version, and launches nothing
    np.testing.assert_array_equal(out.numpy(), tc.corruption_fn(name)(9, x, 3).numpy())
    assert sum(cuda_ops.launch_counts().values()) == 0


def test_router_rejects_unknown_names():
    for router in (cuda_ops.corruption_fn, tc.corruption_fn):
        with pytest.raises(NotImplementedError, match="unknown"):
            router("not_a_family")


@pytest.mark.parametrize("name", ["gaussian_noise", "shot_noise", "impulse_noise"])
def test_noise_plain_is_its_draws_then_its_transform(name):
    x = torch.from_numpy(_images(60))
    seed = 31
    n = x.numel()
    u0 = uniform01(seed, n, 0).reshape(x.shape)
    if name == "gaussian_noise":
        want = tc.gaussian_from_normal(x, tc.box_muller(u0, uniform01(seed, n, 1).reshape(x.shape)), 3)
    elif name == "shot_noise":
        want = tc.shot_from_uniform(x, u0, 3)
    else:
        want = tc.impulse_from_uniform(x, u0, 3)
    got = tc.corruption_fn(name)(seed, x, 3)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert not torch.equal(got, tc.corruption_fn(name)(seed + 1, x, 3))


@pytest.mark.parametrize("name", tc.CORRUPTION_NAMES)
def test_wrappers_check_their_input(name):
    fn = cuda_ops.corruption_fn(name)
    x = torch.from_numpy(_images(70))
    with pytest.raises(TypeError):
        fn(1, x.double(), 3)
    with pytest.raises(ValueError):
        fn(1, x.permute(0, 2, 1, 3), 3)  # not contiguous
    with pytest.raises(ValueError):
        fn(1, x.reshape(-1), 3)  # no batch axis
    with pytest.raises(ValueError):
        fn(1, x, 6)  # severity out of range


def test_seeds_outside_64_bits_are_refused():
    x = torch.from_numpy(_images(71))
    with pytest.raises(ValueError):
        cuda_ops.gaussian_noise(-1, x, 3)
    with pytest.raises(ValueError):
        cuda_ops.impulse_noise(1 << 64, x, 3)
