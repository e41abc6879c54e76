"""The ten families the port added after K1-K4, and kernels K5 and K6, against fav_tpu.

Every family is a transform of its draws, so each transform is fed the
draws ``fav_tpu`` itself made (``jax.random`` under the same key splits as
``corruptions_pallas.py``'s matmul forms) and held to the JAX function on
the same numpy images, at batch 8 and 32x32 (the shape the megastep runs).
The JAX outputs are cast to float32 first (``tests/conftest.py`` turns on
x64).

Tolerances:

* the band matrices made in numpy, against ``fav_tpu.ops.image``'s and
  ``jax.image.resize`` on an identity: 1e-6 (both build in float64 or
  float32 and cast; measured differences are 0 or 1.4e-8);
* the band-matrix families, glass through its blurs, and elastic's fields:
  reassociation, 3e-6. The products sum the same terms in other orders
  (observed <= 1e-6 on values in [0, 1]; the fields are pixel coordinates
  up to 31, where one float32 step is 1.9e-6);
* the elastic warp given the same fields: 1e-6. It runs the oracle's
  operations in its order; XLA may contract a multiply and an add, one
  rounding (observed 1.2e-7);
* glass's resample given the same uniforms, against the Pallas kernel in
  interpret mode: exact (pure selection);
* JPEG: ``round(coef / q)`` flips where a coefficient lands within a
  rounding of a half-integer step, and then its whole 8x8 block moves.
  Outside such blocks every element is within 3e-6; at most 1% of blocks
  may differ.
"""

from __future__ import annotations

import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fav_tpu.ops import corruptions as jc
from fav_tpu.ops import corruptions_pallas as cp
from fav_tpu.ops import image as ji
from fav_tpu_torch.ops import corruptions as tc
from fav_tpu_torch.ops import corruptions_cuda as cuda_ops
from fav_tpu_torch.ops import image as ti

SEVERITIES = (1, 2, 3, 4, 5)
SHAPE = (8, 32, 32, 3)
MATRIX_TOL = 1e-6
REASSOC_TOL = 3e-6
WARP_TOL = 1e-6
JPEG_MAX_BLOCK_FRACTION = 0.01


def _images(seed: int, shape=SHAPE) -> np.ndarray:
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _np(a) -> np.ndarray:
    return np.array(a, dtype=np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(_np(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), atol=tol, rtol=0)


# ── severity tables ────────────────────────────────────────────────────────

@pytest.mark.parametrize("table", ["DEFOCUS_SEV", "GLASS_SEV", "MOTION_SEV", "ZOOM_ZMAX", "SNOW_SEV",
                                   "FOG_SEV", "FROST_SEV"])
def test_severity_table_equals_fav_tpu(table):
    assert getattr(tc, table) == getattr(jc, table)


def test_elastic_pixelate_jpeg_and_motion_tables_equal_fav_tpu():
    assert tc.ELASTIC_SEV == tuple(jc._ELASTIC_SEV)
    np.testing.assert_array_equal(tc.JPEG_Q_LUMA, jc._JPEG_Q_LUMA)
    np.testing.assert_array_equal(tc.JPEG_Q_CHROMA, jc._JPEG_Q_CHROMA)
    for q in (1, 7, 10, 15, 18, 25, 49, 50, 75, 100):
        assert tc.quality_scale(q) == jc._quality_scale(q)
    # pixelate's fractions, jpeg's qualities and the streak angles are
    # literals inside the JAX functions (corruptions.py:329, :374, :171)
    assert f"_sev({list(tc.PIXELATE_FRAC)}, severity)" in inspect.getsource(jc.pixelate)
    assert f"_sev({list(tc.JPEG_QUALITY)}, severity)" in inspect.getsource(jc.jpeg_compression)
    assert "angles = np.linspace(-45.0, 45.0, 8)" in inspect.getsource(jc.motion_blur)
    assert tc.MOTION_ANGLES == tuple(np.linspace(-45.0, 45.0, 8))


# ── band matrices made in numpy ────────────────────────────────────────────

@pytest.mark.parametrize("size,sigma", [(32, 1.0), (32, 4.5), (32, 6.0), (16, 0.7)])
def test_blur_band_matrix_equals_fav_tpu(size, sigma):
    radius = max(1, int(3.0 * sigma + 0.5))
    _close(ti.blur_band_matrix(size, sigma, radius), ji._blur_band_matrix(size, sigma, radius), MATRIX_TOL)
    np.testing.assert_array_equal(ti.gaussian_kernel1d(sigma, radius), ji.gaussian_kernel1d(sigma, radius))


@pytest.mark.parametrize("psf", ["disk3", "disk6", "disk10", "motion0", "motion4", "snow"])
def test_svd_band_factors_equal_fav_tpu(psf):
    if psf.startswith("disk"):
        k_port, k_jax = ti.disk_kernel(int(psf[4:]), 0.5), ji.disk_kernel(int(psf[4:]), 0.5)
    elif psf.startswith("motion"):
        angle = tc.MOTION_ANGLES[int(psf[6:])]
        k_port, k_jax = ti.motion_kernel(11, angle, 7.0), ji.motion_kernel(11, angle, 7.0)
    else:
        k_port, k_jax = ti.motion_kernel(9, -60.0, 2.5), ji.motion_kernel(9, -60.0, 2.5)
    np.testing.assert_array_equal(k_port, k_jax)
    my, mx = ti.svd_band_factors(k_port, 32, 32)
    jy, jx = ji.svd_band_factors(k_jax, 32, 32)
    assert my.shape == jy.shape and mx.shape == jx.shape
    # singular vectors are fixed only up to sign per rank; the products are not
    _close(np.einsum("rvh,ruw->vhuw", my, mx), np.einsum("rvh,ruw->vhuw", jy, jx), MATRIX_TOL)


@pytest.mark.parametrize("out_size,in_size", [(32, 2), (32, 4), (32, 8), (32, 16), (32, 32), (64, 32)])
def test_resize_band_equals_fav_tpu(out_size, in_size):
    _close(ti.resize_band(out_size, in_size), ji.resize_band(out_size, in_size), MATRIX_TOL)


@pytest.mark.parametrize("zoomed", [35, 37, 39, 40, 42, 64])
def test_resize_crop_band_equals_fav_tpu(zoomed):
    crop = (zoomed - 32) // 2 if zoomed < 64 else 0
    _close(ti.resize_crop_band(32, zoomed, crop), ji.resize_crop_band(32, zoomed, crop), MATRIX_TOL)


@pytest.mark.parametrize("severity", SEVERITIES)
def test_pixelate_matrices_equal_jax_image_resize(severity):
    """The downsample (antialiased bilinear) and the nearest upsample, each
    against ``jax.image.resize`` applied to an identity."""
    small = int(32 * tc.PIXELATE_FRAC[severity - 1])
    eye = jnp.eye(32, dtype=jnp.float32)[None, :, :, None]
    down = _np(jax.image.resize(eye, (1, small, 32, 1), "bilinear"))[0, :, :, 0]
    eye_s = jnp.eye(small, dtype=jnp.float32)[None, :, :, None]
    up = _np(jax.image.resize(eye_s, (1, 32, small, 1), "nearest"))[0, :, :, 0]
    _close(ti.resize_band(small, 32), down, MATRIX_TOL)
    np.testing.assert_array_equal(ti.nearest_band(32, small), up)


def test_dct_matrices_equal_fav_tpu():
    np.testing.assert_array_equal(ti.dct8(), ji._dct8())
    a = _images(1, (2, 16, 24))
    d16, d24 = ti.block_dct_matrix(16), ti.block_dct_matrix(24)
    # DCT coefficients of values in [0, 1] reach 8: reassociation scales with them
    _close(d16 @ a @ d24.T, _np(ji.blockwise_dct8(jnp.asarray(a))), 8 * REASSOC_TOL)
    _close(d16.T @ a @ d24, _np(ji.blockwise_idct8(jnp.asarray(a))), 8 * REASSOC_TOL)


def test_gaussian_blur_and_conv_products_equal_fav_tpu():
    x = _images(2)
    _close(ti.gaussian_blur_matmul(_t(x), 1.0).numpy(), _np(ji.gaussian_blur_matmul(jnp.asarray(x), 1.0)),
           REASSOC_TOL)
    k = ti.disk_kernel(6, 0.5)
    _close(ti.depthwise_conv2d_matmul(_t(x), k).numpy(), _np(ji.depthwise_conv2d_matmul(jnp.asarray(x), k)),
           REASSOC_TOL)
    _close(ti.rgb_to_gray(_t(x)).numpy(), _np(ji.rgb_to_gray(jnp.asarray(x))), REASSOC_TOL)


# ── deterministic band-matrix families ─────────────────────────────────────

@pytest.mark.parametrize("severity", SEVERITIES)
@pytest.mark.parametrize("name", ["defocus_blur", "zoom_blur", "pixelate"])
def test_deterministic_family_equals_fav_tpu(name, severity):
    x = _images(10 + severity)
    key = jax.random.PRNGKey(0)  # unused by all three
    want = {"defocus_blur": cp.defocus_blur_matmul, "zoom_blur": cp.zoom_blur_matmul,
            "pixelate": jc.pixelate}[name](key, jnp.asarray(x), severity)
    got = getattr(tc, name)(_t(x), severity)
    _close(got.numpy(), _np(want), REASSOC_TOL)


# ── families fed fav_tpu's draws ───────────────────────────────────────────

def _octaves(key, batch: int) -> list[torch.Tensor]:
    """``_turbulence_matmul``'s key schedule: one split per octave."""
    out = []
    for shape in tc.octave_shapes(batch, 32, 32):
        key, k = jax.random.split(key)
        out.append(_t(jax.random.uniform(k, shape, jnp.float32)))
    return out


@pytest.mark.parametrize("severity", SEVERITIES)
@pytest.mark.parametrize("name", ["motion_blur", "snow", "fog", "frost"])
def test_family_fed_jax_draws_equals_fav_tpu(name, severity):
    x = _images(20 + severity)
    key = jax.random.PRNGKey(300 + severity)
    xt = _t(x)
    if name == "motion_blur":
        idx = int(jax.random.randint(key, (), 0, 8))
        got = tc.motion_from_index(xt, idx, severity)
        want = cp.motion_blur_matmul(key, jnp.asarray(x), severity)
    elif name == "snow":
        k1, _ = jax.random.split(key)
        z = _t(jax.random.normal(k1, (SHAPE[0], 32, 32, 1), jnp.float32))
        got = tc.snow_from_normal(xt, z, severity)
        want = cp.snow_matmul(key, jnp.asarray(x), severity)
    elif name == "fog":
        got = tc.fog_from_octaves(xt, _octaves(key, SHAPE[0]), severity)
        want = cp.fog_matmul(key, jnp.asarray(x), severity)
    else:
        got = tc.frost_from_octaves(xt, _octaves(key, SHAPE[0]), severity)
        want = cp.frost_matmul(key, jnp.asarray(x), severity)
    _close(got.numpy(), _np(want), REASSOC_TOL)


@pytest.mark.parametrize("severity", SEVERITIES)
def test_jpeg_equals_fav_tpu_outside_rounding_flips(severity):
    x = _images(30 + severity)
    got = tc.jpeg_compression(_t(x), severity).numpy()
    want = _np(jc.jpeg_compression(jax.random.PRNGKey(0), jnp.asarray(x), severity))
    far = np.abs(got.astype(np.float64) - want) > REASSOC_TOL
    # (B, H/8, 8, W/8, 8, C) -> blocks holding any element beyond the tolerance
    flipped = far.reshape(SHAPE[0], 4, 8, 4, 8, 3).any(axis=(2, 4, 5))
    assert flipped.mean() <= JPEG_MAX_BLOCK_FRACTION, f"{int(flipped.sum())} of {flipped.size} blocks differ"


# ── K5: glass ──────────────────────────────────────────────────────────────

def _jax_glass(x: np.ndarray, us, severity: int):
    """fav_tpu's own pieces: gaussian_blur_matmul, _resample_axis on rows
    then columns per round on the planar layout, blur, clip."""
    sigma, m, _ = jc.GLASS_SEV[severity - 1]
    y = ji.gaussian_blur_matmul(jnp.asarray(x), sigma).transpose(0, 3, 1, 2)
    for a, u in enumerate(us):
        y = cp._resample_axis(y, jnp.asarray(u)[:, None], m, axis=2 + a % 2)
    return jnp.clip(ji.gaussian_blur_matmul(y.transpose(0, 2, 3, 1), sigma), 0.0, 1.0)


@pytest.mark.parametrize("severity", SEVERITIES)
def test_glass_transform_equals_jax_composite(severity):
    x = _images(40 + severity)
    _, _, iters = tc.GLASS_SEV[severity - 1]
    rng = np.random.default_rng(500 + severity)
    us = [rng.random(SHAPE[:3], dtype=np.float32) for _ in range(2 * iters)]
    got = tc.glass_blur_with(_t(x), severity,
                             lambda y, m, it: tc.glass_resample_from_uniforms(y, [torch.from_numpy(u) for u in us], m))
    _close(got.numpy(), _np(_jax_glass(x, us, severity)), REASSOC_TOL)


@pytest.mark.parametrize("m,iters", [(1, 2), (2, 3), (4, 2)])
def test_glass_resample_equals_pallas_interpret(m, iters):
    """CPU interpret mode gives the Pallas kernel zero bits, so every
    uniform is 0.5 / 2**24 and every offset is -m: the port given those
    uniforms must select the same pixels."""
    x = _images(50 + m)
    us = [torch.full(SHAPE[:3], 0.5 / (1 << 24)) for _ in range(2 * iters)]
    got = tc.glass_resample_from_uniforms(_t(x), us, m)
    want = cp.glass_resample_pallas(jnp.int32(3), jnp.asarray(x), m, iters, interpret=True)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_glass_codes_are_uniform_over_offsets():
    """The port's own draws: codes from 2**16 Philox uniforms fall in each
    of the 2m+1 offsets with frequency 1/(2m+1) within 6 standard errors."""
    n = 1 << 16
    for m in (1, 2, 4):
        k = 2 * m + 1
        codes = tc.glass_codes(tc.uniform_field(77 + m, (n,), 3), m)
        counts = torch.bincount(codes.to(torch.int64), minlength=k).double()
        assert counts.numel() == k
        se = math.sqrt(n * (1 / k) * (1 - 1 / k))
        assert ((counts - n / k).abs() <= 6 * se).all(), counts


# ── K6: elastic ────────────────────────────────────────────────────────────

@pytest.mark.parametrize("severity", (1, 3, 5))
def test_elastic_warp_equals_oracle_and_pallas(severity):
    """Given fav_tpu's fields, the tent sum matches the oracle
    ``elastic_transform`` (its fields computed eagerly, as ``_elastic_fields``
    runs here) and ``elastic_transform_pallas`` in interpret mode (fields
    computed under its jit, reproduced by jitting ``_elastic_fields``)."""
    x = _images(60 + severity)
    key = jax.random.PRNGKey(700 + severity)
    xj = jnp.asarray(x)
    ys, xs = jc._elastic_fields(key, xj, severity)
    got = tc.elastic_from_fields(_t(x), _t(ys), _t(xs), severity)
    _close(got.numpy(), _np(jc.elastic_transform(key, xj, severity)), WARP_TOL)
    ys, xs = jax.jit(jc._elastic_fields, static_argnums=2)(key, xj, severity)
    got = tc.elastic_from_fields(_t(x), _t(ys), _t(xs), severity)
    _close(got.numpy(), _np(cp.elastic_transform_pallas(key, xj, severity, interpret=True)), WARP_TOL)


@pytest.mark.parametrize("severity", SEVERITIES)
def test_elastic_fields_from_uniforms_equal_fav_tpu(severity):
    x = jnp.zeros(SHAPE, jnp.float32)
    key = jax.random.PRNGKey(800 + severity)
    k1, k2 = jax.random.split(key)
    # jax.random.uniform(k, ..., -1, 1) is 2 u - 1 of the [0, 1) uniform of the same key
    uy = _t(jax.random.uniform(k1, (SHAPE[0], 32, 32, 1), jnp.float32))
    ux = _t(jax.random.uniform(k2, (SHAPE[0], 32, 32, 1), jnp.float32))
    ys, xs = tc.elastic_fields_from_uniforms(uy, ux, severity)
    want_ys, want_xs = jc._elastic_fields(key, x, severity)
    _close(ys.numpy(), _np(want_ys), REASSOC_TOL)
    _close(xs.numpy(), _np(want_xs), REASSOC_TOL)
    alpha = tc.ELASTIC_SEV[severity - 1][0]
    grid = torch.arange(32, dtype=torch.float32)
    assert ((ys - grid.view(1, 32, 1)).abs() <= alpha + 1e-5).all()
    assert ((xs - grid.view(1, 1, 32)).abs() <= alpha + 1e-5).all()


# ── marginal laws of the port's own draws ──────────────────────────────────

def test_motion_index_is_uniform_over_eight_angles():
    seeds = 4096
    u = torch.stack([tc.uniform_field(s, (1,), 0)[0] for s in range(seeds)])
    counts = torch.bincount(tc.motion_index(u), minlength=8).double()
    assert counts.numel() == 8
    se = math.sqrt(seeds * (1 / 8) * (7 / 8))
    assert ((counts - seeds / 8).abs() <= 6 * se).all(), counts
    assert tc.motion_index(torch.tensor([0.5 / (1 << 24), 0.125, 1.0])).tolist() == [0, 1, 7]


def test_snow_layer_draw_is_standard_normal():
    n = 1 << 16
    z = tc.box_muller(tc.uniform_field(9, (n,), 0), tc.uniform_field(9, (n,), 1)).double()
    assert abs(z.mean().item()) < 6 / math.sqrt(n)
    assert abs(z.var().item() - 1.0) < 6 * math.sqrt(2 / n)
    # the share within one standard deviation: Phi(1) - Phi(-1)
    p = math.erf(1 / math.sqrt(2))
    assert abs((z.abs() <= 1).double().mean().item() - p) < 6 * math.sqrt(p * (1 - p) / n)


# ── plain versions, wrappers and the router ────────────────────────────────

@pytest.mark.parametrize("name", ["motion_blur", "snow", "frost", "fog", "elastic_transform", "glass_blur"])
def test_plain_draw_families_take_their_documented_draws(name):
    """Each plain version is its transform fed the Philox draws the module
    docstring lists."""
    x = _t(_images(90))
    seed = 4242
    b = SHAPE[0]
    got = tc.corruption_fn(name)(seed, x, 3)
    if name == "motion_blur":
        want = tc.motion_from_index(x, tc.motion_index(tc.uniform_field(seed, (1,), 0)), 3)
    elif name == "snow":
        z = tc.box_muller(tc.uniform_field(seed, (b, 32, 32, 1), 0), tc.uniform_field(seed, (b, 32, 32, 1), 1))
        want = tc.snow_from_normal(x, z, 3)
    elif name in ("frost", "fog"):
        octaves = [tc.uniform_field(seed, s, o) for o, s in enumerate(tc.octave_shapes(b, 32, 32))]
        want = getattr(tc, f"{name}_from_octaves")(x, octaves, 3)
    elif name == "elastic_transform":
        ys, xs = tc.elastic_fields_from_uniforms(tc.uniform_field(seed, (b, 32, 32, 1), 0),
                                                 tc.uniform_field(seed, (b, 32, 32, 1), 1), 3)
        want = tc.elastic_from_fields(x, ys, xs, 3)
    else:
        us = [tc.uniform_field(seed, (b, 32, 32), p) for p in range(6)]
        want = tc.glass_blur_with(x, 3, lambda y, m, it: tc.glass_resample_from_uniforms(y, us, m))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert not torch.equal(got, tc.corruption_fn(name)(seed + 1, x, 3))


def test_cpu_uniform_is_uniform01():
    got = cuda_ops.uniform(5, (3, 7), 2, "cpu")
    np.testing.assert_array_equal(got.numpy(), tc.uniform_field(5, (3, 7), 2).numpy())
    assert cuda_ops.launch_counts()["philox_uniform"] == 0


def test_k5_and_k6_wrappers_take_the_plain_version_on_the_cpu():
    x = _t(_images(91))
    cuda_ops.reset_launch_counts()
    np.testing.assert_array_equal(cuda_ops.glass_resample(3, x, 2, 3).numpy(),
                                  tc.glass_resample_plain(3, x, 2, 3).numpy())
    ys, xs = tc.elastic_fields(4, x, 3)
    np.testing.assert_array_equal(cuda_ops.elastic_warp(x, ys, xs, 3).numpy(),
                                  tc.elastic_from_fields(x, ys, xs, 3).numpy())
    assert sum(cuda_ops.launch_counts().values()) == 0


def test_k5_and_k6_wrappers_check_their_input():
    x = _t(_images(92))
    ys, xs = tc.elastic_fields(4, x, 3)
    with pytest.raises(TypeError):
        cuda_ops.glass_resample(1, x.double(), 2, 3)
    with pytest.raises(ValueError):
        cuda_ops.glass_resample(1, x[0], 2, 3)  # not NHWC
    with pytest.raises(ValueError):
        cuda_ops.glass_resample(1, x.permute(0, 2, 1, 3), 2, 3)  # not contiguous
    with pytest.raises(TypeError):
        cuda_ops.elastic_warp(x.double(), ys, xs, 3)
    with pytest.raises(ValueError):
        cuda_ops.elastic_warp(x, ys[:, :16], xs, 3)  # field of another shape
    with pytest.raises(ValueError):
        cuda_ops.elastic_warp(x, ys.double(), xs, 3)
    with pytest.raises(ValueError):
        cuda_ops.elastic_warp(x, ys, xs.transpose(1, 2), 3)  # not contiguous
    with pytest.raises(ValueError):
        cuda_ops.elastic_warp(x, ys, xs, 6)  # severity out of range
