"""The fifteen corruption families as deterministic transforms of their
draws, and the plain PyTorch version of every family and kernel.

Images are float32 in [0, 1], batch first, NHWC at the public functions as
in ``fav_tpu/ops/corruptions.py``. Each randomized family is split into a
draw step (Philox uniforms keyed by an integer seed, ``ops/random.py``) and
a transform that is given the draws, so the CPU tests can feed a transform
the draws that ``fav_tpu`` itself made (``jax.random``).

Draw layout. Every family of a megastep cell takes the cell's seed; its
fields are Philox draws ``d = 0, 1, ...`` of that seed, each a flat tensor
in the element order written below (``ops/random.py``: element ``e`` of
draw ``d`` is word ``e % 4`` of ``philox((e // 4, d), seed)``):

* gaussian noise: draws 0 and 1, one per element of x (Box-Muller);
* shot and impulse noise: draw 0, one per element of x;
* glass blur: draw ``2 t + a`` for pass ``a`` (0 rows, 1 columns) of round
  ``t``, one per pixel ``(b, i, j)``, shared over channels;
* motion blur: element 0 of draw 0, the index of the streak angle;
* snow: draws 0 and 1, one per pixel, Box-Muller to the flake layer's normal;
* frost and fog: draw ``o`` for octave ``o`` of the turbulence, one per
  coarse pixel ``(b, i, j)`` of that octave;
* elastic transform: draw 0 for the row field and 1 for the column field,
  one per pixel;
* defocus and zoom blur, brightness, contrast, pixelate and JPEG draw nothing.

The plain versions here are what a CPU tensor runs; the CUDA kernels of
``ops/corruptions_cuda.py`` compute the same arithmetic in the same order,
so on the card each kernel is held to its plain version element by element.
The eight families without a TPU kernel (defocus, motion, zoom, snow,
frost, fog, pixelate, JPEG) are band-matrix products (``ops/image.py``),
the forms ``fast_corruption_fn`` routes them to on the TPU
(``corruptions_pallas.py:616-746``, pixelate and JPEG from
``corruptions.py:328-408``); they are the same code on both routes.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from fav_tpu_torch.ops import image
from fav_tpu_torch.ops.random import uniform01

__all__ = [
    "CORRUPTION_NAMES",
    "GAUSSIAN_SIGMA",
    "SHOT_C",
    "IMPULSE_AMOUNT",
    "DEFOCUS_SEV",
    "GLASS_SEV",
    "MOTION_SEV",
    "ZOOM_ZMAX",
    "FOG_SEV",
    "FROST_SEV",
    "SNOW_SEV",
    "BRIGHTNESS_C",
    "CONTRAST_C",
    "ELASTIC_SEV",
    "PIXELATE_FRAC",
    "JPEG_QUALITY",
    "JPEG_Q_LUMA",
    "JPEG_Q_CHROMA",
    "MOTION_ANGLES",
    "sev_param",
    "uniform_field",
    "box_muller",
    "gaussian_from_normal",
    "impulse_thresholds",
    "impulse_from_uniform",
    "shot_k_max",
    "shot_log_k",
    "poisson_inverse_cdf",
    "shot_from_uniform",
    "photometric",
    "brightness",
    "contrast",
    "defocus_blur",
    "motion_index",
    "motion_from_index",
    "zoom_blur",
    "snow_from_normal",
    "octave_shapes",
    "turbulence_from_octaves",
    "fog_from_octaves",
    "frost_from_octaves",
    "pixelate",
    "quality_scale",
    "jpeg_compression",
    "glass_codes",
    "glass_resample_from_uniforms",
    "glass_blur_with",
    "elastic_margin",
    "elastic_fields_from_uniforms",
    "elastic_from_fields",
    "gaussian_noise_plain",
    "shot_noise_plain",
    "impulse_noise_plain",
    "brightness_plain",
    "contrast_plain",
    "glass_resample_plain",
    "glass_blur_plain",
    "motion_blur_plain",
    "snow_plain",
    "frost_plain",
    "fog_plain",
    "elastic_fields",
    "elastic_transform_plain",
    "corruption_fn",
]

# Severity tables, copied from fav_tpu/ops/corruptions.py:66-83, :255, :329,
# :337-365 and :374 (pinned equal by tests/test_torch_families.py).
GAUSSIAN_SIGMA = (0.08, 0.12, 0.18, 0.26, 0.38)
SHOT_C = (60.0, 25.0, 12.0, 5.0, 3.0)
IMPULSE_AMOUNT = (0.03, 0.06, 0.09, 0.17, 0.27)
DEFOCUS_SEV = ((3, 0.1), (4, 0.5), (6, 0.5), (8, 0.5), (10, 0.5))
GLASS_SEV = ((0.7, 1, 2), (0.9, 2, 1), (1.0, 2, 3), (1.1, 3, 2), (1.5, 4, 2))
MOTION_SEV = ((7, 3.0), (9, 5.0), (11, 7.0), (13, 9.0), (15, 12.0))
ZOOM_ZMAX = (1.11, 1.16, 1.21, 1.26, 1.31)
FOG_SEV = ((1.5, 2.0), (2.0, 2.0), (2.5, 1.7), (2.5, 1.5), (3.0, 1.4))
FROST_SEV = ((1.0, 0.4), (0.8, 0.6), (0.7, 0.7), (0.65, 0.7), (0.6, 0.75))
SNOW_SEV = (
    (0.1, 0.3, 1.6, 0.55, 2.0, 0.8),
    (0.2, 0.3, 1.8, 0.55, 2.0, 0.7),
    (0.55, 0.3, 2.0, 0.55, 2.5, 0.65),
    (0.55, 0.3, 2.0, 0.50, 3.0, 0.6),
    (0.55, 0.3, 2.2, 0.50, 3.5, 0.55),
)
BRIGHTNESS_C = (0.1, 0.2, 0.3, 0.4, 0.5)
CONTRAST_C = (0.4, 0.3, 0.2, 0.1, 0.05)
ELASTIC_SEV = ((1.5, 6.0), (2.5, 5.0), (3.5, 4.5), (4.5, 4.0), (6.0, 3.5))
PIXELATE_FRAC = (0.6, 0.5, 0.4, 0.3, 0.25)
JPEG_QUALITY = (25, 18, 15, 10, 7)
# JPEG quantization tables (Annex K), scaled by quality_scale.
JPEG_Q_LUMA = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    np.float32,
)
JPEG_Q_CHROMA = np.array(
    [
        [17, 18, 24, 47, 99, 99, 99, 99],
        [18, 21, 26, 66, 99, 99, 99, 99],
        [24, 26, 56, 99, 99, 99, 99, 99],
        [47, 66, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
    ],
    np.float32,
)
MOTION_ANGLES = tuple(float(a) for a in np.linspace(-45.0, 45.0, 8))  # corruptions.py:171

CORRUPTION_NAMES = (
    "gaussian_noise",
    "shot_noise",
    "impulse_noise",
    "defocus_blur",
    "glass_blur",
    "motion_blur",
    "zoom_blur",
    "snow",
    "frost",
    "fog",
    "brightness",
    "contrast",
    "elastic_transform",
    "pixelate",
    "jpeg_compression",
)


def sev_param(table, severity: int):
    """The entry of a severity table for severity 1..5."""
    if not 1 <= int(severity) <= len(table):
        raise ValueError(f"severity must be in 1..{len(table)}, got {severity}")
    return table[int(severity) - 1]


def uniform_field(seed: int, shape, draw: int, device=None) -> torch.Tensor:
    """Draw ``draw`` of ``seed`` as float32 uniforms in (0, 1] of ``shape``,
    element order row-major (the plain draw step; the card's launcher in
    ``ops/corruptions_cuda.py`` writes the same words)."""
    return uniform01(seed, math.prod(shape), draw, device=device).reshape(tuple(shape))


# ── transforms of given draws ─────────────────────────────────────────────

def box_muller(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Standard normal from two uniforms in (0, 1], as
    ``corruptions_pallas.py:85-90``."""
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos((2.0 * math.pi) * u2)


def gaussian_from_normal(x: torch.Tensor, z: torch.Tensor, severity: int) -> torch.Tensor:
    """``clip(x + sigma * z)``: ``corruptions.gaussian_noise`` given its normal draws."""
    sigma = sev_param(GAUSSIAN_SIGMA, severity)
    return torch.clamp(x + sigma * z, 0.0, 1.0)


def impulse_thresholds(severity: int) -> tuple[float, float]:
    """(salt below, pepper above) as the float32 values the comparisons use."""
    amount = sev_param(IMPULSE_AMOUNT, severity)
    return float(np.float32(amount / 2)), float(np.float32(1.0 - amount / 2))


def impulse_from_uniform(x: torch.Tensor, u: torch.Tensor, severity: int) -> torch.Tensor:
    """Salt where ``u < a/2``, pepper where ``u > 1 - a/2``, else ``x``:
    ``corruptions.impulse_noise`` given its uniform draws."""
    salt, pepper = impulse_thresholds(severity)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(u < salt, one, torch.where(u > pepper, zero, x))


def shot_k_max(severity: int) -> int:
    """Terms of the inverse CDF: ``int(c + 10 sqrt(c)) + 8`` (54 at severity 3)."""
    c = sev_param(SHOT_C, severity)
    return int(c + 10.0 * math.sqrt(c)) + 8


def shot_log_k(k_max: int) -> list[float]:
    """``float32(log k)`` for k = 0..k_max-1 (entry 0 unused): the constants
    the recurrence subtracts, shared with the kernel so both round alike."""
    return [0.0] + [float(np.float32(np.log(k))) for k in range(1, k_max)]


def poisson_inverse_cdf(lam: torch.Tensor, u: torch.Tensor, k_max: int) -> torch.Tensor:
    """Poisson counts by inverse CDF in log space (``corruptions_pallas.py:107-126``):
    the number of partial sums ``cdf_k``, k < k_max, that ``u`` exceeds. The
    log-pmf recurrence ``log p_k = log p_{k-1} + log lam - log k`` stays
    finite where the plain pmf product underflows near lam = 60. Returns
    float32 counts in 0..k_max."""
    log_lam = torch.log(torch.clamp(lam, min=1e-30))
    log_term = -lam
    cdf = torch.exp(log_term)
    count = torch.zeros_like(lam)
    log_k = shot_log_k(k_max)
    for k in range(1, k_max):
        count = count + (u > cdf).to(lam.dtype)
        log_term = log_term + log_lam - log_k[k]
        cdf = cdf + torch.exp(log_term)
    return count + (u > cdf).to(lam.dtype)


def shot_from_uniform(x: torch.Tensor, u: torch.Tensor, severity: int) -> torch.Tensor:
    """``clip(Poisson(x c) / c)`` given one uniform per element."""
    c = sev_param(SHOT_C, severity)
    count = poisson_inverse_cdf(x * c, u, shot_k_max(severity))
    # divide by a tensor, not a Python float: on CUDA PyTorch turns division
    # by a host scalar into a product with its rounded reciprocal, one ulp
    # off the true quotient for some counts
    return torch.clamp(count / count.new_full((), c), 0.0, 1.0)


def photometric(x: torch.Tensor, bright: float, contrast_c: float) -> torch.Tensor:
    """``clip((x - mu) c + mu + b)``, mu the per-image mean over all but the
    batch axis; with c = 1 the mean is skipped so brightness stays exactly
    ``clip(x + b)`` (``corruptions_pallas.py:143-154``)."""
    if contrast_c != 1.0:
        mu = x.mean(dim=tuple(range(1, x.ndim)), keepdim=True)
        x = (x - mu) * contrast_c + mu
    return torch.clamp(x + bright, 0.0, 1.0)


def brightness(x: torch.Tensor, severity: int) -> torch.Tensor:
    return photometric(x, sev_param(BRIGHTNESS_C, severity), 1.0)


def contrast(x: torch.Tensor, severity: int) -> torch.Tensor:
    return photometric(x, 0.0, sev_param(CONTRAST_C, severity))


# ── the band-matrix families: the XLA matmul forms of corruptions_pallas ──

def _clip(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)


@functools.lru_cache(maxsize=None)
def _disk(radius: int, alias: float) -> np.ndarray:
    return image.disk_kernel(radius, alias)


@functools.lru_cache(maxsize=None)
def _motion(length: int, sigma: float, angle: float) -> np.ndarray:
    return image.motion_kernel(length, angle, sigma)


def defocus_blur(x: torch.Tensor, severity: int) -> torch.Tensor:
    """``clip(x * disk PSF)``: ``defocus_blur_matmul`` (``corruptions_pallas.py:616``)."""
    radius, alias = sev_param(DEFOCUS_SEV, severity)
    return _clip(image.depthwise_conv2d_matmul(x, _disk(radius, alias)))


def _motion_stacks(severity: int, h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Band factors of the 8 streak PSFs, zero-padded to a common rank:
    ``([8, r, h, h], [8, r, w, w])`` on ``device``."""
    length, sigma = sev_param(MOTION_SEV, severity)

    def build(axis: int) -> np.ndarray:
        factors = [image.svd_band_factors(_motion(length, sigma, a), h, w) for a in MOTION_ANGLES]
        rmax = max(f[0].shape[0] for f in factors)
        return np.stack([np.pad(f[axis], ((0, rmax - f[axis].shape[0]), (0, 0), (0, 0))) for f in factors])

    return (image.device_matrix(("motion", severity, h, w, 0), lambda: build(0), device),
            image.device_matrix(("motion", severity, h, w, 1), lambda: build(1), device))


def motion_index(u: torch.Tensor) -> torch.Tensor:
    """The streak angle's index ``min(floor(8 u), 7)`` of a uniform in (0, 1]."""
    n = len(MOTION_ANGLES)
    return torch.clamp(torch.floor(u * n), max=n - 1).to(torch.int64)


def motion_from_index(x: torch.Tensor, idx, severity: int) -> torch.Tensor:
    """``clip(x * streak PSF)`` at the angle of index ``idx`` (an int, or an
    int64 tensor of one element on ``x``'s device, selected there without a
    round trip to the host): ``motion_blur_matmul`` (``corruptions_pallas.py:625``)."""
    _, h, w, _ = x.shape
    mys, mxs = _motion_stacks(severity, h, w, x.device)
    idx = torch.as_tensor(idx, dtype=torch.int64, device=x.device).reshape(1)
    return _clip(image.band_matmul(x, torch.index_select(mys, 0, idx)[0], torch.index_select(mxs, 0, idx)[0]))


def zoom_blur(x: torch.Tensor, severity: int) -> torch.Tensor:
    """Mean of the image and 8 centre crops of it zoomed up to ``zmax``,
    the 8 resize-and-crop steps as one rank-stacked product:
    ``zoom_blur_matmul`` (``corruptions_pallas.py:650``)."""
    zmax = sev_param(ZOOM_ZMAX, severity)
    _, h, w, _ = x.shape
    steps = 8

    def build(size: int) -> np.ndarray:
        mats = []
        for i in range(1, steps + 1):
            zoomed = int(round(size * (1.0 + (zmax - 1.0) * i / steps)))
            mats.append(image.resize_crop_band(size, zoomed, (zoomed - size) // 2))
        return np.stack(mats)

    ry = image.device_matrix(("zoom", severity, h), lambda: build(h), x.device)
    rx = image.device_matrix(("zoom", severity, w), lambda: build(w), x.device)
    acc = x + image.band_matmul(x, ry, rx)
    return _clip(acc / (steps + 1))


def snow_from_normal(x: torch.Tensor, z: torch.Tensor, severity: int) -> torch.Tensor:
    """Snow given the flake layer's standard normal ``z`` (B, H, W, 1):
    ``snow_matmul`` (``corruptions_pallas.py:673``)."""
    loc, scale, zoom, thresh, blur_sigma, blend = sev_param(SNOW_SEV, severity)
    _, h, w, _ = x.shape
    layer = loc + scale * z
    zh, zw = int(h * zoom), int(w * zoom)
    ry = image.device_matrix(("crop", h, zh, 0), lambda: image.resize_crop_band(h, zh, 0), x.device)
    rx = image.device_matrix(("crop", w, zw, 0), lambda: image.resize_crop_band(w, zw, 0), x.device)
    layer = image.band_matmul(layer, ry, rx)
    layer = torch.where(layer < thresh, 0.0, layer)
    layer = _clip(image.depthwise_conv2d_matmul(layer, _motion(9, blur_sigma, -60.0)))
    gray = image.rgb_to_gray(x)
    darkened = torch.maximum(x, gray * 1.5 + 0.5)
    base = blend * x + (1.0 - blend) * darkened
    return _clip(base + layer + torch.flip(layer, dims=(1, 2)) * 0.5)


def octave_shapes(batch: int, h: int, w: int, octaves: int = 5) -> list[tuple[int, int, int, int]]:
    """Shapes of the coarse uniform grids of the turbulence octaves
    (``corruptions.py:_turbulence``): 2, 4, 8, ... pixels a side, at most H x W."""
    out = []
    for o in range(octaves):
        res = max(2, 2 ** (o + 1))
        out.append((batch, min(res, h), min(res, w), 1))
    return out


def turbulence_from_octaves(octaves, h: int, w: int, persistence: float) -> torch.Tensor:
    """Multi-octave value noise (B, H, W, 1) from the coarse uniform grids:
    each bilinearly upsampled by band products, weighted by ``persistence**o``
    and normalised (``_turbulence_matmul``, ``corruptions_pallas.py:698``)."""
    total = None
    amp, norm = 1.0, 0.0
    for coarse in octaves:
        _, ch, cw, _ = coarse.shape
        ry = image.device_matrix(("resize", h, ch), lambda: image.resize_band(h, ch), coarse.device)
        rx = image.device_matrix(("resize", w, cw), lambda: image.resize_band(w, cw), coarse.device)
        term = amp * image.band_matmul(coarse, ry, rx)
        total = term if total is None else total + term
        norm += amp
        amp *= persistence
    return total / norm


def fog_from_octaves(x: torch.Tensor, octaves, severity: int) -> torch.Tensor:
    """Fog given its five octave grids: ``fog_matmul`` (``corruptions_pallas.py:722``)."""
    strength, decay = sev_param(FOG_SEV, severity)
    _, h, w, _ = x.shape
    plasma = turbulence_from_octaves(octaves, h, w, 1.0 / decay)
    plasma = plasma - torch.amin(plasma, dim=(1, 2, 3), keepdim=True)
    plasma = plasma / (torch.amax(plasma, dim=(1, 2, 3), keepdim=True) + 1e-6)
    maxval = torch.amax(x, dim=(1, 2, 3), keepdim=True)
    out = x + strength * plasma
    return _clip(out * maxval / (maxval + strength))


def frost_from_octaves(x: torch.Tensor, octaves, severity: int) -> torch.Tensor:
    """Frost given its five octave grids: ``frost_matmul`` (``corruptions_pallas.py:737``)."""
    img_w, frost_w = sev_param(FROST_SEV, severity)
    _, h, w, _ = x.shape
    tex = turbulence_from_octaves(octaves, h, w, 0.7)
    tex = torch.abs(torch.sin(tex * 9.0)) ** 2
    return _clip(img_w * x + frost_w * tex)


def pixelate(x: torch.Tensor, severity: int) -> torch.Tensor:
    """Antialiased bilinear downsample to ``frac`` of the size, then the
    half-pixel-centre nearest upsample back (``corruptions.py:328``). The
    upsample only copies rows of the downsample matrix, so each axis is one
    band matrix: the rows of the downsample that the upsample picks."""
    frac = sev_param(PIXELATE_FRAC, severity)
    _, h, w, _ = x.shape
    lh, lw = max(1, int(h * frac)), max(1, int(w * frac))
    py = image.device_matrix(("pixelate", h, lh), lambda: image.nearest_band(h, lh) @ image.resize_band(lh, h),
                             x.device)
    px = image.device_matrix(("pixelate", w, lw), lambda: image.nearest_band(w, lw) @ image.resize_band(lw, w),
                             x.device)
    return image.band_matmul(x, py, px)


def quality_scale(q: int) -> float:
    """The Annex K scale of a JPEG quality factor (``corruptions.py:365``)."""
    return (5000.0 / q if q < 50 else 200.0 - 2.0 * q) / 100.0


def _quant_tile(table: np.ndarray, quality: int, h: int, w: int) -> np.ndarray:
    q = np.clip(np.floor(table * quality_scale(quality) + 0.5), 1, 255)
    return np.tile(q, (h // 8, w // 8))


def jpeg_compression(x: torch.Tensor, severity: int) -> torch.Tensor:
    """JPEG round trip without entropy coding: RGB to YCbCr, 8x8 DCT,
    ``round(coef / q) q`` at the severity's quality, the inverse
    (``corruptions.py:369``). Each 8x8 blockwise DCT is a product with a
    block-diagonal matrix on each side."""
    quality = sev_param(JPEG_QUALITY, severity)
    b, h, w, _ = x.shape
    hp, wp = h + (-h) % 8, w + (-w) % 8
    if (hp, wp) != (h, w):  # edge padding to whole blocks
        rows = torch.clamp(torch.arange(hp, device=x.device), max=h - 1)
        cols = torch.clamp(torch.arange(wp, device=x.device), max=w - 1)
        x = x[:, rows][:, :, cols]
    xp = x * 255.0
    r, g, bch = xp[..., 0], xp[..., 1], xp[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * bch - 128.0
    cb = -0.168736 * r - 0.331264 * g + 0.5 * bch
    cr = 0.5 * r - 0.418688 * g - 0.081312 * bch

    dh = image.device_matrix(("dct", hp), lambda: image.block_dct_matrix(hp), x.device)
    dw = image.device_matrix(("dct", wp), lambda: image.block_dct_matrix(wp), x.device)
    qy = image.device_matrix(("jpeg_q", "luma", quality, hp, wp),
                             lambda: _quant_tile(JPEG_Q_LUMA, quality, hp, wp), x.device)
    qc = image.device_matrix(("jpeg_q", "chroma", quality, hp, wp),
                             lambda: _quant_tile(JPEG_Q_CHROMA, quality, hp, wp), x.device)

    def codec(chan: torch.Tensor, qt: torch.Tensor) -> torch.Tensor:
        coef = image.band_matmul(chan[..., None], dh, dw)[..., 0]
        return image.band_matmul((torch.round(coef / qt) * qt)[..., None], dh.T, dw.T)[..., 0]

    y = codec(y, qy) + 128.0
    cb = codec(cb, qc)
    cr = codec(cr, qc)
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    bch = y + 1.772 * cb
    out = torch.stack([r, g, bch], dim=-1)[:, :h, :w, :] / 255.0
    return _clip(out)


# ── glass blur: blur, K5's resample cascade, blur ─────────────────────────

def glass_codes(u: torch.Tensor, m: int) -> torch.Tensor:
    """``min(floor(u k), k - 1)`` with k = 2m + 1, as float32: the code whose
    offset is ``code - m`` (``_resample_axis``, ``corruptions_pallas.py:282``)."""
    k = 2 * m + 1
    return torch.clamp(torch.floor(u * k), max=k - 1)


def glass_resample_from_uniforms(x: torch.Tensor, us, m: int) -> torch.Tensor:
    """The resample cascade given its uniforms: ``us[2t]`` (B, H, W) moves
    each pixel to row ``clamp(i + d)`` and then ``us[2t + 1]`` to column
    ``clamp(j + d)``, ``d = code - m``, channels together. Pure selection:
    ``_resample_axis`` on rows then columns, ``iters = len(us) / 2`` times."""
    b, h, w, c = x.shape
    rows = torch.arange(h, device=x.device).view(1, h, 1)
    cols = torch.arange(w, device=x.device).view(1, 1, w)
    for a, u in enumerate(us):
        d = glass_codes(u, m).to(torch.int64) - m
        if a % 2 == 0:
            src = torch.clamp(rows + d, 0, h - 1)
            x = torch.gather(x, 1, src[..., None].expand(b, h, w, c))
        else:
            src = torch.clamp(cols + d, 0, w - 1)
            x = torch.gather(x, 2, src[..., None].expand(b, h, w, c))
    return x


def glass_blur_with(x: torch.Tensor, severity: int, resample) -> torch.Tensor:
    """``clip(blur(resample(blur(x), m, iters)))`` (``glass_blur_pallas``,
    ``corruptions_pallas.py:421-435``), the blurs as band products."""
    sigma, m, iters = sev_param(GLASS_SEV, severity)
    y = image.gaussian_blur_matmul(x, sigma)
    y = resample(y, m, iters)
    return _clip(image.gaussian_blur_matmul(y, sigma))


# ── elastic transform: smooth random fields, K6's tent-sum warp ───────────

def elastic_margin(severity: int) -> int:
    """m = ceil(alpha): the displacement bound; the warp sums offsets in [-m, m + 1]."""
    return int(math.ceil(sev_param(ELASTIC_SEV, severity)[0]))


def elastic_fields_from_uniforms(uy: torch.Tensor, ux: torch.Tensor, severity: int):
    """Clamped sample coordinates ``(ys, xs)``, each (B, H, W), from two
    uniform fields (B, H, W, 1) in [0, 1]: mapped to [-1, 1], blurred by
    band products, scaled by alpha and added to the pixel grid
    (``corruptions._elastic_fields``, ``corruptions.py:258-270``)."""
    alpha, sigma = sev_param(ELASTIC_SEV, severity)
    _, h, w, _ = uy.shape
    dy = image.gaussian_blur_matmul(uy * 2.0 - 1.0, sigma) * alpha
    dx = image.gaussian_blur_matmul(ux * 2.0 - 1.0, sigma) * alpha
    yy = torch.arange(h, dtype=torch.float32, device=uy.device).view(1, h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=uy.device).view(1, 1, w)
    ys = torch.clamp(yy + dy[..., 0], 0.0, h - 1.0)
    xs = torch.clamp(xx + dx[..., 0], 0.0, w - 1.0)
    return ys, xs


def elastic_from_fields(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, severity: int = 3) -> torch.Tensor:
    """Plain K6: the bilinear warp of NHWC ``x`` to ``(ys, xs)`` as the
    tent-weighted sum over offsets (oy, ox) in [-m, m + 1]^2 of the
    edge-clamped image, in the oracle's order: for each oy, the inner sum
    over ox of ``tent(dx - ox) x``, then ``acc += tent(dy - oy) inner``
    (``corruptions.py:311-321``, ``corruptions_pallas.py:467-475``)."""
    m = elastic_margin(severity)
    _, h, w, _ = x.shape
    dy = ys - torch.arange(h, dtype=torch.float32, device=x.device).view(1, h, 1)
    dx = xs - torch.arange(w, dtype=torch.float32, device=x.device).view(1, 1, w)
    offsets = range(-m, m + 2)
    ar_h = torch.arange(h, device=x.device)
    ar_w = torch.arange(w, device=x.device)
    wxs = [torch.clamp_min(1.0 - torch.abs(dx - float(ox)), 0.0)[..., None] for ox in offsets]
    acc = None
    for oy in offsets:
        band = torch.index_select(x, 1, torch.clamp(ar_h + oy, 0, h - 1))
        wy = torch.clamp_min(1.0 - torch.abs(dy - float(oy)), 0.0)[..., None]
        inner = None
        for wx, ox in zip(wxs, offsets):
            term = wx * torch.index_select(band, 2, torch.clamp(ar_w + ox, 0, w - 1))
            inner = term if inner is None else inner + term
        term = wy * inner
        acc = term if acc is None else acc + term
    return acc


# ── plain versions: Philox draws, then the transform ──────────────────────

def gaussian_noise_plain(seed: int, x: torch.Tensor, severity: int = 3) -> torch.Tensor:
    """Plain K1: Box-Muller on draws 0 and 1, then ``gaussian_from_normal``."""
    z = box_muller(uniform_field(seed, x.shape, 0, x.device), uniform_field(seed, x.shape, 1, x.device))
    return gaussian_from_normal(x, z, severity)


def shot_noise_plain(seed: int, x: torch.Tensor, severity: int = 3) -> torch.Tensor:
    """Plain K2: draw 0, then ``shot_from_uniform``."""
    return shot_from_uniform(x, uniform_field(seed, x.shape, 0, x.device), severity)


def impulse_noise_plain(seed: int, x: torch.Tensor, severity: int = 3) -> torch.Tensor:
    """Plain K3: draw 0, then ``impulse_from_uniform``."""
    return impulse_from_uniform(x, uniform_field(seed, x.shape, 0, x.device), severity)


def brightness_plain(seed: int, x: torch.Tensor, severity: int = 3) -> torch.Tensor:
    """Plain K4 as brightness (the seed is unused, as in the TPU kernel)."""
    return brightness(x, severity)


def contrast_plain(seed: int, x: torch.Tensor, severity: int = 3) -> torch.Tensor:
    """Plain K4 as contrast (the seed is unused)."""
    return contrast(x, severity)


def glass_resample_plain(seed: int, x: torch.Tensor, m: int, iters: int) -> torch.Tensor:
    """Plain K5: draws 0 .. 2 iters - 1, one uniform per pixel each, then
    ``glass_resample_from_uniforms``."""
    b, h, w, _ = x.shape
    us = [uniform_field(seed, (b, h, w), p, x.device) for p in range(2 * iters)]
    return glass_resample_from_uniforms(x, us, m)


def glass_blur_plain(seed: int, x: torch.Tensor, severity: int = 3) -> torch.Tensor:
    return glass_blur_with(x, severity, lambda y, m, iters: glass_resample_plain(seed, y, m, iters))


def motion_blur_plain(seed: int, x: torch.Tensor, severity: int = 3, uniform=uniform_field) -> torch.Tensor:
    """Draw 0, element 0 -> the angle index, then ``motion_from_index``."""
    return motion_from_index(x, motion_index(uniform(seed, (1,), 0, x.device)), severity)


def snow_plain(seed: int, x: torch.Tensor, severity: int = 3, uniform=uniform_field) -> torch.Tensor:
    """Draws 0 and 1 -> Box-Muller normal per pixel, then ``snow_from_normal``."""
    b, h, w, _ = x.shape
    z = box_muller(uniform(seed, (b, h, w, 1), 0, x.device), uniform(seed, (b, h, w, 1), 1, x.device))
    return snow_from_normal(x, z, severity)


def _octaves(seed: int, x: torch.Tensor, uniform) -> list[torch.Tensor]:
    b, h, w, _ = x.shape
    return [uniform(seed, shape, o, x.device) for o, shape in enumerate(octave_shapes(b, h, w))]


def frost_plain(seed: int, x: torch.Tensor, severity: int = 3, uniform=uniform_field) -> torch.Tensor:
    """Draw o -> octave o's grid, then ``frost_from_octaves``."""
    return frost_from_octaves(x, _octaves(seed, x, uniform), severity)


def fog_plain(seed: int, x: torch.Tensor, severity: int = 3, uniform=uniform_field) -> torch.Tensor:
    """Draw o -> octave o's grid, then ``fog_from_octaves``."""
    return fog_from_octaves(x, _octaves(seed, x, uniform), severity)


def elastic_fields(seed: int, x: torch.Tensor, severity: int = 3, uniform=uniform_field):
    """Draws 0 (rows) and 1 (columns), one per pixel, then
    ``elastic_fields_from_uniforms``."""
    b, h, w, _ = x.shape
    return elastic_fields_from_uniforms(uniform(seed, (b, h, w, 1), 0, x.device),
                                        uniform(seed, (b, h, w, 1), 1, x.device), severity)


def elastic_transform_plain(seed: int, x: torch.Tensor, severity: int = 3) -> torch.Tensor:
    ys, xs = elastic_fields(seed, x, severity)
    return elastic_from_fields(x, ys, xs, severity)


def _seedless(transform):
    """``fn(seed, x, severity)`` of a family that draws nothing."""
    def fn(seed: int, x: torch.Tensor, severity: int = 3) -> torch.Tensor:
        return transform(x, severity)

    fn.__name__ = f"{transform.__name__}_plain"
    return fn


_PLAIN = {
    "gaussian_noise": gaussian_noise_plain,
    "shot_noise": shot_noise_plain,
    "impulse_noise": impulse_noise_plain,
    "defocus_blur": _seedless(defocus_blur),
    "glass_blur": glass_blur_plain,
    "motion_blur": motion_blur_plain,
    "zoom_blur": _seedless(zoom_blur),
    "snow": snow_plain,
    "frost": frost_plain,
    "fog": fog_plain,
    "brightness": brightness_plain,
    "contrast": contrast_plain,
    "elastic_transform": elastic_transform_plain,
    "pixelate": _seedless(pixelate),
    "jpeg_compression": _seedless(jpeg_compression),
}


def corruption_fn(name: str):
    """The plain version of a family, ``fn(seed, x, severity)``."""
    if name not in _PLAIN:
        raise NotImplementedError(f"unknown corruption {name!r}")
    return _PLAIN[name]
