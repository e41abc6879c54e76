"""Corruption families of the slice as deterministic transforms of their draws,
and the plain PyTorch versions of kernels K1-K4 built from them.

Images are float32 in [0, 1], batch first, NHWC at the public functions as
in ``fav_tpu/ops/corruptions.py``. Each randomized family is split into a
draw step (``ops/random.py``: Philox uniforms keyed by an integer seed) and
a transform that is given the draws, so the CPU tests can feed a transform
the draws that ``fav_tpu``'s own oracle made.

The plain versions here are what a CPU tensor runs; the CUDA kernels of
``ops/corruptions_cuda.py`` compute the same arithmetic in the same order,
so on the card each kernel is held to its plain version element by element.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fav_tpu_torch.ops.random import uniform01

__all__ = [
    "CORRUPTION_NAMES",
    "SLICE_FAMILIES",
    "GAUSSIAN_SIGMA",
    "SHOT_C",
    "IMPULSE_AMOUNT",
    "BRIGHTNESS_C",
    "CONTRAST_C",
    "sev_param",
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
    "gaussian_noise_plain",
    "shot_noise_plain",
    "impulse_noise_plain",
    "brightness_plain",
    "contrast_plain",
    "corruption_fn",
    "not_ported",
]

# Severity tables, copied from fav_tpu/ops/corruptions.py:66-83 (pinned equal
# by tests/test_torch_corruptions.py).
GAUSSIAN_SIGMA = (0.08, 0.12, 0.18, 0.26, 0.38)
SHOT_C = (60.0, 25.0, 12.0, 5.0, 3.0)
IMPULSE_AMOUNT = (0.03, 0.06, 0.09, 0.17, 0.27)
BRIGHTNESS_C = (0.1, 0.2, 0.3, 0.4, 0.5)
CONTRAST_C = (0.4, 0.3, 0.2, 0.1, 0.05)

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
SLICE_FAMILIES = ("gaussian_noise", "shot_noise", "impulse_noise", "brightness", "contrast")

# Where each family not in this slice stands in ROADMAP.md.
_NOT_PORTED = {
    "glass_blur": "Queue 2 K5 with gaussian_blur_matmul (the next slice)",
    "elastic_transform": "Queue 2 K6 with _elastic_fields (the next slice)",
    "defocus_blur": "Queue 1 item 4, the XLA-form families",
    "motion_blur": "Queue 1 item 4, the XLA-form families",
    "zoom_blur": "Queue 1 item 4, the XLA-form families",
    "snow": "Queue 1 item 4, the XLA-form families",
    "frost": "Queue 1 item 4, the XLA-form families",
    "fog": "Queue 1 item 4, the XLA-form families",
    "pixelate": "Queue 1 item 4, the XLA-form families",
    "jpeg_compression": "Queue 1 item 4, the XLA-form families",
}


def sev_param(table, severity: int):
    """The entry of a severity table for severity 1..5."""
    if not 1 <= int(severity) <= len(table):
        raise ValueError(f"severity must be in 1..{len(table)}, got {severity}")
    return table[int(severity) - 1]


def not_ported(name: str) -> NotImplementedError:
    """The error a router raises for a family outside this slice."""
    if name not in CORRUPTION_NAMES:
        return NotImplementedError(f"unknown corruption {name!r}")
    return NotImplementedError(f"{name} is not ported yet: ROADMAP.md {_NOT_PORTED[name]}")


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


# ── plain versions of K1-K4: Philox draws, then the transform ─────────────

def _flat_uniform(seed: int, x: torch.Tensor, draw: int) -> torch.Tensor:
    return uniform01(seed, x.numel(), draw, device=x.device).reshape(x.shape)


def gaussian_noise_plain(seed: int, x: torch.Tensor, severity: int = 3) -> torch.Tensor:
    """Plain K1: Box-Muller on draws 0 and 1, then ``gaussian_from_normal``."""
    z = box_muller(_flat_uniform(seed, x, 0), _flat_uniform(seed, x, 1))
    return gaussian_from_normal(x, z, severity)


def shot_noise_plain(seed: int, x: torch.Tensor, severity: int = 3) -> torch.Tensor:
    """Plain K2: draw 0, then ``shot_from_uniform``."""
    return shot_from_uniform(x, _flat_uniform(seed, x, 0), severity)


def impulse_noise_plain(seed: int, x: torch.Tensor, severity: int = 3) -> torch.Tensor:
    """Plain K3: draw 0, then ``impulse_from_uniform``."""
    return impulse_from_uniform(x, _flat_uniform(seed, x, 0), severity)


def brightness_plain(seed: int, x: torch.Tensor, severity: int = 3) -> torch.Tensor:
    """Plain K4 as brightness (the seed is unused, as in the TPU kernel)."""
    return brightness(x, severity)


def contrast_plain(seed: int, x: torch.Tensor, severity: int = 3) -> torch.Tensor:
    """Plain K4 as contrast (the seed is unused)."""
    return contrast(x, severity)


_PLAIN = {
    "gaussian_noise": gaussian_noise_plain,
    "shot_noise": shot_noise_plain,
    "impulse_noise": impulse_noise_plain,
    "brightness": brightness_plain,
    "contrast": contrast_plain,
}


def corruption_fn(name: str):
    """The plain version of a family, ``fn(seed, x, severity)``; families
    outside the slice raise ``NotImplementedError`` naming their ROADMAP item."""
    if name in _PLAIN:
        return _PLAIN[name]
    raise not_ported(name)
