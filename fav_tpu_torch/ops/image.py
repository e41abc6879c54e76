"""Band matrices for the spatial filters of the corruption families, and the
matrix products that apply them to NHWC batches.

The port's copy of what the corruption families need from
``fav_tpu/ops/image.py``. Every filter there is linear along each spatial
axis, so it is a matrix: a Gaussian blur, a point-spread function split by
its SVD into rank-one pairs of 1-D filters, a bilinear resize and crop, a
nearest upsample, the 8x8 DCT. The matrices are built once in numpy
(float64, cast to float32) and cached; the products run as ``torch.matmul``
on whatever device the images lie on (cuBLAS on the card, in full float32
when ``torch.backends.cuda.matmul.allow_tf32`` is False, the counterpart of
``Precision.HIGHEST`` at ``fav_tpu/ops/image.py:190-194``).

``fav_tpu`` builds the resize matrices by calling ``jax.image.resize`` on an
identity; here :func:`resize_weights` builds the same matrices directly:
half-pixel sample centres, a triangle kernel widened by the inverse scale
when it shrinks (antialiasing), and each output's weights renormalised to
sum to one at the edges.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "gaussian_kernel1d",
    "disk_kernel",
    "motion_kernel",
    "blur_band_matrix",
    "band_matrix_1d",
    "svd_band_factors",
    "resize_weights",
    "resize_band",
    "resize_crop_band",
    "nearest_band",
    "dct8",
    "block_dct_matrix",
    "device_matrix",
    "band_matmul",
    "gaussian_blur_matmul",
    "depthwise_conv2d_matmul",
    "rgb_to_gray",
]


# ── band matrices, made in numpy ──────────────────────────────────────────

def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    """Normalised 1-D Gaussian taps on [-radius, radius] (``image.py:36``)."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / max(sigma, 1e-6)) ** 2)
    return (k / k.sum()).astype(np.float32)


def disk_kernel(radius: int, alias_blur: float = 0.1) -> np.ndarray:
    """Filled-disk PSF for defocus blur, lightly Gaussian-smoothed (``image.py:71``)."""
    y, x = np.mgrid[-radius : radius + 1, -radius : radius + 1].astype(np.float64)
    disk = ((x**2 + y**2) <= radius**2).astype(np.float64)
    if alias_blur > 0:
        r = max(1, int(3 * alias_blur))
        g = gaussian_kernel1d(alias_blur, r).astype(np.float64)
        disk = np.apply_along_axis(lambda m: np.convolve(m, g, mode="same"), 0, disk)
        disk = np.apply_along_axis(lambda m: np.convolve(m, g, mode="same"), 1, disk)
    disk /= disk.sum()
    return disk.astype(np.float32)


def motion_kernel(length: int, angle_deg: float, sigma: float) -> np.ndarray:
    """Oriented line PSF with a Gaussian falloff along the streak (``image.py:85``)."""
    size = length if length % 2 == 1 else length + 1
    c = size // 2
    k = np.zeros((size, size), np.float64)
    theta = np.deg2rad(angle_deg)
    dx, dy = np.cos(theta), np.sin(theta)
    for t in np.linspace(-c, c, 4 * size):
        xi, yi = c + t * dx, c + t * dy
        x0, y0 = int(np.floor(xi)), int(np.floor(yi))
        fx, fy = xi - x0, yi - y0
        w = np.exp(-0.5 * (t / max(sigma, 1e-6)) ** 2)
        for ddx, ddy, ww in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                             (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
            if 0 <= x0 + ddx < size and 0 <= y0 + ddy < size:
                k[y0 + ddy, x0 + ddx] += w * ww
    k /= k.sum()
    return k.astype(np.float32)


def band_matrix_1d(size: int, k: np.ndarray) -> np.ndarray:
    """[size, size] float64 matrix M with ``(M @ src)`` the VALID correlation
    of the reflect-padded source with ``k`` (``image.py:152``)."""
    radius = len(k) // 2
    eye = np.pad(np.eye(size), ((radius, radius), (0, 0)), mode="reflect")
    cols = [np.correlate(eye[:, w], k.astype(np.float64), mode="valid") for w in range(size)]
    return np.stack(cols, axis=1)


@functools.lru_cache(maxsize=64)
def blur_band_matrix(size: int, sigma: float, radius: int) -> np.ndarray:
    """The 1-D Gaussian blur with reflect padding as a [size, size] matrix
    (``image.py:106`` ``_blur_band_matrix``)."""
    # the taps are symmetric, so fav_tpu's convolution is this correlation
    return band_matrix_1d(size, gaussian_kernel1d(sigma, radius)).astype(np.float32)


_SVD_CACHE: dict = {}


def svd_band_factors(kernel: np.ndarray, h: int, w: int, tol: float = 1e-7):
    """A [kh, kw] PSF split by its SVD into stacked band matrices
    ``(my [r, h, h], mx [r, w, w])`` with ``depthwise_conv2d(x, kernel) ==
    einsum('rvh,bhwc,ruw->bvuc', my, x, mx)``; ranks below ``tol`` of the
    spectral mass are dropped (``image.py:162``)."""
    key = (kernel.tobytes(), kernel.shape, h, w, tol)
    hit = _SVD_CACHE.get(key)
    if hit is not None:
        return hit
    u, s, vt = np.linalg.svd(kernel.astype(np.float64))
    keep = s > tol * s.sum()
    u, s, vt = u[:, keep], s[keep], vt[keep]
    my = np.stack([band_matrix_1d(h, u[:, i] * np.sqrt(s[i])) for i in range(len(s))])
    mx = np.stack([band_matrix_1d(w, vt[i] * np.sqrt(s[i])) for i in range(len(s))])
    out = (my.astype(np.float32), mx.astype(np.float32))
    _SVD_CACHE[key] = out
    return out


def resize_weights(out_size: int, in_size: int, antialias: bool = True) -> np.ndarray:
    """[out_size, in_size] float64 matrix of ``jax.image.resize(...,
    'bilinear')`` along one axis: output ``i`` samples the input at
    ``(i + 0.5) / scale - 0.5`` with the triangle kernel, widened by
    ``1 / scale`` when shrinking (if ``antialias``); each row is divided by
    its sum, and rows whose sample lies outside the input are zero."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    dist = np.abs(sample[:, None] - np.arange(in_size, dtype=np.float64)[None, :]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - dist)
    total = weights.sum(axis=1, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], weights, 0.0)


@functools.lru_cache(maxsize=64)
def resize_band(out_size: int, in_size: int) -> np.ndarray:
    """[out_size, in_size] bilinear resize matrix (``image.py:213``)."""
    return resize_weights(out_size, in_size).astype(np.float32)


@functools.lru_cache(maxsize=64)
def resize_crop_band(size: int, zoomed: int, crop_from: int) -> np.ndarray:
    """[size, size]: resize ``size -> zoomed`` bilinearly, then keep rows
    ``crop_from .. crop_from + size`` (``image.py:197``)."""
    return resize_weights(zoomed, size)[crop_from : crop_from + size].astype(np.float32)


@functools.lru_cache(maxsize=64)
def nearest_band(out_size: int, in_size: int) -> np.ndarray:
    """[out_size, in_size] 0/1 matrix of ``jax.image.resize(..., 'nearest')``:
    output ``i`` copies input ``floor((i + 0.5) * in / out)``, the centre
    computed in float32 as jax computes it."""
    src = np.floor((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                   * np.float32(in_size) / np.float32(out_size)).astype(np.int64)
    return np.eye(in_size, dtype=np.float32)[src]


@functools.lru_cache(maxsize=1)
def dct8() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix (``image.py:256``)."""
    k = np.arange(8)
    n = np.arange(8)
    m = np.cos(np.pi * (2 * n[None, :] + 1) * k[:, None] / 16.0)
    m[0] *= 1.0 / np.sqrt(2.0)
    return (m * 0.5).astype(np.float32)


@functools.lru_cache(maxsize=8)
def block_dct_matrix(size: int) -> np.ndarray:
    """[size, size] block-diagonal matrix of ``dct8`` (size a multiple of 8):
    ``D @ a @ D.T`` is the 8x8 blockwise 2-D DCT of ``a`` (``image.py:282``)
    and ``D.T @ a @ D`` its inverse (``:293``)."""
    return np.kron(np.eye(size // 8, dtype=np.float32), dct8())


# ── torch products ────────────────────────────────────────────────────────

_DEVICE_CACHE: dict = {}


def device_matrix(key, build, device: torch.device) -> torch.Tensor:
    """The float32 tensor ``build()`` on ``device``, made once per (key, device)."""
    device = torch.device(device)
    hit = _DEVICE_CACHE.get((key, device))
    if hit is None:
        hit = torch.as_tensor(np.ascontiguousarray(build(), dtype=np.float32), device=device)
        _DEVICE_CACHE[(key, device)] = hit
    return hit


def band_matmul(x: torch.Tensor, my: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """``einsum('rvh,bhwc,ruw->bvuc', my, x, mx)`` for NHWC ``x``; ``my`` is
    [r, H', H] (or [H', H] for r = 1), ``mx`` [r, W', W] (or [W', W]).

    Two products: along W, the (r W', W) matrix broadcast against each of
    the B*H (W, C) slices, a batched product of many small GEMMs; then along
    (H, r) jointly, one batched GEMM per image. Channels ride along as the
    trailing axis."""
    if my.ndim == 2:
        my, mx = my[None], mx[None]
    r, h2, h = my.shape
    _, w2, w = mx.shape
    b, hx, wx, c = x.shape
    if (hx, wx) != (h, w):
        raise ValueError(f"band matrices act on {h}x{w} images, got {hx}x{wx}")
    # y[b, h, r, u, c] = sum_w mx[r, u, w] x[b, h, w, c]
    y = torch.matmul(mx.reshape(r * w2, w), x.reshape(b * h, w, c))
    # out[b, v, u, c] = sum_(h, r) my[r, v, h] y[b, h, r, u, c]
    left = my.permute(1, 2, 0).reshape(h2, h * r)
    out = torch.matmul(left, y.reshape(b, h * r, w2 * c))
    return out.reshape(b, h2, w2, c)


def gaussian_blur_matmul(x: torch.Tensor, sigma: float, radius: int | None = None) -> torch.Tensor:
    """Separable Gaussian blur (reflect padding) of NHWC ``x`` as two band
    products (``image.py:116``)."""
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    _, h, w, _ = x.shape
    my = device_matrix(("blur", h, float(sigma), radius),
                       lambda: blur_band_matrix(h, float(sigma), radius), x.device)
    mx = device_matrix(("blur", w, float(sigma), radius),
                       lambda: blur_band_matrix(w, float(sigma), radius), x.device)
    return band_matmul(x, my, mx)


def depthwise_conv2d_matmul(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Per-channel 2-D correlation with ``kernel`` (reflect padding, same
    size) as rank-stacked band products (``image.py:181``)."""
    _, h, w, _ = x.shape
    key = ("svd", kernel.tobytes(), kernel.shape, h, w)
    my = device_matrix(key + ("y",), lambda: svd_band_factors(kernel, h, w)[0], x.device)
    mx = device_matrix(key + ("x",), lambda: svd_band_factors(kernel, h, w)[1], x.device)
    return band_matmul(x, my, mx)


def rgb_to_gray(x: torch.Tensor) -> torch.Tensor:
    """BT.601 luma of NHWC RGB, channel axis kept (``image.py:249``)."""
    w = device_matrix("gray", lambda: np.array([0.299, 0.587, 0.114]), x.device)
    return torch.sum(x * w, dim=-1, keepdim=True)
