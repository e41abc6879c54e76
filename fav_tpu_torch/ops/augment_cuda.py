"""Wrappers of CUDA kernels K9a and K9b, the AugMix affine's shear passes.

Counterpart of ``fav_tpu/ops/augment_pallas.py`` (``_shear_pass`` :73,
``affine_scanline_pallas`` :112). ``shear_rows`` (K9a) shifts each row of
an NHWC float32 batch by its own amount, ``shear_cols`` (K9b) each column;
``ops/augment.py:affine_scanline`` runs them as its three passes. The
source is ``csrc/shear.cu``; ``ops/_build.py`` compiles it at the first
launch, and its launches count in ``corruptions_cuda.KERNELS`` under
``shear_rows`` and ``shear_cols``.

A wrapper checks its input and then:

* on a CPU tensor runs the plain version of ``ops/augment.py``
  (``shift_rows``, ``shift_cols``);
* on a CUDA tensor launches its kernel on PyTorch's current stream, raises
  if the launcher reports an error, and adds one to the kernel's launch
  count. There is no fallback.
"""

from __future__ import annotations

import torch

from fav_tpu_torch.ops import augment as plain
from fav_tpu_torch.ops.corruptions_cuda import KERNELS

__all__ = ["shear_rows", "shear_cols"]


def _check(name: str, x: torch.Tensor, delta: torch.Tensor, axis: int) -> bool:
    """Validates the pair and says whether it takes the plain version."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 or x.ndim != 4:
        raise ValueError(f"{name}: expected float32 NHWC images (B, H, W, C), got "
                         f"{getattr(x, 'dtype', type(x).__name__)} {tuple(getattr(x, 'shape', ()))}")
    want = (x.shape[0], x.shape[axis])
    if not isinstance(delta, torch.Tensor) or delta.dtype != torch.float32 or tuple(delta.shape) != want:
        raise ValueError(f"{name}: delta must be float32 of shape {want}, got "
                         f"{getattr(delta, 'dtype', type(delta).__name__)} {tuple(getattr(delta, 'shape', ()))}")
    if delta.device != x.device or not x.is_contiguous() or not delta.is_contiguous():
        raise ValueError(f"{name}: images and delta must be contiguous on one device")
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return False


def _launch(kernel: str, x: torch.Tensor, delta: torch.Tensor, m: int) -> torch.Tensor:
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    KERNELS[kernel].launch(x.device, x.data_ptr(), delta.data_ptr(), out.data_ptr(), b, h, w, c, int(m))
    return out


def shear_rows(x: torch.Tensor, delta: torch.Tensor, max_shift: int) -> torch.Tensor:
    """K9a: ``out[b, y, x] = x[b, y, x + delta[b, y]]``, linear between the
    two nearest columns, edges clamped, ``delta`` (B, H) clipped to
    [-max_shift, max_shift - 1]."""
    if _check("shear_rows", x, delta, 1):
        return plain.shift_rows(x, delta, max_shift)
    return _launch("shear_rows", x, delta, max_shift)


def shear_cols(x: torch.Tensor, delta: torch.Tensor, max_shift: int) -> torch.Tensor:
    """K9b: ``out[b, y, x] = x[b, y + delta[b, x], x]``, as ``shear_rows``
    along the other axis, ``delta`` (B, W)."""
    if _check("shear_cols", x, delta, 2):
        return plain.shift_cols(x, delta, max_shift)
    return _launch("shear_cols", x, delta, max_shift)
