"""Wrappers of CUDA kernels K9a and K9b, the AugMix affine's shear passes.

Counterpart of ``fav_tpu/ops/augment_pallas.py`` (``_shear_pass`` :73,
``affine_scanline_pallas`` :112). ``shear_rows`` (K9a) shifts each row of
an NHWC float32 or bfloat16 batch by its own amount, ``shear_cols`` (K9b)
each column; ``ops/augment.py:affine_scanline`` runs them as its three
passes. The source is ``csrc/shear.cu``; ``ops/_build.py`` compiles it at
the first launch, and its launches count in ``corruptions_cuda.KERNELS``
under ``shear_rows`` and ``shear_cols`` for float32 images and under
``shear_rows_bf16`` and ``shear_cols_bf16`` for bfloat16 ones (the chain
of ``augmix(..., bf16=True)``). The shifts are float32 either way.

A wrapper checks its input and then:

* on a CPU tensor runs the plain version of ``ops/augment.py``
  (``shift_rows``, ``shift_cols``);
* on a CUDA tensor launches its kernel on PyTorch's current stream, raises
  if the launcher reports an error, and adds one to the kernel's launch
  count. There is no fallback.

bf16 K9a has a kernel of its own (``shear_rows_bf16_kernel`` in
``csrc/shear.cu``): a block stages whole rows, or a window of a long row,
in shared memory and writes 16 bytes a thread. Its units and shared bytes
come from ``shear_rows_bf16_geometry``, which raises for a shape the kernel
cannot take.

bf16 K9b is ``shear_cols_staged_kernel``: a block stages whole images in
shared memory and walks runs of rows of one column a thread.
``shear_cols_geometry`` picks the images a block, and sends an image that
does not fit the stage to the direct one-pixel-a-thread ``shear_kernel``
(on an H100, windows of adjacent columns staged over all rows were slower
there); both are hand-written kernels, the launch counts under
``shear_cols_bf16`` either way, and a shape neither takes raises. float32
K9b stays on ``shear_kernel`` (it reached half of its bound there).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fav_tpu_torch.ops import augment as plain
from fav_tpu_torch.ops.corruptions_cuda import KERNELS, SHARED_MEMORY_LIMIT, multiprocessors

__all__ = ["ROWS_THREADS", "ROWS_STAGE", "ROWS_MAX", "ROWS_BLOCKS_PER_SM", "ROWS_STEP", "RowsGeometry",
           "shear_rows_bf16_geometry", "COLS_THREADS", "COLS_STAGE", "COLS_MAX", "COLS_BLOCKS_PER_SM",
           "ColsGeometry", "shear_cols_geometry", "shear_rows", "shear_cols"]

# bf16 K9a's block (kRowsThreads, kRowsStage, kRowsMax in csrc/shear.cu):
# threads, bf16 values a stage holds, rows a block takes at most.
ROWS_THREADS = 256
ROWS_STAGE = 8192
ROWS_MAX = 512
# Whole rows are spread over about this many blocks an SM, one wave, in
# blocks of a multiple of ROWS_STEP rows: each block pays a copy in, a
# barrier and a write out at full latency, so fewer and fuller blocks run
# faster. On an H100 at (768, 32, 32, 3), blocks of 32 to 64 rows beat 24
# (8 blocks an SM), and 48 rows beat 47 and 56.
ROWS_BLOCKS_PER_SM = 4
ROWS_STEP = 16
# A stage holds a span and its 16-byte phase: up to 7 values before it.
_PHASE = 7
_MAX_UNITS = 2**31 - 1


class RowsGeometry(NamedTuple):
    """bf16 K9a's launch: ``units`` blocks of ``ROWS_THREADS`` threads,
    each taking ``rows_per_block`` whole rows (``window`` 0) or one window
    of ``window`` output pixels of a row (``windows_per_row`` a row), with
    ``in_stage`` and ``out_stage`` bf16 values of staging and
    ``shared_bytes`` in all (the launcher derives the same)."""
    rows_per_block: int
    window: int
    windows_per_row: int
    units: int
    in_stage: int
    out_stage: int
    shared_bytes: int


def _stage(values: int) -> int:
    return (values + _PHASE + 7) // 8 * 8


def shear_rows_bf16_geometry(b: int, h: int, w: int, c: int, sms: int) -> RowsGeometry:
    """bf16 K9a's units for (B, H, W, C) on a card of ``sms`` SMs. Rows of
    W C values that fit a stage go whole, as many a block as spread the B H
    rows over one wave of ``ROWS_BLOCKS_PER_SM`` blocks an SM, rounded up to
    a multiple of ``ROWS_STEP`` (at most what a stage and ``ROWS_MAX``
    allow, so a larger batch takes more waves); a longer row goes by
    windows whose sources, one pixel more than the window, fit a stage.
    Raises where a pixel does not fit a stage or the units pass the grid's
    limit."""
    if min(b, h, w, c) < 1:
        raise ValueError(f"shear_rows: empty shape {(b, h, w, c)}")
    rows, row_len = b * h, w * c
    if row_len + _PHASE <= ROWS_STAGE:
        fit = min(ROWS_MAX, (ROWS_STAGE - _PHASE) // row_len)
        spread = -(-rows // (sms * ROWS_BLOCKS_PER_SM))
        per = max(1, min(fit, -(-spread // ROWS_STEP) * ROWS_STEP))
        window, windows, units = 0, 1, -(-rows // per)
        in_values = out_values = per * row_len
    else:
        per, window = 1, (ROWS_STAGE - _PHASE) // c - 1
        if window < 1:
            raise ValueError(f"shear_rows: a pixel of {c} channels does not fit a stage of {ROWS_STAGE} values")
        windows = -(-w // window)
        units = rows * windows
        in_values, out_values = (window + 1) * c, window * c
    if units > _MAX_UNITS:
        raise ValueError(f"shear_rows: {units} blocks for {(b, h, w, c)} pass the grid's {_MAX_UNITS}")
    in_stage, out_stage = _stage(in_values), _stage(out_values)
    shared = 16 * per + 2 * (in_stage + out_stage)
    if shared > SHARED_MEMORY_LIMIT:
        raise ValueError(f"shear_rows: {shared} bytes of shared memory pass {SHARED_MEMORY_LIMIT}")
    return RowsGeometry(per, window, windows if window else 0, units, in_stage, out_stage, shared)


# bf16 K9b's block (kColsThreads, kColsStage, kColsMax in csrc/shear.cu):
# threads, bf16 values a stage holds, columns (shifts) a block takes at most.
COLS_THREADS = 256
COLS_STAGE = 8192
COLS_MAX = 1024
# Whole images are spread over about this many blocks an SM, one wave.
COLS_BLOCKS_PER_SM = 4
_MAX_VALUES = 2**31 - 1


class ColsGeometry(NamedTuple):
    """bf16 K9b's launch: ``units`` blocks of ``COLS_THREADS`` threads, each
    taking ``images_per_block`` whole images, with a stage of ``stage``
    values and ``shared_bytes`` in all (the launcher derives the same).
    ``images_per_block`` 0: the direct ``shear_kernel``, ``units`` blocks
    of 256 pixels an image."""
    images_per_block: int
    units: int
    stage: int
    shared_bytes: int

    @property
    def route(self) -> str:
        return "images" if self.images_per_block else "direct"


def shear_cols_geometry(b: int, h: int, w: int, c: int, sms: int) -> ColsGeometry:
    """bf16 K9b's units for (B, H, W, C) on a card of ``sms`` SMs. Images
    whose H W C values fit a stage (and whose W shifts fit the table) go
    whole, as many a block as spread the B images over one wave of
    ``COLS_BLOCKS_PER_SM`` blocks an SM (at most what a stage and
    ``COLS_MAX`` allow, so a larger batch takes more waves); other images
    go to the direct kernel. Raises for an empty shape, an image of 2**31
    values or more, or a batch of 2**31 images or more."""
    if min(b, h, w, c) < 1:
        raise ValueError(f"shear_cols: empty shape {(b, h, w, c)}")
    hwc = h * w * c
    if hwc > _MAX_VALUES:
        raise ValueError(f"shear_cols: an image of {hwc} values passes the kernels' 32-bit index")
    if b > _MAX_VALUES:
        raise ValueError(f"shear_cols: a batch of {b} images passes the launchers' 32-bit batch")
    if hwc + _PHASE > COLS_STAGE or w > COLS_MAX:
        return ColsGeometry(0, -(-(h * w) // 256), 0, 0)
    fit = min((COLS_STAGE - _PHASE) // hwc, COLS_MAX // w)
    per = max(1, min(fit, -(-b // (sms * COLS_BLOCKS_PER_SM))))
    # at most COLS_MAX shifts of 16 bytes and a 16 KB stage: within the
    # shared memory a block may take, and at most B blocks
    stage = _stage(per * hwc)
    return ColsGeometry(per, -(-b // per), stage, 16 * per * w + 2 * stage)


def _check(name: str, x: torch.Tensor, delta: torch.Tensor, axis: int) -> bool:
    """Validates the pair and says whether it takes the plain version."""
    if not isinstance(x, torch.Tensor) or x.dtype not in (torch.float32, torch.bfloat16) or x.ndim != 4:
        raise ValueError(f"{name}: expected float32 or bfloat16 NHWC images (B, H, W, C), got "
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
    args = [x.data_ptr(), delta.data_ptr(), out.data_ptr(), b, h, w, c, int(m)]
    if x.dtype == torch.bfloat16:
        if kernel == "shear_rows":
            geo = shear_rows_bf16_geometry(b, h, w, c, multiprocessors(x.device))
            args += [geo.rows_per_block, geo.window]
        else:
            geo = shear_cols_geometry(b, h, w, c, multiprocessors(x.device))
            args.append(geo.images_per_block)
        kernel += "_bf16"
    KERNELS[kernel].launch(x.device, *args)
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
