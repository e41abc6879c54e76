"""Wrapper of CUDA kernel K7 (frame statistics and the gray histogram), and
the batched analyzer composite that runs on it.

Counterpart of ``fav_tpu/ops/signal_pallas.py``: ``frame_stats`` keeps
``frame_stats_pallas``'s contract (:86, [B, 3] float32), and
``analyze_frames`` is the ``analyze_frames_pallas`` composite (:111). The
source is ``csrc/frame_stats.cu``; ``ops/_build.py`` compiles it at the
first launch, and its launches count in ``corruptions_cuda.KERNELS``.

The wrapper checks its input and then:

* on a CPU tensor runs the plain version of ``ops/signal.py``;
* on a CUDA tensor launches K7 once for the batch on PyTorch's current
  stream, raises if the launcher reports an error, and adds one to K7's
  launch count. There is no fallback.
"""

from __future__ import annotations

import torch

from fav_tpu_torch.config import AnalyzerParams
from fav_tpu_torch.ops import signal as plain
from fav_tpu_torch.ops.corruptions_cuda import KERNELS

__all__ = ["frame_statistics", "frame_stats", "analyze_frames"]


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype, device: torch.device) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"frame_stats: {name} must be {dtype} of shape {shape}, got "
                         f"{getattr(t, 'dtype', type(t).__name__)} {tuple(getattr(t, 'shape', ()))}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"frame_stats: {name} must be contiguous on {device}")


def frame_statistics(gray: torch.Tensor, prev_gray: torch.Tensor,
                     has_prev: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K7: ``(stats float32 [B, 3], hist int32 [B, 256])`` of int32 gray
    and prev [B, H, W] and ``has_prev`` [B] (bool or int32), as
    ``ops/signal.py:frame_statistics_plain`` defines them."""
    if not isinstance(gray, torch.Tensor) or gray.dtype != torch.int32 or gray.ndim != 3:
        raise ValueError(f"frame_stats: gray must be int32 [B, H, W], got "
                         f"{getattr(gray, 'dtype', type(gray).__name__)} {tuple(getattr(gray, 'shape', ()))}")
    b, h, w = gray.shape
    plain.check_frame_size(h, w)
    dev = gray.device
    _check("gray", gray, (b, h, w), torch.int32, dev)
    _check("prev_gray", prev_gray, (b, h, w), torch.int32, dev)
    if not isinstance(has_prev, torch.Tensor) or tuple(has_prev.shape) != (b,) or has_prev.device != dev:
        raise ValueError(f"frame_stats: has_prev must be a tensor of shape {(b,)} on {dev}")
    if dev.type == "cpu":
        return plain.frame_statistics_plain(gray, prev_gray, has_prev)
    if dev.type != "cuda":
        raise ValueError(f"frame_stats: unsupported device {dev}")
    flags = has_prev.to(torch.int32).contiguous()
    stats = torch.empty((b, 3), dtype=torch.float32, device=dev)
    hist = torch.empty((b, 256), dtype=torch.int32, device=dev)
    KERNELS["frame_stats"].launch(dev, gray.data_ptr(), prev_gray.data_ptr(), flags.data_ptr(),
                                  stats.data_ptr(), hist.data_ptr(), b, h, w)
    return stats, hist


def frame_stats(gray: torch.Tensor, prev_gray: torch.Tensor, has_prev: torch.Tensor) -> torch.Tensor:
    """Raw per-frame statistics [B, 3] float32: (Laplacian variance, mean
    brightness, mean |g - prev| or 10.0), ``frame_stats_pallas``'s contract."""
    return frame_statistics(gray, prev_gray, has_prev)[0]


def analyze_frames(params: AnalyzerParams, carry: plain.AnalyzerCarry,
                   frames_bgr: torch.Tensor) -> tuple[plain.AnalyzerCarry, plain.FrameMetrics]:
    """The batched analyzer on K7: uint8 BGR [B, H, W, 3] under a carry of
    B rows. Gray conversion is a torch int32 op, then one K7 launch gives
    the statistics and histograms, then the shared derivation of
    ``ops/signal.py`` gives scores, statuses and the next carry."""
    if frames_bgr.ndim != 4 or frames_bgr.shape[-1] != 3:
        raise ValueError(f"analyze_frames: expected BGR frames [B, H, W, 3], got {tuple(frames_bgr.shape)}")
    return plain.analyze_frame(params, carry, frames_bgr)
