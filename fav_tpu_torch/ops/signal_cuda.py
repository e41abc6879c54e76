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
  stream, in the geometry ``frame_stats_geometry`` picks from (B, H, W)
  and the card's SM count,
  raises if the launcher reports an error, and adds one to K7's launch
  count. There is no fallback.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fav_tpu_torch.config import AnalyzerParams
from fav_tpu_torch.ops import signal as plain
from fav_tpu_torch.ops.corruptions_cuda import KERNELS, SHARED_MEMORY_LIMIT, multiprocessors

__all__ = ["HEADER_INTS", "FrameStatsGeometry", "frame_stats_geometry", "tile_ints", "frame_statistics",
           "frame_stats", "analyze_frames"]

# The tiles K7 aims for: four blocks on each of the card's SMs.
BLOCKS_PER_SM = 4
# A large frame's tile goes to a block with a thread for each of its
# columns, up to MAX_TEAM threads (a block of 1024 would need at most 64
# registers a thread), and holds at least MIN_TILE_PIXELS pixels where the
# frame has them.
MAX_TEAM = 512
MIN_TILE_PIXELS = 1024
# Frames of at most WARP_FRAME_PIXELS pixels go to one warp each, at most
# MAX_WARPS a block.
WARP_FRAME_PIXELS = 4096
MAX_WARPS = 2
BINS = 256
# A block's shared memory is all dynamic: a header (the warps' four partial
# int64 sums and the merge's flag, rounded to 16 bytes; kHeaderInts in
# csrc/frame_stats.cu), then each team's tile.
HEADER_INTS = 4 * 32 * 2 + 4


class FrameStatsGeometry(NamedTuple):
    """K7's launch: tiles of ``rows`` x ``cols`` pixels (``tiles`` a
    frame), each owned by a team of ``team`` threads, ``units`` teams a
    block, ``shared_bytes`` of shared memory a block (the launcher derives
    the same from the rest), ``blocks`` blocks."""
    rows: int
    cols: int
    units: int
    team: int
    shared_bytes: int
    tiles: int
    blocks: int


def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def tile_ints(h: int, w: int, rows: int, cols: int) -> int:
    """Ints of shared memory one team's tile takes (``layout`` in
    csrc/frame_stats.cu): g's tile with its halo, p's tile, 256 bins. A
    tile of whole rows stages each frame's rows as one run; a column tile
    stages row by row. Each run leaves three ints for its 16-byte phase."""
    g_rows = min(rows + 2, h)
    if cols >= w:
        return _round4(g_rows * w + 3) + _round4(rows * w + 3) + BINS
    return g_rows * _round4(min(cols + 2, w) + 3) + rows * _round4(cols + 3) + BINS


def _block_bytes(units: int, tile: int) -> int:
    return (HEADER_INTS + units * tile) * 4


def frame_stats_geometry(b: int, h: int, w: int, sms: int) -> FrameStatsGeometry:
    """K7's geometry for ``b`` frames of ``h`` x ``w`` on a card of ``sms``
    SMs, within the 48 KB of shared memory a block gets without opting in.

    * A frame of at most ``WARP_FRAME_PIXELS`` pixels that fits goes whole
      to one warp, as many warps a block as fit (at most ``MAX_WARPS``).
    * A larger frame is cut into row strips of ``rows`` rows (and column
      strips, only where one row with its halo would not fit), enough that
      ``b`` x tiles reaches ``BLOCKS_PER_SM`` x ``sms``, with at least
      ``MIN_TILE_PIXELS`` pixels a tile; one block a tile, a thread for
      each column (rounded up to a warp, at most ``MAX_TEAM``).
    """
    plain.check_frame_size(h, w)
    if b < 1:
        raise ValueError(f"frame_stats: a batch of {b} frames")
    whole = tile_ints(h, w, h, w)
    if h * w <= WARP_FRAME_PIXELS and _block_bytes(1, whole) <= SHARED_MEMORY_LIMIT:
        units = max(1, min(MAX_WARPS, (SHARED_MEMORY_LIMIT // 4 - HEADER_INTS) // whole, b))
        return FrameStatsGeometry(h, w, units, 32, _block_bytes(units, whole), 1, _ceil(b, units))
    col_tiles = 1
    while _block_bytes(1, tile_ints(h, w, 1, _ceil(w, col_tiles))) > SHARED_MEMORY_LIMIT:
        col_tiles += 1
    cols = _ceil(w, col_tiles)
    col_tiles = _ceil(w, cols)
    row_tiles = min(h, max(1, _ceil(_ceil(BLOCKS_PER_SM * sms, b), col_tiles)))
    rows = max(_ceil(h, row_tiles), min(h, _ceil(MIN_TILE_PIXELS, cols)))
    while rows > 1 and _block_bytes(1, tile_ints(h, w, rows, cols)) > SHARED_MEMORY_LIMIT:
        rows -= 1
    tiles = _ceil(h, rows) * col_tiles
    team = min(MAX_TEAM, _ceil(cols, 32) * 32)
    return FrameStatsGeometry(rows, cols, 1, team, _block_bytes(1, tile_ints(h, w, rows, cols)), tiles,
                              b if tiles == 1 else b * tiles)


# K7's per-frame ticket counters, by device and stream: zeros when made, and
# every launch leaves them zero, so no launch clears them.
_tickets: dict[tuple[torch.device, int], torch.Tensor] = {}


def _ticket_counters(device: torch.device, b: int) -> torch.Tensor:
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    t = _tickets.get(key)
    if t is None or t.numel() < b:
        t = torch.zeros(max(b, 64), dtype=torch.int32, device=device)
        _tickets[key] = t
    return t


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
    geo = frame_stats_geometry(b, h, w, multiprocessors(dev))
    scratch = [0, 0, 0]
    if geo.tiles > 1:
        part_sums = torch.empty((b, geo.tiles, 4), dtype=torch.int64, device=dev)
        part_hist = torch.empty((b, geo.tiles, BINS), dtype=torch.int32, device=dev)
        scratch = [part_sums.data_ptr(), part_hist.data_ptr(), _ticket_counters(dev, b).data_ptr()]
    KERNELS["frame_stats"].launch(dev, gray.data_ptr(), prev_gray.data_ptr(), flags.data_ptr(),
                                  stats.data_ptr(), hist.data_ptr(), *scratch, b, h, w, geo.rows, geo.cols,
                                  geo.units, geo.team)
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
