"""The launch geometry of K6p and K7, which their wrappers pick in plain
Python, checked on the CPU.

* K7 (``ops/signal_cuda.py:frame_stats_geometry``): across the frame-size
  check's range, the tiles cover every pixel of a frame exactly once, the
  halos stay inside the frame, the shared memory (all of it dynamic: the
  block's header and its tiles) stays within the 48 KB a block gets, and
  the service's bucket fills the card. A numpy replay of
  the kernel's index arithmetic (``csrc/frame_stats.cu``: the runs staged
  at their 16-byte phase, the REFLECT_101 neighbours read from the staged
  tile as each thread walks its columns down the tile, the tiles merged)
  gives the exact sums and histograms of the plain version, on any base
  address.
* K6p (``ops/corruptions_cuda.py:elastic_packed_geometry``): the ring of
  group tiles fits a block's shared memory at every severity's G, the grid
  never has more blocks than groups, and each thread's stepped pixels
  cover a group exactly once.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fav_tpu_torch.ops import corruptions as tc
from fav_tpu_torch.ops import corruptions_cuda as cuda_ops
from fav_tpu_torch.ops import signal as ts
from fav_tpu_torch.ops import signal_cuda as k7

H100_SMS = 132

# (B, H, W) across check_frame_size's range: the service's bucket and the
# grid's batch, frames of 2 rows or 2 columns, rows that no strip divides,
# widths that are not multiples of 4, rows too wide for shared memory, the
# largest frames the int64 sums allow, and frames whose tiles come within
# the block's header of 48 KB (a 2-row strip of 2000, rows of 2943-3006).
K7_SHAPES = [
    (32, 240, 320), (6144, 32, 32), (1, 240, 320), (8, 240, 320), (3, 241, 317), (5, 2, 2), (1, 2, 2),
    (1, 1024, 2048), (1, 2, 2 ** 20), (1, 2 ** 20, 2), (7, 1080, 1920), (2, 4096, 512), (1, 2, 2048),
    (8, 48, 64), (1, 3, 4099), (4, 1449, 1447), (1, 1000, 2000), (1, 3, 3000), (2, 64, 2943), (1, 5, 3006),
]
CSRC = Path(cuda_ops.__file__).parent / "csrc"


def _tiles(geo: k7.FrameStatsGeometry, h: int, w: int):
    """Each tile's rows [r0, r1), columns [c0, c1) and staged rows and
    columns of g, as the kernel derives them from its tile index."""
    col_tiles = -(-w // geo.cols)
    for tile in range(geo.tiles):
        r0 = (tile // col_tiles) * geo.rows
        c0 = (tile % col_tiles) * geo.cols
        r1, c1 = min(r0 + geo.rows, h), min(c0 + geo.cols, w)
        yield r0, r1, c0, c1, max(r0 - 1, 0), min(r1, h - 1), max(c0 - 1, 0), min(c1, w - 1)


@pytest.mark.parametrize("shape", K7_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k7_tiles_cover_each_frame_once_within_shared_memory(shape):
    b, h, w = shape
    geo = k7.frame_stats_geometry(b, h, w, H100_SMS)
    assert geo.tiles == -(-h // geo.rows) * -(-w // geo.cols)
    assert geo.shared_bytes <= cuda_ops.SHARED_MEMORY_LIMIT
    assert geo.shared_bytes == (k7.HEADER_INTS + geo.units * k7.tile_ints(h, w, geo.rows, geo.cols)) * 4
    assert geo.team % 32 == 0 and geo.units * geo.team <= 1024
    if geo.units > 1:
        assert geo.team == 32 and geo.tiles == 1
    assert geo.blocks == (-(-b // geo.units) if geo.tiles == 1 else b * geo.tiles)
    covered = np.zeros((h, w), np.int16)
    for r0, r1, c0, c1, glo, ghi, gclo, gchi in _tiles(geo, h, w):
        assert 0 <= r0 < r1 <= h and 0 <= c0 < c1 <= w
        # the halo stays in the frame and holds every REFLECT_101 neighbour
        assert 0 <= glo <= ghi < h and 0 <= gclo <= gchi < w
        for r in {r0, r1 - 1}:
            for n in (r - 1, r + 1):
                assert glo <= (-n if n < 0 else (2 * h - 2 - n if n >= h else n)) <= ghi
        for c in {c0, c1 - 1}:
            for n in (c - 1, c + 1):
                assert gclo <= (-n if n < 0 else (2 * w - 2 - n if n >= w else n)) <= gchi
        covered[r0:r1, c0:c1] += 1
    assert (covered == 1).all()


def test_k7_shared_memory_is_all_dynamic_with_the_wrappers_header():
    """The wrapper's count of a block's bytes is the block's whole only if
    the kernel declares no static shared memory and its header is
    HEADER_INTS; the tiles after it start on a 16-byte boundary."""
    src = (CSRC / "frame_stats.cu").read_text()
    assert all(line.lstrip().startswith("extern __shared__")
               for line in src.splitlines() if "__shared__" in line and not line.lstrip().startswith("//"))
    warps = int(re.search(r"constexpr int kMaxWarps = (\d+);", src).group(1))
    header = re.search(r"constexpr int kHeaderInts = ([^;]+);", src).group(1)
    assert eval(header.replace("kMaxWarps", str(warps))) == k7.HEADER_INTS
    assert k7.HEADER_INTS % 4 == 0 and k7.HEADER_INTS >= 4 * warps * 2 + 1


def test_k7_geometry_fills_the_card_at_the_service_shape():
    geo = k7.frame_stats_geometry(32, 240, 320, H100_SMS)
    assert geo.blocks >= 2 * H100_SMS
    assert (geo.rows, geo.cols, geo.tiles, geo.team) == (15, 320, 16, 320)
    # the grid's small frames go to warps, several a block
    geo = k7.frame_stats_geometry(6144, 32, 32, H100_SMS)
    assert geo.team == 32 and geo.units > 1 and geo.tiles == 1


def test_k7_geometry_refuses_what_the_check_refuses():
    with pytest.raises(ValueError):
        k7.frame_stats_geometry(1, 1449, 1449, H100_SMS)
    with pytest.raises(ValueError):
        k7.frame_stats_geometry(1, 1, 64, H100_SMS)
    with pytest.raises(ValueError):
        k7.frame_stats_geometry(0, 32, 32, H100_SMS)


def _replay_k7(gray: np.ndarray, prev: np.ndarray, geo: k7.FrameStatsGeometry, misalign: int):
    """The kernel's index arithmetic in numpy: per tile, stage g's and p's
    runs at their 16-byte phase (the buffers' element 0 sits ``misalign``
    ints past a 16-byte boundary) into a shared array of poisoned ints, read
    every pixel's neighbours back from it,
    walking each thread's columns down the tile, and sum. Returns the four
    sums [B, 4] and the histograms [B, 256]."""
    b, h, w = gray.shape
    n = h * w
    flat_g, flat_p = gray.reshape(-1), prev.reshape(-1)
    full = geo.cols >= w
    g_rows = min(geo.rows + 2, h)
    g_stride = w if full else (min(geo.cols + 2, w) + 3 + 3) // 4 * 4
    p_stride = w if full else (geo.cols + 3 + 3) // 4 * 4
    g_ints = (g_rows * w + 3 + 3) // 4 * 4 if full else g_rows * g_stride
    unit = k7.tile_ints(h, w, geo.rows, geo.cols)
    poison = np.iinfo(np.int64).min
    sums = np.zeros((b, 4), np.int64)
    hist = np.zeros((b, 256), np.int64)

    def stage(smem, base, src, start, length, limit):
        ph = (misalign + start) & 3
        assert base % 4 == 0 and base + ph + length <= limit
        smem[base + ph: base + ph + length] = src[start: start + length]

    for f in range(b):
        for r0, r1, c0, c1, glo, ghi, gclo, gchi in _tiles(geo, h, w):
            smem = np.full(unit, poison, np.int64)
            sp = g_ints
            if full:
                stage(smem, 0, flat_g, f * n + glo * w, (ghi - glo + 1) * w, g_ints)
                stage(smem, sp, flat_p, f * n + r0 * w, (r1 - r0) * w, unit - 256)
            else:
                for r in range(glo, ghi + 1):
                    stage(smem, (r - glo) * g_stride, flat_g, f * n + r * w + gclo, gchi - gclo + 1, g_ints)
                for r in range(r0, r1):
                    stage(smem, sp + (r - r0) * p_stride, flat_p, f * n + r * w + c0, c1 - c0, unit - 256)
            g_ph = (misalign + f * n + glo * w + gclo) & 3
            p_ph = (misalign + f * n + r0 * w + c0) & 3

            def g_row(i):
                return i * g_stride + (g_ph if full else (g_ph + i * w) & 3)

            def p_row(i):
                return sp + i * p_stride + (p_ph if full else (p_ph + i * w) & 3)

            def reflect(i, m):
                return np.where(i < 0, -i, np.where(i >= m, 2 * m - 2 - i, i))

            tw = c1 - c0
            t = np.arange(geo.team)
            seen = np.zeros((r1 - r0, tw), np.int64)
            for cb in range(0, tw, geo.team):
                c = cb + t[cb + t < tw]
                gc = c0 + c
                jc, jl, jr = gc - gclo, reflect(gc - 1, w) - gclo, reflect(gc + 1, w) - gclo
                up = smem[g_row(reflect(r0 - 1, h) - glo) + jc]
                mid = smem[g_row(r0 - glo) + jc]
                for r in range(r0, r1):
                    row = g_row(r - glo)
                    down = smem[g_row(reflect(r + 1, h) - glo) + jc]
                    v = mid
                    lap = up + down + smem[row + jl] + smem[row + jr] - 4 * v
                    pv = smem[p_row(r - r0) + c]
                    assert (v != poison).all() and (pv != poison).all() and (np.abs(lap) < 1 << 40).all()
                    seen[r - r0, c] += 1
                    sums[f] += [v.sum(), lap.sum(), (lap * lap).sum(), np.abs(v - pv).sum()]
                    np.add.at(hist[f], v[(v >= 0) & (v <= 255)], 1)
                    up, mid = mid, down
            assert (seen == 1).all()
    return sums, hist


@pytest.mark.parametrize("shape,misalign", [
    ((3, 241, 317), 1), ((5, 2, 2), 3), ((4, 33, 35), 2), ((2, 64, 100), 0), ((1, 2, 5000), 1),
    ((1, 700, 3), 3), ((2, 240, 320), 0), ((1, 3, 3000), 2),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else f"off{v}")
def test_k7_replay_of_the_kernel_gives_the_exact_sums(shape, misalign):
    b, h, w = shape
    rng = np.random.default_rng(sum(shape) + misalign)
    gray = rng.integers(0, 256, shape).astype(np.int64)
    gray[0] = 9  # a flat frame
    gray[-1, : h // 2] = rng.integers(0, 256)
    odd = rng.integers(0, gray.size, max(1, gray.size // 500))
    gray.reshape(-1)[odd] = rng.integers(-300, 600, odd.size)
    prev = rng.integers(0, 256, shape).astype(np.int64)
    geo = k7.frame_stats_geometry(b, h, w, H100_SMS)
    sums, hist = _replay_k7(gray, prev, geo, misalign)
    g32 = torch.from_numpy(gray.astype(np.int32))
    lap = ts.laplacian(g32).numpy().astype(np.int64)
    want = np.stack([gray.sum((1, 2)), lap.sum((1, 2)), (lap * lap).sum((1, 2)),
                     np.abs(gray - prev).sum((1, 2))], axis=1)
    np.testing.assert_array_equal(sums, want)
    np.testing.assert_array_equal(hist, ts.histogram_256(g32).numpy())


@pytest.mark.parametrize("severity,g", [(1, 3), (2, 3), (3, 3), (4, 2), (5, 2)])
def test_k6p_ring_fits_at_every_severity(severity, g):
    b, h, w, c = 6144, 32, 32, 3
    assert tc.packed_group(b, w + 2 * (tc.elastic_margin(severity) + 1)) == g
    geo = cuda_ops.elastic_packed_geometry(b, g, h, w, c, H100_SMS)
    # the kernel's ring: two input tiles and an output tile of a group
    assert 3 * g * h * w * c * 4 < geo.shared_bytes <= cuda_ops.OPT_IN_SHARED_MEMORY_LIMIT
    assert geo.shared_bytes == 16 + 3 * geo.stage_floats * 4
    assert geo.stage_floats % 4 == 0 and geo.stage_floats >= g * h * w * c + 3
    # two blocks an SM, each with its 1 KB of reserve, fit an SM's shared memory
    assert geo.blocks == min(b // g, 2 * H100_SMS)
    assert 2 * (geo.shared_bytes + 1024) <= cuda_ops.SM_SHARED_MEMORY


@pytest.mark.parametrize("batch", [12, 9, 6, 6144])
def test_k6p_grid_has_no_more_blocks_than_groups(batch):
    g = tc.packed_group(batch, 42)
    geo = cuda_ops.elastic_packed_geometry(batch, g, 32, 32, 3, H100_SMS)
    assert 1 <= geo.blocks <= batch // g


def test_k6p_geometry_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        cuda_ops.elastic_packed_geometry(8, 2, 128, 128, 3, H100_SMS)
    with pytest.raises(ValueError):
        cuda_ops.elastic_packed_geometry(7, 2, 32, 32, 3, H100_SMS)


@pytest.mark.parametrize("g,h,w,threads", [(3, 32, 32, 512), (2, 32, 32, 512), (3, 5, 7, 64), (2, 40, 3, 96)])
def test_k6p_thread_steps_cover_a_group_once(g, h, w, threads):
    """Each thread's (image, row, column), started at its index and stepped
    by the block's width without division, is the pixel it stands on."""
    hw = h * w
    t = np.arange(threads)
    s, i, j = t // hw, (t % hw) // w, t % w
    ds, di, dj = threads // hw, (threads % hw) // w, threads % w
    seen = np.zeros(g * hw, np.int64)
    for q0 in range(0, g * hw, threads):
        q = q0 + t
        ok = q < g * hw
        np.testing.assert_array_equal((s * hw + i * w + j)[ok], q[ok])
        np.add.at(seen, q[ok], 1)
        j, i, s = j + dj, i + di, s + ds
        i, j = np.where(j >= w, i + 1, i), np.where(j >= w, j - w, j)
        s, i = np.where(i >= h, s + 1, s), np.where(i >= h, i - h, i)
    assert (seen == 1).all()
