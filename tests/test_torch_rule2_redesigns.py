"""The redesigned K1 (gaussian noise), bf16 K9a (the AugMix rows shear on
bfloat16 images) and K9b (the columns shear, ``shear_cols_staged_kernel``),
checked on the CPU where their CUDA kernels cannot run.

* bf16 K9a's units come from ``augment_cuda.shear_rows_bf16_geometry``:
  every value of every row is written by exactly one unit, the stages fit
  and the grid is within the card's limits. A numpy replay of the kernel's
  unit, stage, pixel walk and 16-byte write-out (``csrc/shear.cu``,
  ``shear_rows_bf16_kernel``), its arithmetic in torch's bfloat16 on the
  CPU, equals ``ops/augment.py:shift_rows`` bit for bit, with the input
  and the output at several 16-byte phases (and each unit's span at its
  own).
* bf16 K9b's units come from ``augment_cuda.shear_cols_geometry``: whole
  images, or the direct kernel for an image that does not fit a stage.
  Every value of every image is written once, the stage fits, the grid is
  within the card's limits, and a replay of the kernel's units, stage,
  column runs and stores (vectorised over the units and threads), its
  arithmetic in torch's bfloat16, equals ``ops/augment.py:shift_cols``
  bit for bit.
* ``tools/sass_count.py`` reads loops and their shortest paths out of
  ``cuobjdump -sass`` text.

No JAX forward runs here: the plain versions are held to ``fav_tpu`` in
``test_torch_corruptions.py`` and ``test_torch_augment.py``.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fav_tpu_torch.ops import augment as aug
from fav_tpu_torch.ops import augment_cuda, corruptions_cuda
from fav_tpu_torch.tools import sass_count

CSRC = Path(corruptions_cuda.__file__).resolve().parent / "csrc"
H100_SMS = 132


# ── bf16 K9a: the geometry ──────────────────────────────────────────────────

SHAPES = [
    (768, 32, 32, 3),  # an AugMix view's chain batch
    (6144, 32, 32, 3),
    (7, 33, 31, 3),
    (1, 1, 1, 1),
    (3, 5, 1, 3),  # W = 1
    (2, 3, 7, 1),  # W C odd
    (5, 4, 33, 5),
    (70000, 1, 2, 3),  # a batch above 65535
    (66000, 2, 3, 1),
    (1, 1, 2728, 3),  # the longest whole row: 8184 values
    (1, 2, 2731, 3),  # windows: 8193 values
    (4, 16, 5000, 3),
    (2, 2, 9000, 1),
    (1, 1, 3000, 4),
    (1, 1, 5, 3000),  # windows of one pixel
]


def _units(geo: augment_cuda.RowsGeometry, b: int, h: int, w: int):
    """(first row, rows, first pixel, pixels) of every unit, as the kernel
    derives them from blockIdx.x."""
    rows = b * h
    for u in range(geo.units):
        if geo.window == 0:
            r0 = u * geo.rows_per_block
            yield r0, min(geo.rows_per_block, rows - r0), 0, w
        else:
            r0 = u // geo.windows_per_row
            x0 = (u - r0 * geo.windows_per_row) * geo.window
            yield r0, 1, x0, min(geo.window, w - x0)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_rows_geometry_covers_every_value_once(shape):
    b, h, w, c = shape
    geo = augment_cuda.shear_rows_bf16_geometry(b, h, w, c, H100_SMS)
    rows, row_len = b * h, w * c
    assert 1 <= geo.units <= 2**31 - 1
    assert 1 <= geo.rows_per_block <= augment_cuda.ROWS_MAX
    assert geo.shared_bytes <= corruptions_cuda.SHARED_MEMORY_LIMIT <= corruptions_cuda.OPT_IN_SHARED_MEMORY_LIMIT
    assert geo.in_stage % 8 == 0 and geo.out_stage % 8 == 0
    assert geo.shared_bytes == 16 * geo.rows_per_block + 2 * (geo.in_stage + geo.out_stage)
    assert max(geo.in_stage, geo.out_stage) <= augment_cuda.ROWS_STAGE
    if geo.window == 0:
        assert geo.windows_per_row == 0
        assert geo.rows_per_block * row_len + 7 <= geo.in_stage
    else:
        assert geo.rows_per_block == 1 and 1 <= geo.window < w
        assert geo.windows_per_row == -(-w // geo.window)
        assert (geo.window + 1) * c + 7 <= geo.in_stage
    # per row: the pixels the units write, each once
    if rows * w <= 2_000_000:
        seen = np.zeros((rows, w), dtype=np.int32)
        for r0, nr, x0, npx in _units(geo, b, h, w):
            assert nr >= 1 and npx >= 1
            seen[r0:r0 + nr, x0:x0 + npx] += 1
        assert (seen == 1).all()
    else:
        covered = sum(nr * npx for _, nr, _, npx in _units(geo, b, h, w))
        last = list(_units(geo, b, h, w))[-1]
        assert covered == rows * w and last[0] + last[1] == rows


def test_rows_geometry_takes_the_chain_batch_in_one_wave():
    """(768, 32, 32, 3): at most ROWS_BLOCKS_PER_SM blocks an SM on 132 SMs,
    their threads and shared memory (and 1 KB each of the runtime's)
    within an SM's 2048 threads and 228 KB."""
    geo = augment_cuda.shear_rows_bf16_geometry(768, 32, 32, 3, H100_SMS)
    assert geo.window == 0 and geo.units <= H100_SMS * augment_cuda.ROWS_BLOCKS_PER_SM
    assert augment_cuda.ROWS_BLOCKS_PER_SM * (geo.shared_bytes + 1024) <= corruptions_cuda.SM_SHARED_MEMORY
    assert augment_cuda.ROWS_BLOCKS_PER_SM * augment_cuda.ROWS_THREADS <= 2048


def test_rows_constants_are_the_kernel_constants():
    src = (CSRC / "shear.cu").read_text()
    for name, value in (("kRowsThreads", augment_cuda.ROWS_THREADS), ("kRowsStage", augment_cuda.ROWS_STAGE),
                        ("kRowsMax", augment_cuda.ROWS_MAX)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert corruptions_cuda.KERNELS["shear_rows_bf16"].argtypes[-3:-1] == [corruptions_cuda._I32] * 2


@pytest.mark.parametrize("shape", [(1, 1, 5, 4093), (1, 1, 1, 9000), (0, 1, 1, 1), (1, 1, 0, 3),
                                   (2**41, 1, 1, 1), (2**30, 1, 9000, 1)],
                         ids=["pixel-past-stage", "one-pixel-past-stage", "no-images", "no-columns",
                              "too-many-row-blocks", "too-many-windows"])
def test_rows_geometry_raises_where_the_kernel_cannot_go(shape):
    with pytest.raises(ValueError, match="shear_rows"):
        augment_cuda.shear_rows_bf16_geometry(*shape, H100_SMS)


# ── bf16 K9a: the kernel replayed ───────────────────────────────────────────

def _bf16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).float()


def replay_rows_bf16(x: torch.Tensor, delta: torch.Tensor, m: int, phase_in: int, phase_out: int,
                     geo: augment_cuda.RowsGeometry) -> torch.Tensor:
    """bf16 K9a's block loop on the CPU, x's first value at 16-byte phase
    ``phase_in`` (in values) and the output's at ``phase_out``."""
    b, h, w, c = x.shape
    row_len = w * c
    threads = augment_cuda.ROWS_THREADS
    xf = x.reshape(-1).float()
    out = torch.full((b * h * row_len,), float("nan"))
    written = torch.zeros(b * h * row_len, dtype=torch.int32)
    for r0, nr, x0, npx in _units(geo, b, h, w):
        d = delta.reshape(-1)[r0:r0 + nr].clamp(-m, m - 1)
        lo = torch.floor(d)
        f = _bf16(d - lo)
        g = _bf16(1.0 - f)
        lo = lo.long()
        if geo.window == 0:
            a, in_len = 0, nr * row_len
        else:
            s0 = min(max(x0 + int(lo[0]), 0), w - 1)
            s1 = min(max(x0 + npx + int(lo[0]), 0), w - 1)
            a, in_len = s0 * c, (s1 - s0 + 1) * c
        src = r0 * row_len + a
        pad = (phase_in + src) % 8
        assert pad + in_len <= geo.in_stage
        stage = torch.full((geo.in_stage,), float("nan"))
        stage[pad:pad + in_len] = xf[src:src + in_len]
        dst = r0 * row_len + x0 * c
        opad = (phase_out + dst) % 8
        n_pix = nr * npx
        assert opad + n_pix * c <= geo.out_stage
        sout = torch.full((geo.out_stage,), float("nan"))
        tid = torch.arange(threads)
        q = tid.clone()
        rl, xq = tid // npx, tid % npx
        step_r, step_x = threads // npx, threads - (threads // npx) * npx
        while bool((q < n_pix).any()):
            act = q < n_pix
            qa, ra, xa = q[act], rl[act], xq[act]
            assert torch.equal(ra, qa // npx) and torch.equal(xa, qa % npx)
            xp = x0 + xa
            row = pad - a + ra * row_len
            p0 = (xp + lo[ra]).clamp(0, w - 1)
            p1 = (xp + lo[ra] + 1).clamp(0, w - 1)
            for ch in range(c):
                i0, i1 = row + p0 * c + ch, row + p1 * c + ch
                assert int(i0.min()) >= pad and int(i1.max()) < pad + in_len
                pa = _bf16(g[ra] * stage[i0])
                pb = _bf16(f[ra] * stage[i1])
                sout[opad + qa * c + ch] = _bf16(pa + pb)
            q += threads
            rl += step_r
            xq += step_x
            wrap = xq >= npx
            xq[wrap] -= npx
            rl[wrap] += 1
        out_len = n_pix * c
        ohead = min((8 - opad) % 8, out_len)
        obody = (out_len - ohead) // 8
        if obody:
            assert (opad + ohead) % 8 == 0 and (phase_out + dst + ohead) % 8 == 0
        out[dst:dst + out_len] = sout[opad:opad + out_len]
        written[dst:dst + out_len] += 1
    assert bool((written == 1).all())
    return out.to(torch.bfloat16).view(b, h, w, c)


REPLAY = [
    ((7, 33, 31, 3), (0, 0)),
    ((7, 33, 31, 3), (1, 1)),
    ((7, 33, 31, 3), (3, 6)),
    ((3, 5, 1, 3), (5, 2)),
    ((2, 3, 7, 1), (7, 7)),
    ((5, 4, 33, 5), (2, 0)),
    ((12, 32, 32, 3), (0, 0)),
    ((1, 2, 2731, 3), (0, 0)),
    ((1, 2, 2731, 3), (1, 4)),
    ((2, 1, 3000, 4), (6, 1)),
    ((1, 1, 5, 3000), (1, 1)),
]


@pytest.mark.parametrize("shape,phases", REPLAY, ids=lambda v: "x".join(map(str, v)))
def test_rows_kernel_replay_equals_shift_rows(shape, phases):
    b, h, w, c = shape
    gen = torch.Generator().manual_seed(b * 1000 + w + sum(phases))
    x = torch.rand(shape, generator=gen).to(torch.bfloat16)
    m = aug.shift_bounds(h, w)[0]
    delta = (torch.rand((b, h), generator=gen) * 2 - 1) * (m + 2)
    # a few rows exactly on integers and at the clip limits
    delta.view(-1)[:4] = torch.tensor([0.0, float(-m), float(m - 1), 2.0])[: delta.numel()]
    geo = augment_cuda.shear_rows_bf16_geometry(b, h, w, c, H100_SMS)
    got = replay_rows_bf16(x, delta, m, *phases, geo=geo)
    assert torch.equal(got, aug.shift_rows(x, delta, m))


def test_rows_kernel_replay_at_small_row_blocks():
    """A geometry of few rows a block (what a card with few SMs picks):
    units of several rows whose spans start at every phase."""
    b, h, w, c = 9, 7, 5, 3
    gen = torch.Generator().manual_seed(7)
    x = torch.rand((b, h, w, c), generator=gen).to(torch.bfloat16)
    m = aug.shift_bounds(h, w)[0]
    delta = (torch.rand((b, h), generator=gen) * 2 - 1) * (m + 2)
    geo = augment_cuda.shear_rows_bf16_geometry(b, h, w, c, 1)
    assert geo.rows_per_block > 1 and geo.units > 1
    assert torch.equal(replay_rows_bf16(x, delta, m, 3, 5, geo), aug.shift_rows(x, delta, m))


# ── K9b: the geometry ───────────────────────────────────────────────────────

COLS_SHAPES = [
    (768, 32, 32, 3),  # an AugMix view's chain batch
    (6144, 32, 32, 3),
    (7, 33, 31, 3),
    (1, 1, 1, 1),
    (3, 5, 1, 3),  # W = 1
    (2, 3, 7, 1),  # W C odd
    (5, 4, 33, 5),
    (70000, 1, 2, 3),  # a batch above 65535
    (66000, 2, 3, 1),
    (1, 1, 1025, 1),  # W past the shift table: the direct kernel
    (1, 45, 60, 3),  # 8100 values: whole, the stage nearly full
    (4, 16, 5000, 3),  # a wide image: the direct kernel
    (2, 512, 20, 3),  # past the stage: the direct kernel
    (4, 5000, 16, 3),  # a tall image: the direct kernel
    (2, 8192, 1, 1),
]


def _cols_units(geo: augment_cuda.ColsGeometry, b: int):
    """(first image, images) of every unit, as the kernel derives them from
    blockIdx.x."""
    for u in range(geo.units):
        b0 = u * geo.images_per_block
        yield b0, min(geo.images_per_block, b - b0)


@pytest.mark.parametrize("shape", COLS_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cols_geometry_covers_every_value_once(shape):
    b, h, w, c = shape
    geo = augment_cuda.shear_cols_geometry(b, h, w, c, H100_SMS)
    vec, stage_max = 8, augment_cuda.COLS_STAGE  # bf16 values in 16 bytes, in a stage
    assert 1 <= geo.units <= 2**31 - 1
    if geo.route == "direct":
        # an image (and its phase) past a stage, or W past the shift table:
        # blocks of 256 pixels an image along x, the images along y
        assert h * w * c + vec - 1 > stage_max or w > augment_cuda.COLS_MAX
        assert geo == augment_cuda.ColsGeometry(0, -(-(h * w) // 256), 0, 0)
        return
    assert geo.stage % vec == 0 and geo.stage <= stage_max
    shifts = geo.images_per_block * w
    assert 1 <= shifts <= augment_cuda.COLS_MAX
    assert geo.shared_bytes == 16 * shifts + 2 * geo.stage <= corruptions_cuda.SHARED_MEMORY_LIMIT
    assert geo.images_per_block * h * w * c + vec - 1 <= geo.stage
    # every image (all its rows and columns) in exactly one unit
    seen = np.zeros(b, dtype=np.int32)
    for b0, ni in _cols_units(geo, b):
        assert ni >= 1
        seen[b0:b0 + ni] += 1
    assert (seen == 1).all()


def test_cols_geometry_routes():
    """Which unit each named shape takes."""
    def route(shape):
        return augment_cuda.shear_cols_geometry(*shape, H100_SMS).route
    assert route((768, 32, 32, 3)) == route((1, 45, 60, 3)) == "images"
    assert route((4, 16, 5000, 3)) == route((1, 1, 1025, 1)) == route((4, 5000, 16, 3)) == "direct"
    # the largest image that still fits a stage whole, with its phase
    geo = augment_cuda.shear_cols_geometry(1, 1, 1, augment_cuda.COLS_STAGE - 7, H100_SMS)
    assert geo.route == "images" and geo.stage == augment_cuda.COLS_STAGE
    assert route((1, 1, 1, augment_cuda.COLS_STAGE - 6)) == "direct"


def test_cols_geometry_takes_the_chain_batch_in_one_wave():
    """(768, 32, 32, 3) in bfloat16: two images a block, at most
    COLS_BLOCKS_PER_SM blocks an SM on 132 SMs, their threads and shared
    memory (and 1 KB each of the runtime's) within an SM's 2048 threads and
    228 KB."""
    geo = augment_cuda.shear_cols_geometry(768, 32, 32, 3, H100_SMS)
    assert geo.route == "images" and geo.images_per_block == 2 and geo.units == 384
    assert geo.units <= H100_SMS * augment_cuda.COLS_BLOCKS_PER_SM
    assert augment_cuda.COLS_BLOCKS_PER_SM * (geo.shared_bytes + 1024) <= corruptions_cuda.SM_SHARED_MEMORY
    assert augment_cuda.COLS_BLOCKS_PER_SM * augment_cuda.COLS_THREADS <= 2048


def test_cols_constants_are_the_kernel_constants():
    src = (CSRC / "shear.cu").read_text()
    for name, value in (("kColsThreads", augment_cuda.COLS_THREADS),
                        ("kColsStage", augment_cuda.COLS_STAGE), ("kColsMax", augment_cuda.COLS_MAX)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    # bf16 K9b takes the unit (images a block, 0 for the direct kernel);
    # float32 K9b stays on the direct kernel's launcher
    bf16 = corruptions_cuda.KERNELS["shear_cols_bf16"].argtypes
    assert len(bf16) == 10 and bf16[-2] == corruptions_cuda._I32
    assert len(corruptions_cuda.KERNELS["shear_cols"].argtypes) == 9
    # the direct kernel's blocks are the 256 pixels the geometry counts
    assert re.search(r"constexpr int kThreads = 256;", src)


@pytest.mark.parametrize("shape", [(0, 1, 1, 1), (1, 0, 1, 3), (1, 1, 0, 3), (1, 2**16, 2**16, 1),
                                   (2**41, 1, 1, 1), (2**31, 5000, 16, 3)],
                         ids=["no-images", "no-rows", "no-columns", "image-past-32-bit", "batch-past-32-bit",
                              "tall-batch-past-32-bit"])
def test_cols_geometry_raises_where_no_kernel_can_go(shape):
    with pytest.raises(ValueError, match="shear_cols"):
        augment_cuda.shear_cols_geometry(*shape, H100_SMS)


# ── K9b: the kernel replayed ────────────────────────────────────────────────

def _blend(f, g, a, b):
    """The plain version's blend in bfloat16's roundings."""
    return _bf16(_bf16(g * a) + _bf16(f * b))


def replay_cols(x: torch.Tensor, delta: torch.Tensor, m: int, phase_in: int,
                geo: augment_cuda.ColsGeometry) -> torch.Tensor:
    """bf16 K9b's blocks on the CPU, all units at once, x's first value at
    16-byte phase ``phase_in`` (in values): the stage fill (the unit's span
    at its phase), the kernel's walk (a run of rows of one column a thread,
    the lower tap carried from the row before and checked against the
    stage), the blend, and each pixel's store (every output element written
    once)."""
    b, h, w, c = x.shape
    vec = 8  # bf16 values in 16 bytes
    wc, hwc = w * c, h * w * c
    threads = augment_cuda.COLS_THREADS
    xf = x.reshape(-1).float()
    units = list(_cols_units(geo, b))
    n_units = len(units)
    b0 = torch.tensor([u[0] for u in units])
    ni = torch.tensor([u[1] for u in units])
    src = dst = b0 * hwc  # the unit's first value in x and in the output
    pad = (phase_in + src) % vec
    # 1. the input stages and the shift tables
    stage = torch.full((n_units, geo.stage), float("nan"))
    n_shift = geo.images_per_block * w
    lo = torch.zeros((n_units, n_shift), dtype=torch.long)
    f = torch.zeros((n_units, n_shift))
    g = torch.zeros((n_units, n_shift))
    for u, (ub0, uni) in enumerate(units):
        s0, p0 = int(src[u]), int(pad[u])
        assert p0 + uni * hwc <= geo.stage
        stage[u, p0:p0 + uni * hwc] = xf[s0:s0 + uni * hwc]
        d = delta[ub0:ub0 + uni].reshape(-1).clamp(-m, m - 1)
        dlo = torch.floor(d)
        fu = _bf16(d - dlo)
        lo[u, :d.numel()] = dlo.long()
        f[u, :d.numel()] = fu
        g[u, :d.numel()] = _bf16(1.0 - fu)
    # 2. the walk: thread k of a unit takes run grp = k // ncols of column
    # col = k % ncols (image col // W, column col % W), `run` rows, the
    # lower tap carried from the row before
    ncols = (ni * w).view(-1, 1)
    groups = torch.clamp(threads // ncols, min=1)
    run = -(-h // groups)
    out = torch.full((b * hwc,), float("nan"))
    written = torch.zeros(b * hwc, dtype=torch.int32)
    units_ = torch.arange(n_units).view(-1, 1)
    pad_, dst_ = pad.view(-1, 1), dst.view(-1, 1)

    k = torch.arange(threads).view(1, -1).expand(n_units, threads)
    while bool((k < groups * ncols).any()):
        grp, col = k // ncols, k % ncols
        i, xq = col // w, col % w
        live = k < groups * ncols
        in0 = pad_ + i * hwc + xq * c
        out0 = dst_ + i * hwc + xq * c
        slo = lo[units_, col]
        sf, sg = f[units_, col], g[units_, col]
        y = grp * run
        y_end = torch.minimum(torch.full_like(y, h), (grp + 1) * run)
        a = [stage[units_, in0 + (y + slo).clamp(0, h - 1) * wc + ch] for ch in range(c)]
        for _ in range(int(run.max())):
            act = live & (y < y_end)
            if not bool(act.any()):
                break
            r = units_.expand(n_units, threads)[act]
            r0 = (y + slo).clamp(0, h - 1)
            r1 = (y + slo + 1).clamp(0, h - 1)
            t1 = in0 + r1 * wc
            o = out0 + y * wc
            for ch in range(c):
                # the carried tap is the staged lower tap of this row
                assert torch.equal(a[ch][act], stage[r, (in0 + r0 * wc)[act] + ch])
                bb = stage[units_, t1 + ch]
                assert not bool(a[ch][act].isnan().any() or bb[act].isnan().any()), "a tap outside the stage"
                out[o[act] + ch] = _blend(sf[act], sg[act], a[ch][act], bb[act])
                written[o[act] + ch] += 1
                a[ch] = bb
            y = y + 1
        k = k + threads
    assert bool((written == 1).all())
    return out.to(torch.bfloat16).view(b, h, w, c)


def replay_cols_direct(x: torch.Tensor, delta: torch.Tensor, m: int) -> torch.Tensor:
    """``shear_kernel<__nv_bfloat16, false>``: a thread a pixel p of an
    image, its two taps at rows clamp(p / W + lo) and clamp(p / W + lo + 1)
    of column p % W."""
    b, h, w, c = x.shape
    p = torch.arange(h * w)
    yi, xi = p // w, p % w
    d = delta.clamp(-m, m - 1)
    lo = torch.floor(d)
    f = _bf16(d - lo)[:, xi]
    lo = lo.long()[:, xi]
    g = _bf16(1.0 - f)
    flat = x.reshape(b, h * w, c).float()
    p0 = (yi + lo).clamp(0, h - 1) * w + xi
    p1 = (yi + lo + 1).clamp(0, h - 1) * w + xi
    a = torch.gather(flat, 1, p0.unsqueeze(-1).expand(b, h * w, c))
    bb = torch.gather(flat, 1, p1.unsqueeze(-1).expand(b, h * w, c))
    return _blend(f.unsqueeze(-1), g.unsqueeze(-1), a, bb).to(torch.bfloat16).view(b, h, w, c)


COLS_REPLAY = [
    ((768, 32, 32, 3), 0),  # the chain batch: two images a block
    ((768, 32, 32, 3), 5),
    ((7, 33, 31, 3), 0),
    ((7, 33, 31, 3), 1),
    ((7, 33, 31, 3), 6),
    ((3, 5, 1, 3), 5),  # W = 1
    ((2, 3, 7, 1), 7),  # W C odd
    ((5, 4, 33, 5), 2),
    ((70000, 1, 2, 3), 1),  # a batch above 65535
    ((1, 45, 60, 3), 3),
    ((1, 1, 1025, 1), 7),  # W past the shift table: the direct kernel
    ((4, 16, 5000, 3), 0),  # a wide image: the direct kernel
    ((4, 16, 5000, 3), 4),
    ((2, 512, 20, 3), 1),  # past the stage: the direct kernel
    ((4, 5000, 16, 3), 0),  # a tall image: the direct kernel
]


@pytest.mark.parametrize("shape,phase", COLS_REPLAY, ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_cols_kernel_replay_equals_shift_cols(shape, phase):
    b, h, w, c = shape
    gen = torch.Generator().manual_seed(b * 1000 + w + phase)
    x = torch.rand(shape, generator=gen).to(torch.bfloat16)
    m = aug.shift_bounds(h, w)[1]
    delta = (torch.rand((b, w), generator=gen) * 2 - 1) * (m + 2)
    # a few columns exactly on integers and at the clip limits
    delta.view(-1)[:4] = torch.tensor([0.0, float(-m), float(m - 1), 2.0])[: delta.numel()]
    geo = augment_cuda.shear_cols_geometry(b, h, w, c, H100_SMS)
    got = replay_cols_direct(x, delta, m) if geo.route == "direct" else replay_cols(x, delta, m, phase, geo)
    assert torch.equal(got, aug.shift_cols(x, delta, m))


def test_cols_kernel_replay_at_small_image_blocks():
    """A geometry of few images a block (what a card with few SMs picks
    does the reverse: many), units whose spans start at every phase."""
    b, h, w, c = 9, 7, 5, 3
    gen = torch.Generator().manual_seed(11)
    x = torch.rand((b, h, w, c), generator=gen).to(torch.bfloat16)
    m = aug.shift_bounds(h, w)[1]
    delta = (torch.rand((b, w), generator=gen) * 2 - 1) * (m + 2)
    geo = augment_cuda.shear_cols_geometry(b, h, w, c, 1)
    assert geo.images_per_block > 1 and geo.units > 1
    assert torch.equal(replay_cols(x, delta, m, 3, geo), aug.shift_cols(x, delta, m))


# ── tools/sass_count.py ─────────────────────────────────────────────────────

SASS = """
        Function : _Z6kernelPf
        .headerflags    @"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;             /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R0, SR_TID.X ;                 /* 0x0000000000007919 */
.L_x_1:
        /*0020*/                   IMAD.WIDE.U32 R2, R0, 0x4, R4 ;    /* 0x0000000400027825 */
        /*0030*/              @P0 BRA `(.L_x_0) ;                     /* 0x0000000000000947 */
        /*0040*/                   LOP3.LUT R3, R3, c[0x0][0x210], R2, 0x96, !PT ;
        /*0050*/                   BRA `(.L_x_2) ;
        /*0060*/                   MUFU.LG2 R7, R7 ;
.L_x_2:
        /*0070*/                   FADD R6, R6, 1 ;
.L_x_0:
        /*0080*/                   NOP ;
        /*0090*/              @!P1 BRA `(.L_x_1) ;
        /*00a0*/                   EXIT ;
        Function : _Z5otherv
        /*0000*/                   EXIT ;
"""


# the toolkit on the card prints branch targets as addresses; a sqrtf-like
# detour: the common case skips the CALL of the slow path
SASS_ADDRESSES = """
        Function : _Z4sqrtPf
        /*0000*/                   S2R R0, SR_TID.X ;                 /* 0x0000000000007919 */
        /*0010*/                   MUFU.RSQ R3, R2 ;                  /* 0x0000000000007919 */
        /*0020*/              @!P0 BRA 0x60 ;                          /* 0x0000000000007919 */
        /*0030*/                   FMUL R4, R3, R2 ;
        /*0040*/                   FFMA R5, R4, R4, -R2 ;
        /*0050*/                   BRA 0x80 ;
        /*0060*/                   CALL.REL.NOINC 0xc0 ;
        /*0070*/                   BRA 0x80 ;
        /*0080*/                   IADD3 R0, R0, 0x100, RZ ;
        /*0090*/              @P1 BRA 0x10 ;
        /*00a0*/                   EXIT ;
        /*00b0*/                   BRA 0xb0;
        /*00c0*/                   RET.REL.NODEC R20 0x0 ;
"""


def test_sass_count_takes_the_shortest_path_through_a_loop():
    funcs = sass_count.parse_functions(SASS)
    assert list(funcs) == ["_Z6kernelPf", "_Z5otherv"]
    info = sass_count.count(funcs["_Z6kernelPf"])
    assert info["instructions"] == 10  # the NOP left out
    (loop,) = info["loops"]
    assert (loop["start"], loop["end"]) == (0x20, 0x90)
    assert loop["span"] == 7
    # IMAD, the branch past LOP3 and MUFU to the NOP, the back edge
    assert loop["shortest"] == 3
    assert loop["ops"] == {"BRA": 2, "IMAD": 1}


def test_sass_count_reads_address_targets_and_avoids_calls():
    (name,) = sass_count.parse_functions(SASS_ADDRESSES)
    loops = sass_count.loops(sass_count.parse_functions(SASS_ADDRESSES)[name])
    loop = next(lp for lp in loops if lp["start"] == 0x10)
    assert loop["end"] == 0x90 and loop["span"] == 9
    # MUFU, the branch not taken, FMUL, FFMA, the jump, IADD3, the back edge:
    # seven instructions, though the CALL side is two shorter
    assert loop["shortest"] == 7
    assert "CALL" not in loop["ops"] and loop["ops"]["FFMA"] == 1
