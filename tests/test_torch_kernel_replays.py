"""K2's warp work queue and K5's backward index chase, replayed on the CPU.

* K5 (``csrc/glass.cu``): the kernel resolves the resample cascade into
  one gather by walking the passes backwards through the codes. A replay
  of that walk in plain torch, from the codes ``glass_codes`` makes,
  equals ``glass_resample_from_uniforms`` and the JAX package's own
  ``_resample_axis`` cascade (``corruptions_pallas.py:282``, plain jnp in
  the planar layout) on the same uniforms, exactly: all three are pure
  selection.
* K2 (``csrc/corruptions.cu``): a warp stages a chunk and hands its
  elements to lanes in lane order (``__ballot_sync`` / ``__popc``) as their
  chains end, every ``SHOT_TERMS`` terms. A numpy replay given per-element
  term counts takes every element of a chunk, the ragged last one
  included, exactly once, puts each result at its own index, and needs no
  more hand-outs than a greedy schedule allows. A float32 torch replay of
  the kernel's chain arithmetic (the shifted log k table with -inf past
  k_max, the count recounted from the last block) equals the plain
  ``shot_from_uniform`` exactly on the same draws.
* The geometry the wrappers pick (``shot_geometry``,
  ``glass_shared_bytes``) fits a block's shared memory at every severity,
  launches no more blocks than the chunks need, and its constants are
  the kernels'.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fav_tpu.ops import corruptions_pallas as cp
from fav_tpu_torch.ops import corruptions as tc
from fav_tpu_torch.ops import corruptions_cuda as cuda_ops

CSRC = Path(cuda_ops.__file__).parent / "csrc"
SEVERITIES = (1, 2, 3, 4, 5)
# B <= 16: the megastep's image, odd sizes, a single row, and a size whose
# pixel count is not a multiple of 4 (Philox groups straddle images)
GLASS_SHAPES = [(4, 32, 32, 3), (3, 7, 5, 3), (2, 1, 9, 3), (5, 33, 31, 3)]


def _uniforms(seed: int, b: int, h: int, w: int, passes: int) -> list[np.ndarray]:
    """Uniforms in (0, 1], as the draws give them, with both ends present."""
    rng = np.random.default_rng(seed)
    us = [(rng.integers(0, 1 << 24, (b, h, w)) + 0.5).astype(np.float32) / np.float32(1 << 24)
          for _ in range(passes)]
    for u in us:
        u.flat[0], u.flat[-1] = np.float32(2.0 ** -25), np.float32(1.0)
    return us


def chase(x: torch.Tensor, us, m: int) -> torch.Tensor:
    """K5's walk: each output pixel's source found through the passes in
    reverse, column passes moving j and row passes moving i, then one
    gather of all channels."""
    b, h, w, _ = x.shape
    codes = [tc.glass_codes(u, m).to(torch.int64) for u in us]
    bi = torch.arange(b).view(b, 1, 1).expand(b, h, w)
    i = torch.arange(h).view(1, h, 1).expand(b, h, w)
    j = torch.arange(w).view(1, 1, w).expand(b, h, w)
    for p in reversed(range(len(us))):
        code = codes[p][bi, i, j]
        if p % 2:
            j = torch.clamp(j + code - m, 0, w - 1)
        else:
            i = torch.clamp(i + code - m, 0, h - 1)
    return x[bi, i, j]


@pytest.mark.parametrize("shape", GLASS_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("severity", SEVERITIES)
def test_k5_chase_equals_the_cascade(severity, shape):
    _, m, iters = tc.sev_param(tc.GLASS_SEV, severity)
    b, h, w, c = shape
    x = torch.from_numpy(np.random.default_rng(severity).random(shape, dtype=np.float32))
    us = [torch.from_numpy(u) for u in _uniforms(10 + severity, b, h, w, 2 * iters)]
    np.testing.assert_array_equal(chase(x, us, m).numpy(), tc.glass_resample_from_uniforms(x, us, m).numpy())


# where the reference is defined: its edge-clamped shift (_shift1,
# corruptions_pallas.py:262) builds a slab of |d| rows or columns, so an
# axis shorter than the largest offset m gets the wrong length there
PALLAS_CASES = [(sev, shape) for sev in SEVERITIES for shape in ((2, 32, 32, 3), (3, 7, 5, 3), (2, 4, 9, 3))]
PALLAS_CASES += [(1, (2, 1, 9, 3))]


@pytest.mark.parametrize("severity,shape", PALLAS_CASES, ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_k5_chase_equals_the_pallas_resample_axis_cascade(severity, shape):
    """``_glass_kernel``'s body (``corruptions_pallas.py:310-316``) on the
    same uniforms: ``_resample_axis`` on rows, then columns, ``iters``
    times, in the planar (B, C, H, W) layout, the uniform shared by the
    channels."""
    _, m, iters = tc.sev_param(tc.GLASS_SEV, severity)
    b, h, w, c = shape
    x = np.random.default_rng(severity).random(shape, dtype=np.float32)
    us = _uniforms(20 + severity, b, h, w, 2 * iters)
    planar = jnp.asarray(x).transpose(0, 3, 1, 2)
    for t in range(iters):
        planar = cp._resample_axis(planar, jnp.asarray(us[2 * t])[:, None], m, axis=2)
        planar = cp._resample_axis(planar, jnp.asarray(us[2 * t + 1])[:, None], m, axis=3)
    want = np.asarray(planar).transpose(0, 2, 3, 1)
    got = chase(torch.from_numpy(x), [torch.from_numpy(u) for u in us], m).numpy()
    np.testing.assert_array_equal(got, want)


def queue(blocks: np.ndarray) -> tuple[np.ndarray, int]:
    """K2's hand-out for one chunk, given the blocks of SHOT_TERMS terms
    each element's chain runs: lanes start on elements 0..31; after each
    block the lanes whose chain ended take the next elements in lane order.
    Returns the element each finished chain wrote its result for, in the
    order they finished, and the number of blocks the warp ran."""
    m = len(blocks)
    e = np.arange(32)
    live = e < m
    left = np.where(live, blocks[np.minimum(e, m - 1)], 0)
    written = []
    nxt, steps = 32, 0
    while nxt < m + 32:
        steps += 1
        left[live] -= 1
        ended = live & (left == 0)
        rank = np.cumsum(ended) - ended  # __popc(mask & lanes before)
        written.extend(e[ended].tolist())
        e = np.where(ended, nxt + rank, e)
        live = np.where(ended, e < m, live)
        left = np.where(ended & live, blocks[np.minimum(e, m - 1)], left)
        nxt += int(ended.sum())
    return np.asarray(written), steps


@pytest.mark.parametrize("m", [cuda_ops.SHOT_CHUNK, cuda_ops.SHOT_CHUNK - 1, 37, 32, 1])
@pytest.mark.parametrize("pattern", ["poisson", "ones", "one_long", "k_max"])
def test_k2_queue_takes_each_element_once(m, pattern):
    rng = np.random.default_rng(m)
    terms = {
        "poisson": rng.poisson(rng.random(m) * 12.0) + 1,  # severity 3: count + 1 terms
        "ones": np.ones(m, np.int64),
        "one_long": np.where(np.arange(m) == m // 2, 55, 1),
        "k_max": np.full(m, 55),
    }[pattern]
    blocks = -(-terms // cuda_ops.SHOT_TERMS)
    written, steps = queue(blocks)
    # each element of the chunk, the ragged end included, finishes once, and
    # its result goes to its own index
    np.testing.assert_array_equal(np.sort(written), np.arange(m))
    # a greedy schedule: all lanes busy until the queue is empty, then at
    # most the longest chain
    assert steps <= -(-int(blocks.sum()) // 32) + int(blocks.max())


@pytest.mark.parametrize("n", [1, 3, 515, 2 * cuda_ops.SHOT_CHUNK + 77])
def test_k2_chunks_cover_the_elements_once(n):
    """Chunk j of warp w of block b is chunk b SHOT_WARPS + w; it covers
    elements [SHOT_CHUNK j, min(n, SHOT_CHUNK (j + 1))) in groups of 4, the
    last group ragged where n is not a multiple of 4."""
    geo = cuda_ops.shot_geometry(n, tc.shot_k_max(3))
    covered = np.zeros(n, np.int64)
    for chunk in range(geo.blocks * cuda_ops.SHOT_WARPS):
        first = chunk * cuda_ops.SHOT_CHUNK
        if first >= n:
            continue
        m = min(cuda_ops.SHOT_CHUNK, n - first)
        for q in range(-(-m // 4)):
            covered[first + 4 * q: first + 4 * q + min(4, m - 4 * q)] += 1
    np.testing.assert_array_equal(covered, 1)


def shot_replay(x: torch.Tensor, u: torch.Tensor, c: float, k_max: int) -> torch.Tensor:
    """The kernel's chain arithmetic on whole tensors in float32: a block
    of SHOT_TERMS terms at a time with the shifted table (entry k is log(k
    + 1) below k_max, -inf from there), the count taken as the terms run
    less the last block's terms whose sum u did not exceed; clip(count / c)."""
    t_len = k_max + cuda_ops.SHOT_TERMS
    log_k = tc.shot_log_k(k_max)
    table = torch.tensor([log_k[k + 1] if k + 1 < k_max else float("-inf") for k in range(t_len)],
                         dtype=torch.float32)
    lam = x * c
    log_lam = torch.log(torch.clamp(lam, min=1e-30))
    log_term = -lam
    last = torch.zeros_like(lam)
    k = torch.zeros(lam.shape, dtype=torch.int64)
    live = torch.ones(lam.shape, dtype=torch.bool)
    count = torch.zeros(lam.shape, dtype=torch.int64)
    while bool(live.any()):
        assert int(k[live].max()) + cuda_ops.SHOT_TERMS <= t_len  # the reads stay in the table
        sums = []
        s = last
        for t in range(cuda_ops.SHOT_TERMS):
            s = s + torch.exp(log_term)
            sums.append(s)
            log_term = log_term + log_lam - table[torch.clamp(k + t, max=t_len - 1)]
        k = torch.where(live, k + cuda_ops.SHOT_TERMS, k)
        ended = live & ~(u > s)
        missed = sum((~(u > cs)).to(torch.int64) for cs in sums)
        count = torch.where(ended, k - missed, count)
        live = live & ~ended
        last = s
    return torch.clamp(count.to(torch.float32) / torch.tensor(c, dtype=torch.float32), 0.0, 1.0)


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (3, 7, 5, 3)], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("severity", SEVERITIES)
def test_k2_chain_arithmetic_equals_the_plain_version(severity, shape):
    rng = np.random.default_rng(severity)
    x = rng.random(shape, dtype=np.float32)
    x.flat[:3] = (0.0, 1.0, 0.5)  # lam = 0 (one term), the largest lam
    x = torch.from_numpy(x)
    u = torch.from_numpy(_uniforms(30 + severity, 1, 1, x.numel(), 1)[0].reshape(shape))
    c = tc.sev_param(tc.SHOT_C, severity)
    np.testing.assert_array_equal(shot_replay(x, u, c, tc.shot_k_max(severity)).numpy(),
                                  tc.shot_from_uniform(x, u, severity).numpy())


@pytest.mark.parametrize("k_max", [1, 2, 5, 6])
def test_k2_chain_ends_at_k_max(k_max):
    """Where u exceeds every partial sum below k_max, the -inf entry ends
    the chain with count k_max, as the plain version's bound does."""
    lam = torch.tensor([12.0, 30.0, 0.0, 3.0], dtype=torch.float32)
    u = torch.tensor([0.999, 0.5, 0.25, 1.0], dtype=torch.float32)
    want = tc.poisson_inverse_cdf(lam, u, k_max)
    got = shot_replay(lam, u, 1.0, k_max)  # c = 1: clip(count) compares counts up to 1
    np.testing.assert_array_equal(got.numpy(), torch.clamp(want, 0.0, 1.0).numpy())
    assert float(want[0]) == k_max and float(want[1]) == k_max
    big = shot_replay(lam, u, float(k_max), k_max) * k_max  # clip(count / k_max) undone
    np.testing.assert_array_equal(big.numpy(), want.numpy())


def _constant(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_k2_constants_are_the_kernels():
    src = (CSRC / "corruptions.cu").read_text()
    assert _constant(src, "kShotWarps") == cuda_ops.SHOT_WARPS
    assert 32 * _constant(src, "kShotPerLane") == cuda_ops.SHOT_CHUNK
    assert _constant(src, "kShotTerms") == cuda_ops.SHOT_TERMS
    assert cuda_ops.SHOT_CHUNK % 4 == 0  # a chunk is whole Philox groups and float4 rows


@pytest.mark.parametrize("severity", SEVERITIES)
@pytest.mark.parametrize("n", [6144 * 32 * 32 * 3, 7 * 33 * 31 * 3, 1])
def test_k2_geometry_fits_and_launches_no_more_blocks_than_chunks(severity, n):
    k_max = tc.shot_k_max(severity)
    geo = cuda_ops.shot_geometry(n, k_max)
    per_block = cuda_ops.SHOT_WARPS * cuda_ops.SHOT_CHUNK
    assert (geo.blocks - 1) * per_block < n <= geo.blocks * per_block
    tables = -(-(k_max + cuda_ops.SHOT_TERMS) // 4) * 4 + -(-(k_max + 1) // 4) * 4
    assert geo.shared_bytes == 4 * (tables + cuda_ops.SHOT_WARPS * 3 * cuda_ops.SHOT_CHUNK)
    assert geo.shared_bytes <= cuda_ops.OPT_IN_SHARED_MEMORY_LIMIT
    assert cuda_ops.SM_SHARED_MEMORY // (geo.shared_bytes + 1024) >= 2  # blocks an SM holds


def test_k2_geometry_refuses_no_work():
    with pytest.raises(ValueError):
        cuda_ops.shot_geometry(0, 54)


@pytest.mark.parametrize("severity", SEVERITIES)
def test_k5_shared_memory_fits_at_every_severity(severity):
    _, _, iters = tc.sev_param(tc.GLASS_SEV, severity)
    need = cuda_ops.glass_shared_bytes(32, 32, 3, 2 * iters)
    # two tiles at their 16-byte phase and a code byte a pixel a pass
    assert need == 16 + 2 * 3076 * 4 + 2 * iters * 1024
    assert need <= cuda_ops.SHARED_MEMORY_LIMIT


def test_k5_refuses_an_image_past_shared_memory():
    assert cuda_ops.glass_shared_bytes(64, 64, 3, 6) > cuda_ops.SHARED_MEMORY_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        cuda_ops._shared_memory("glass_resample", cuda_ops.glass_shared_bytes(64, 64, 3, 6),
                                cuda_ops.SHARED_MEMORY_LIMIT, "a 64x64x3 image")


def test_bulk_copy_blocks_have_the_head_and_tail_threads():
    """bulk_copy.cuh copies a tile's head and tail with threads 1-6, so
    every block that uses it has at least 7 threads."""
    assert _constant((CSRC / "glass.cu").read_text(), "kThreads") >= 7
    assert _constant((CSRC / "elastic.cu").read_text(), "kPackedThreads") >= 7
