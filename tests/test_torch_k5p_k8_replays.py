"""K5p's packed-coordinate chase and K8's register-held groups, replayed on the CPU.

* K5p (``csrc/glass.cu``): one block a group of G images. Each thread
  chases its pixels q = t, t + T, ... (T = ``kPackedThreads``), stepping
  from pixel to pixel by fixed image, row and column increments, back
  through the passes: a row pass clamps i, a column pass takes the TPU
  kernel's clipped step j += clip(code - m, -j, W - 1 - j)
  (``corruptions_pallas.py:346-355``). The sources go into a table, and
  the group's output is written in device order, a head up to the first
  16-byte boundary, float4s, a tail. A numpy replay of that map, walk and
  write equals ``glass_resample_packed_from_uniforms`` (the plain K5p) and
  ``glass_resample_from_uniforms`` (the plain K5) exactly, and its table
  equals the one K5's clamped column step gives; fed the codes the TPU
  kernel sees in interpret mode (every offset -m) it equals
  ``glass_resample_pallas(..., packed=True, interpret=True)``, where the
  reference is defined (ROADMAP Queue 3: ``_shift1`` needs an axis at
  least m long).
* K8 (``csrc/corruptions.cu``): one block an image; thread t holds the
  image's Philox groups t, t + T, ... A replay of that geometry visits
  every element once, takes the float4 path only for a group inside the
  image on an aligned base, gives a group that straddles two images the
  flat stream's words, and the threads ``corrupt_normalize_geometry``
  picks cover the groups within the kernel's limits. A float32 replay of
  its arithmetic (per-thread sums, the warp's xor-shuffle tree, the warp
  sums added in order, the formula in the plain version's order), given
  the normals, lies within 1e-6 of ``corrupt_normalize_from_normal``: the
  mean is summed in another order.
* K5p's shared memory (``glass_packed_shared_bytes``) fits two blocks an
  SM at every severity at the main path's shape and refuses a group past
  what a Hopper block can have.
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
from fav_tpu_torch.ops.random import philox4x32, random_words, seed_key

CSRC = Path(cuda_ops.__file__).parent / "csrc"
SEVERITIES = (1, 2, 3, 4, 5)


def _constant(name: str, source: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text()).group(1))


K5P_THREADS = _constant("kPackedThreads", "glass.cu")
K8_MAX_GROUPS = _constant("kNormGroups", "corruptions.cu")

# B <= 16, one shape for each G: packed_group(B, W) = 4, 3 (4 lowered to a
# divisor of 6), 2, 6, and 4 again with H W = 1023, so Philox groups
# straddle the images of a group
PACKED_SHAPES = [(4, 32, 32, 3), (6, 32, 32, 3), (2, 5, 64, 3), (6, 7, 21, 3), (12, 33, 31, 3)]


def _uniforms(seed: int, b: int, h: int, w: int, passes: int) -> list[np.ndarray]:
    """Uniforms in (0, 1], as the draws give them, with both ends present."""
    rng = np.random.default_rng(seed)
    us = [(rng.integers(0, 1 << 24, (b, h, w)) + 0.5).astype(np.float32) / np.float32(1 << 24)
          for _ in range(passes)]
    for u in us:
        u.flat[0], u.flat[-1] = np.float32(2.0 ** -25), np.float32(1.0)
    return us


def _chase(codes, n, img, i, j, h, w, m, rounds, packed):
    """K5p's walk back through the passes for arrays of pixels (image
    start img, row i, column j): with ``packed`` the TPU kernel's clipped
    column step, else K5's clamp."""
    for t in reversed(range(rounds)):
        off = codes[2 * t + 1][img + i * w + j] - m
        j = j + np.minimum(np.maximum(off, -j), w - 1 - j) if packed else np.clip(j + off, 0, w - 1)
        off = codes[2 * t][img + i * w + j] - m
        i = np.clip(i + off, 0, h - 1)
    return img + i * w + j


def k5p_replay(x: np.ndarray, us, m: int, g: int, phase: int, packed: bool = True):
    """The kernel on every group of ``x``: its tables and its output,
    whose base lies ``phase`` floats past a 16-byte boundary."""
    b, h, w, c = x.shape
    hw, n = h * w, g * h * w
    d = n * c
    codes = [tc.glass_codes(torch.from_numpy(u), m).numpy().astype(np.int64).reshape(-1) for u in us]
    flat = x.reshape(-1)
    out = np.zeros_like(flat)
    writes = np.zeros(flat.size, np.int64)
    tables = []
    t = np.arange(K5P_THREADS)
    dimg = K5P_THREADS // hw * hw
    di = (K5P_THREADS - dimg) // w
    dj = K5P_THREADS - dimg - di * w
    for grp in range(b // g):
        first = grp * n
        gc = [cd[first:first + n] for cd in codes]
        tile = flat[first * c:(first + n) * c]
        table = np.full(n, -1, np.int64)
        img, i, j = t // hw * hw, (t - t // hw * hw) // w, t % w
        q = t.copy()
        while (q < n).any():
            live = q < n
            # the increments keep each pixel's coordinates, with no division
            np.testing.assert_array_equal(img[live] + i[live] * w + j[live], q[live])
            assert (j < w).all() and (i < h).all()
            assert (table[q[live]] == -1).all()
            table[q[live]] = _chase(gc, n, img[live], i[live], j[live], h, w, m, len(us) // 2, packed)
            img, i, j = img + dimg, i + di, j + dj
            carry = j >= w
            j, i = np.where(carry, j - w, j), np.where(carry, i + 1, i)
            carry = i >= h
            i, img = np.where(carry, i - h, i), np.where(carry, img + hw, img)
            q = q + K5P_THREADS
        assert (table >= 0).all()
        # sources stay in their own image
        np.testing.assert_array_equal(table // hw, np.arange(n) // hw)
        tables.append(table)
        # the write: head floats, float4s (the first element's pixel found
        # once, the next ones by stepping the channel), a tail
        head = min((4 - phase) & 3, d)
        quads = (d - head) >> 2
        e = head + 4 * np.arange(quads)
        assert ((phase + e) % 4 == 0).all()  # each float4 store is 16-byte aligned
        qq, ch = e // c, e % c
        for k in range(4):
            if k:
                ch = ch + 1
                wrap = ch == c
                ch, qq = np.where(wrap, 0, ch), np.where(wrap, qq + 1, qq)
            out[first * c + e + k] = tile[table[qq] * c + ch]
            writes[first * c + e + k] += 1
        rest = np.arange(d - 4 * quads)
        e = np.where(rest < head, rest, 4 * quads + rest)
        out[first * c + e] = tile[table[e // c] * c + e % c]
        writes[first * c + e] += 1
    np.testing.assert_array_equal(writes, 1)
    return out.reshape(x.shape), tables


@pytest.mark.parametrize("phase", [0, 1, 3])
@pytest.mark.parametrize("shape", PACKED_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("severity", SEVERITIES)
def test_k5p_chase_equals_the_packed_and_unpacked_cascades(severity, shape, phase):
    _, m, iters = tc.sev_param(tc.GLASS_SEV, severity)
    b, h, w, c = shape
    g = tc.packed_group(b, w)
    assert g > 1
    x = np.random.default_rng(severity).random(shape, dtype=np.float32)
    us = _uniforms(40 + severity, b, h, w, 2 * iters)
    got, tables = k5p_replay(x, us, m, g, phase)
    ut = [torch.from_numpy(u) for u in us]
    np.testing.assert_array_equal(got, tc.glass_resample_packed_from_uniforms(torch.from_numpy(x), ut, m, g).numpy())
    np.testing.assert_array_equal(got, tc.glass_resample_from_uniforms(torch.from_numpy(x), ut, m).numpy())
    # the clipped column step and K5's clamp give every pixel the same source
    _, k5_tables = k5p_replay(x, us, m, g, phase, packed=False)
    for a, k5 in zip(tables, k5_tables):
        np.testing.assert_array_equal(a, k5)


def test_k5p_replay_covers_the_group_shapes():
    assert sorted({tc.packed_group(s[0], s[2]) for s in PACKED_SHAPES}) == [2, 3, 4, 6]
    assert any(s[1] * s[2] % 4 for s in PACKED_SHAPES)  # Philox groups straddle images


# where the reference is defined: _shift1 (corruptions_pallas.py:262)
# builds a slab of |d| rows or columns, so both axes are at least m long
PALLAS_CASES = [(sev, shape) for sev in SEVERITIES for shape in PACKED_SHAPES[:4]
                if min(shape[1], shape[2]) >= tc.sev_param(tc.GLASS_SEV, sev)[1]]


@pytest.mark.parametrize("severity,shape", PALLAS_CASES,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_k5p_chase_equals_pallas_packed_interpret(severity, shape):
    """``_glass_kernel_packed`` in interpret mode draws zero bits, so every
    offset there is -m; zero uniforms give code 0, the same offset."""
    _, m, iters = tc.sev_param(tc.GLASS_SEV, severity)
    b, h, w, c = shape
    x = np.random.default_rng(50 + severity).random(shape, dtype=np.float32)
    us = [np.zeros((b, h, w), np.float32) for _ in range(2 * iters)]
    got, _ = k5p_replay(x, us, m, tc.packed_group(b, w), phase=0)
    want = cp.glass_resample_pallas(jnp.int32(3), jnp.asarray(x), m, iters, interpret=True, packed=True)
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    assert not np.array_equal(got, x)


def test_k5p_pallas_cases_cover_every_severity():
    assert {sev for sev, _ in PALLAS_CASES} == set(SEVERITIES)


@pytest.mark.parametrize("severity", SEVERITIES)
def test_k5p_shared_memory_fits_two_blocks_an_sm_at_every_severity(severity):
    _, _, iters = tc.sev_param(tc.GLASS_SEV, severity)
    passes = 2 * iters
    need = cuda_ops.glass_packed_shared_bytes(4, 32, 32, 3, passes)
    # the barrier, the group's tile at its 16-byte phase, a code byte a
    # pixel a pass and a 16-bit source a pixel; no output tile
    assert need == 16 + 12292 * 4 + passes * 4096 + 2 * 4096
    assert cuda_ops.SHARED_MEMORY_LIMIT < need <= cuda_ops.OPT_IN_SHARED_MEMORY_LIMIT  # the launcher opts in
    assert cuda_ops.SM_SHARED_MEMORY // (need + 1024) >= 2  # blocks an SM holds


@pytest.mark.parametrize("shape,g", [((33, 31, 3), 4), ((32, 32, 3), 3), ((5, 64, 3), 2), ((7, 21, 3), 6)])
def test_k5p_shared_memory_at_the_odd_shapes(shape, g):
    h, w, c = shape
    n = g * h * w
    need = cuda_ops.glass_packed_shared_bytes(g, h, w, c, 6)
    assert need == 16 + (n * c + 6) // 4 * 4 * 4 + (6 * n + 15) // 16 * 16 + 2 * n
    assert need <= cuda_ops.OPT_IN_SHARED_MEMORY_LIMIT


def test_k5p_refuses_a_group_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        cuda_ops.glass_packed_shared_bytes(4, 96, 32, 3, 6)


def test_k5p_blocks_have_the_bulk_copy_threads():
    """bulk_copy.cuh copies a tile's head and tail with threads 1-6."""
    assert K5P_THREADS >= 7


# ── K8 ────────────────────────────────────────────────────────────────────

K8_DS = [1, 2, 3, 5, 7, 35, 3069, 3072, 3074, 11263, cuda_ops.PHOTOMETRIC_MAX_D]


def _span_groups(base: int, d: int) -> int:
    return (base + d - 1) // 4 - base // 4 + 1


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("d", K8_DS)
def test_k8_geometry_covers_every_image_within_the_limits(d, noise):
    geo = cuda_ops.corrupt_normalize_geometry(d, noise)
    most = max(_span_groups(img * d, d) for img in range(4))  # image bases take every residue mod 4 there is
    assert most <= ((d + 2) // 4 + 1 if d % 4 else d // 4)  # the launcher's bound
    assert geo.threads % 32 == 0 and 32 <= geo.threads <= 1024
    assert geo.threads * geo.groups_per_thread >= most
    assert geo.groups_per_thread <= cuda_ops.K8_GROUPS[noise] <= K8_MAX_GROUPS
    assert geo.threads * K8_MAX_GROUPS >= most
    # no whole warp is left idle
    assert geo.threads - 32 < -(-most // cuda_ops.K8_GROUPS[noise])


@pytest.mark.parametrize("d", [0, cuda_ops.PHOTOMETRIC_MAX_D + 1])
def test_k8_geometry_refuses_images_outside_its_range(d):
    with pytest.raises(ValueError, match="corrupt_normalize"):
        cuda_ops.corrupt_normalize_geometry(d, False)


def test_k8_groups_are_the_kernels():
    assert max(cuda_ops.K8_GROUPS.values()) == K8_MAX_GROUPS


def k8_groups(b: int, d: int, threads: int):
    """For each image, each thread's groups in the kernel's order:
    (image, thread, r, group)."""
    for img in range(b):
        base = img * d
        g_first = base // 4
        ng = (base + d - 1) // 4 - g_first + 1
        assert ng <= threads * K8_MAX_GROUPS
        for r in range(K8_MAX_GROUPS):
            for t in range(threads):
                k = t + r * threads
                if k < ng:
                    yield img, t, r, g_first + k


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "base_off_16"])
@pytest.mark.parametrize("shape", [(7, 33, 31, 3), (3, 32, 32, 3), (5, 1, 5, 1), (4, 3, 3, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_k8_geometry_visits_each_element_once(shape, offset):
    """``offset``: floats from the base to the 16-byte boundary before it."""
    b = shape[0]
    d = int(np.prod(shape[1:]))
    n = b * d
    seed = 99
    words = [random_words(seed, n, draw).numpy() for draw in (0, 1)]
    vec = offset == 0  # the launcher's aligned16
    visits = np.zeros(n, np.int64)
    quads = straddling = 0
    for noise in (False, True):
        geo = cuda_ops.corrupt_normalize_geometry(d, noise)
        visits[:] = 0
        for img, _, _, g in k8_groups(b, d, geo.threads):
            base, end = img * d, (img + 1) * d
            e = 4 * g + np.arange(4)
            inside = (e >= base) & (e < end)
            whole = bool(inside.all())
            if vec and whole:  # the float4 path: legal where the group is whole and 16-byte aligned
                assert (offset + 4 * g) % 4 == 0
                quads += 1
            visits[e[inside]] += 1
            if not whole:
                straddling += 1
                # the kernel draws group g, word j for element 4 g + j: the flat stream's
                counter = tuple(torch.tensor([v], dtype=torch.int64) for v in (g & 0xFFFFFFFF, g >> 32, 0, 0))
                for draw in (0, 1):
                    got = philox4x32(counter[:2] + (torch.tensor([draw]), counter[3]), seed_key(seed))
                    for j in np.flatnonzero(inside):
                        assert int(got[j]) == int(words[draw][e[j]])
        np.testing.assert_array_equal(visits, 1)
    if d % 4:
        assert straddling > 0
    assert (quads > 0) == (vec and d >= 4)


def k8_replay(x: np.ndarray, z, sigma, bright, contrast, mean, scale, threads: int) -> np.ndarray:
    """K8's arithmetic in float32 on (B, d) images given the normals z."""
    f = np.float32
    b, d = x.shape
    flat = x.reshape(-1)
    out = np.zeros_like(flat)
    sums = np.zeros((b, threads), np.float32)
    for img, t, _, g in k8_groups(b, d, threads):
        for j in range(4):
            e = 4 * g + j
            v = flat[e] if img * d <= e < (img + 1) * d else f(0.0)
            sums[img, t] = f(sums[img, t] + v)
    lanes = np.arange(32)
    for img in range(b):
        s = sums[img].reshape(-1, 32)
        for off in (16, 8, 4, 2, 1):  # __shfl_xor_sync
            s = (s + s[:, lanes ^ off]).astype(np.float32)
        total = f(0.0)
        for wsum in s[:, 0]:
            total = f(total + wsum)
        mu = f(total / f(d))
        v = flat[img * d:(img + 1) * d]
        y = ((v - mu) * f(contrast) + mu) + f(bright)
        if sigma > 0.0:
            y = y + f(sigma) * z.reshape(b, d)[img]
        out[img * d:(img + 1) * d] = (np.clip(y, f(0.0), f(1.0)) - f(mean)) * f(scale)
    return out.reshape(x.shape)


@pytest.mark.parametrize("sigma", [0.0, 0.18])
@pytest.mark.parametrize("shape", [(7, 33, 31, 3), (4, 32, 32, 3), (3, 5, 7, 1)], ids=lambda s: "x".join(map(str, s)))
def test_k8_arithmetic_equals_the_formula_given_its_normals(shape, sigma):
    rng = np.random.default_rng(len(shape) + shape[1])
    x = rng.random(shape, dtype=np.float32)
    z = rng.standard_normal(shape).astype(np.float32)
    consts = dict(bright=0.1, contrast=0.5, mean=0.5, scale=2.0)
    b = shape[0]
    d = x.size // b
    geo = cuda_ops.corrupt_normalize_geometry(d, sigma > 0.0)
    got = k8_replay(x.reshape(b, d), z, sigma, threads=geo.threads, **consts).reshape(shape)
    want = tc.corrupt_normalize_from_normal(torch.from_numpy(x), torch.from_numpy(z) if sigma else None, sigma,
                                            consts["bright"], consts["contrast"], consts["mean"], consts["scale"])
    np.testing.assert_allclose(got, want.numpy(), atol=1e-6, rtol=0)
