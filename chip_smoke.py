#!/usr/bin/env python3
"""Drive fav_tpu_torch on one NVIDIA card: build the CUDA kernels, hold each
to its plain PyTorch version, run the fifteen-family detection megastep of
``bench.py``'s cells with the nano student, run the frame-analysis service
on scripted camera streams and the grid's L1 pass into the policy replay,
train the ``classifier`` configuration with AugMix for a few steps, run the
packed A/B of glass and elastic, and report.

    python3 chip_smoke.py             # what the checks run
    python3 chip_smoke.py --profile   # adds torch.profiler tables of one megastep, one analyzer batch
                                      # and one train step

Phases, each printing one ``[chip_smoke]`` line with its elapsed seconds:

1. device   -- exit non-zero at once without CUDA; print the card's name and
               power limit from nvidia-smi; float32 matmuls and convolutions
               in full float32 (TF32 off, printed);
2. build    -- compile ``fav_tpu_torch/ops/csrc`` with plain nvcc for sm_90a
               into ``build/torch_kernels/``, one nvcc per source started
               together (must stay under 60 s);
3. kernels  -- at the megastep's shape (6144, 32, 32, 3) float32, each kernel
               K1-K6 and the Philox helper against its plain version on the
               card, with its time, the plain version's time, its bound and,
               for K6, the time of ``grid_sample`` computing the same warp,
               for K2 of ``torch.poisson`` (the draw only) and for the
               helper of ``torch.rand`` (each beside its output's mean); K2
               at severities 1-5 there and at (7, 33, 31, 3) on a base off
               16 bytes, timed at severities 3 and 1; K5 exact at
               severities 1-5 there, at (7, 33, 31, 3) and at (7, 32, 32, 3)
               on a base off 16 bytes; K5p exact to its plain version and
               to K5 at severities 1-5 there and at (12, 33, 31, 3) and
               (6, 32, 32, 3) on a base off 16 bytes;
               K7 (frame statistics and histogram) at the service's
               (32, 240, 320) and the grid's (6144, 32, 32), exact, beside
               ``torch.bincount``'s time for the histogram part, and exact
               at (3, 241, 317), (5, 2, 2) and (1, 1024, 2048) on a base
               off a 16-byte boundary (flat frames and pixels outside
               0..255 in every shape); K8
               (corrupt-normalize) at sigma 0 and 0.18 at (6144, 32, 32, 3)
               and at (7, 33, 31, 3) on a base off 16 bytes;
               K9a and K9b (the AugMix shear passes) at an AugMix view's
               chain batch (768, 32, 32, 3), m = 18 and 22, exact, beside
               ``grid_sample`` computing the same shear; K5p and K6p (the
               lane-packed glass and elastic kernels) at (6144, 32, 32, 3)
               against their plain versions and against K5 and K6, exact,
               K6p at severities 1-5, at batch 6144 and at batch 12 on a
               base off a 16-byte boundary, beside ``grid_sample``;
4. golden   -- the nano student's bf16 logits on fixed images against the
               JAX package's, committed in ``weights/student_nano.golden.json``;
5. megastep -- one megastep at batch 6144 over all fifteen cells with the
               launch counts reset just before and read just after (K1, K2,
               K3, K5, K6 once each, K4 twice); 2 warm-up and 8 timed
               megasteps; each family's corruption time; then one megastep
               against the same megastep through the plain versions;
6. monitor  -- the analysis service at 240x320, capacity 64, with 32
               scripted streams (8 each OK, frozen, blank, corrupted) for 60
               ticks at 30 Hz, counts reset just before: K7 once per
               dispatched batch; statuses and anomalies against the JAX
               package's golden (``weights/monitor.golden.json``); the same
               frames through a service on the plain versions give the same
               results, and both replay (tiled to 900 ticks) to the same
               policies; the trust goldens; the batched analyzer's frames/s,
               the service's dispatch-to-result latency, the replay's ms;
7. policy   -- the 15 ``BENCH_CELLS`` at batch 6144, severity 3: corrupt,
               ``l1_rows`` (K7), the nano confidence and ``grid_policy`` over
               900 ticks, counts reset just before (K7 15 times); ``l1_rows``
               through K7 equal to ``l1_rows`` through the plain versions;
8. train    -- first the JAX package's float32 AugMix step at widths (8, 16)
               (``weights/train_step.golden.json``: its draws, loss and
               per-leaf sums) reproduced through K9a/K9b; then the
               ``classifier`` configuration (widths 64/128/256, dense 256,
               dropout 0.1, bf16) from ``init_params`` on the synthetic set,
               AugMix with JS 12, batch 256, lr 1e-3: 2 warm-up steps and 20
               timed steps as two megastep chunks of 10, counts reset just
               before (K9a 4 and K9b 2 in the first step, 88 and 44 in all);
               the loss finite and falling; the views bit-equal between the
               kernel and the plain route, one step of each within a stated
               tolerance; ms per step, images/s and the split into
               augmentation, forward+backward and optimizer (CUDA events);
9. packed   -- ``fav_tpu_torch.tools.ab_packed_kernels.run_ab`` at batch
               6144: the kernel arms (glass and elastic at severities 3 and
               5, packed and unpacked, interleaved, median ms), the packed
               and unpacked outputs of each equal bit for bit; the megastep
               arms (``make_megastep(packed=True)`` and ``(packed=False)``),
               one megastep of each from equal generators with the counts
               reset just before (K5p and K6p once in the packed one, K5
               and K6 once in the unpacked one), outputs within the
               megastep tolerance, ms per megastep and img/s.

The line before the last is one JSON object listing every kernel; the last
line is ``{"ok": true, "device": {...}}``. Any failed check raises, and the
script exits non-zero without printing a result. A watchdog ends a hung run
after 480 s with every thread's stack.
"""

import faulthandler
import json
import subprocess
import sys
import time

T0 = time.perf_counter()

WARMUP = 2
ITERS = 8
SEED = 20240611  # images, per-kernel seeds and megastep seeds all derive from it
BUILD_LIMIT_S = 60.0

# Card peaks by nvidia-smi name: device-memory bytes/s and float32 operations/s
# outside the tensor cores (NVIDIA data sheets, dense rates at the full power
# limit). 32-bit integer operations are counted at the float32 rate, which no
# integer pipe exceeds, so the bound stays a bound.
CARD_PEAKS = (
    ("H100 80GB HBM3", 3.35e12, 67e12),  # SXM
    ("H100 NVL", 3.9e12, 60e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H200", 4.8e12, 67e12),
)

# Scalar operations per element, counted from csrc/corruptions.cu: one
# Philox4x32-10 call is 10 rounds of 2 mul.lo, 2 mul.hi, 4 xor and 2 key adds
# (100 operations) and feeds 4 elements; the uniform map is 4; logf, expf,
# cosf and sqrtf are taken as 12, 10, 16 and 4 (estimates of the math
# library's instruction counts); a clip is 2.
PHILOX_PER_ELEMENT = 100 / 4
OPS_PER_ELEMENT = {
    "gaussian_noise": 2 * PHILOX_PER_ELEMENT + 2 * 4 + 12 + 4 + 16 + 4 + 1 + 2,
    "impulse_noise": PHILOX_PER_ELEMENT + 4 + 2 + 1,
    # shot: set-up (Philox, uniform, lam, logf, the first expf, divide, clip)
    # plus SHOT_OPS_PER_TERM for every further term the data needs
    "shot_noise": PHILOX_PER_ELEMENT + 4 + 1 + 12 + 10 + 2 + 2,
    "brightness": 1 + 2,
    "contrast": 1 + 4 + 2,
}
SHOT_OPS_PER_TERM = 10 + 4 + 2  # expf, three adds and a subtract, compare and branch
# The Philox helper: a quarter Philox call and the uniform map per element.
PHILOX_UNIFORM_OPS = PHILOX_PER_ELEMENT + 4
# K5, per pixel and pass (shared over channels): a quarter Philox call, the
# uniform map, the code (multiply, floor, min) and the source index (add,
# two clamps, a multiply-add).
GLASS_OPS_PER_PIXEL_PASS = PHILOX_PER_ELEMENT + 4 + 3 + 5
# K6 per pixel: dy and dx and their floors (4) and four tents of 4; then
# for each channel a multiply-add (2) for every live pair of taps and a
# weighted add (2) for every live row. A tap is live where its tent is not
# zero and its offset lies in [-m, m + 1]: at most the two at floor(d) and
# floor(d) + 1 on each axis, the only ones K6 sums; the rest add zeros.
ELASTIC_OPS_PER_PIXEL = 4 + 4 * 4
ELASTIC_OPS_PER_PAIR = 2
ELASTIC_OPS_PER_ROW = 2


def elastic_live_ops(ys, xs, m: int, c: int) -> float:
    """K6's operations on the coordinates ``ys``, ``xs`` (B, H, W), counting
    only the live taps."""
    import torch

    _, h, w = ys.shape

    def live(d):
        n = torch.zeros_like(d)
        for t in (torch.floor(d), torch.floor(d) + 1):
            n += ((t >= -m) & (t <= m + 1) & (1.0 - (d - t).abs() > 0)).float()
        return n

    ny = live(ys - torch.arange(h, dtype=ys.dtype, device=ys.device).view(1, h, 1))
    nx = live(xs - torch.arange(w, dtype=xs.dtype, device=xs.device).view(1, 1, w))
    ops = ELASTIC_OPS_PER_PIXEL + c * ny * (ELASTIC_OPS_PER_PAIR * nx + ELASTIC_OPS_PER_ROW)
    return float(ops.double().sum())


# Philox helper launches in one megastep: motion 1, snow 2, frost 5, fog 5, elastic 2.
PHILOX_DRAWS_PER_MEGASTEP = 15
# Launches of one megastep over the 15 cells: K1-K3, K5 and K6 once, K4
# twice (brightness and contrast), the helper 15 times.
MEGASTEP_LAUNCHES = {"gaussian_noise": 1, "shot_noise": 1, "impulse_noise": 1, "photometric": 2,
                     "glass_resample": 1, "glass_resample_packed": 0, "elastic_warp": 1, "elastic_warp_packed": 0,
                     "frame_stats": 0, "corrupt_normalize": 0, "shear_rows": 0, "shear_cols": 0,
                     "philox_uniform": PHILOX_DRAWS_PER_MEGASTEP}
# The packed megastep: K5p and K6p in place of K5 and K6.
PACKED_MEGASTEP_LAUNCHES = {**MEGASTEP_LAUNCHES, "glass_resample": 0, "glass_resample_packed": 1,
                            "elastic_warp": 0, "elastic_warp_packed": 1}

# Tolerances of kernel against plain version, on the same inputs on the card.
K1_TOL = 1e-5  # logf/cosf/sqrtf ulps between the kernel's and PyTorch's builds
K4_CONTRAST_TOL = 1e-6  # the per-image mean is summed in another order
K2_MAX_TIE_FRACTION = 1e-4  # counts may differ only where u sits on a CDF partial sum
# K2 held at every severity (k_max 145 .. 25) and, on a base 4 bytes off a
# 16-byte boundary, at a shape whose element count is a multiple neither of
# 4 nor of a warp's chunk; timed at severity 3 (the main path's) and 1 (the
# most terms)
K2_ODD_SHAPE = (7, 33, 31, 3)
K2_TIMED_SEVERITIES = (3, 1)
# K5 held exactly at every severity (m 1..4, 1..3 rounds), at the odd shape
# (H W not a multiple of 4: Philox groups straddle images) and at batch 7 of
# 32x32, both on a base 4 bytes off a 16-byte boundary
K5_ODD_BATCH = 7
# K5p held exactly at every severity, on a base 4 bytes off a 16-byte
# boundary, at 12 images of 33x31 (G = 4; H W = 1023, so Philox groups
# straddle images inside a group) and at 6 of 32x32 (packed_group lowers
# G = 4 to 3, a divisor of 6)
K5P_ODD_SHAPES = ((12, 33, 31, 3), (6, 32, 32, 3))
# K5 (pure selection) and K6 (the plain version's operations in its order,
# no contraction) are held to their plain versions exactly; so are K5p and
# K6p, to theirs and to K5 and K6 (the same draws, taps and order), and the
# Philox helper to uniform01, word for word.
K5_K6_TOL = 0.0
# Megastep through the kernels against the plain versions: the corrupted
# batches differ only as above (the band-matrix families run the same torch
# code on both routes, with bit-equal draws), and the bf16 forward turns
# that into confidence changes far below 2e-3; a failure-rate step is
# 1/92160 at fifteen cells, so 2e-3 allows some 180 images to cross
# conf = 0.5.
MEGASTEP_TOL = 2e-3
# Golden logits: the bf16 forward on the card (cuDNN) against the JAX
# package's eager bf16 forward on the CPU. Both round to bf16 at the same
# points but sum in other orders, so about one activation in 1e5 lands one
# bf16 step apart per layer; on the CPU the port stays within 0.034 of the
# golden logits (tests/test_torch_models.py), and 0.125 leaves room for
# cuDNN's orders. Argmax must agree wherever the golden top-2 margin exceeds
# twice that.
GOLDEN_ATOL = 0.125

# K7 per pixel, the function's own operations, whatever the design: the
# Laplacian (5), the four int64 sums (Σg 1, Σlap 2, Σlap² 3, Σ|g - p| 3) and
# the histogram's range test (2) and count (1).
K7_OPS_PER_PIXEL = 5 + 9 + 3
K7_SHAPES = ((32, 240, 320), (6144, 32, 32))  # the service's bucket 32, the grid's batch: timed
# held to the plain version only, on a base 4 bytes off a 16-byte boundary:
# rows not a multiple of the strip and a width not a multiple of 4, the
# smallest frame, the largest the int64 sums allow (n = 2**21), a frame
# whose 2-row strip would pass 48 KB with the block's header, and two whose
# rows pass it (column tiles, each staged row at its own 16-byte phase)
K7_CHECK_SHAPES = ((3, 241, 317), (5, 2, 2), (1, 1024, 2048), (1, 1000, 2000), (1, 3, 3000), (1, 3, 4099))
# K6p at a batch of fewer groups than its persistent grid has blocks, on a
# base 4 bytes off a 16-byte boundary as well
K6P_SMALL_BATCH = 12
# K8 per element: with noise, K1's (two quarter Philox calls, two uniform
# maps, log, sqrt, cos and three products) and its add; the mean's add; the
# photometric part (4); the clip (2); the normalisation (2).
K8_OPS_PER_ELEMENT = {
    True: 2 * PHILOX_PER_ELEMENT + 2 * 4 + 12 + 4 + 16 + 3 + 1 + 1 + 4 + 2 + 2,
    False: 1 + 4 + 2 + 2,
}
K8_CONSTANTS = {"bright": 0.1, "contrast": 0.5, "mean": 0.5, "scale": 2.0}  # tests/test_pallas.py:89
K8_SIGMAS = (0.0, 0.18)  # as tests/test_pallas.py runs it; gaussian noise's severity-3 sigma
# K8 against its plain version: the per-image mean is summed in another
# order (as K4's contrast); with noise, K1's logf/cosf ulps as well.
K8_TOL = {False: 1e-6, True: 1e-5}
# K7 and the plain version form the same integer sums and divide them once:
# statistics and histograms are held equal, and so is everything the
# analyzer derives from them on the two routes.
# The monitor run against the JAX package's golden: fav_tpu sums in float32
# where the port's statistics are exact (tests/test_torch_signal.py), and
# the service's dicts round the anomaly to 6 digits.
MONITOR_ATOL = 1e-5 + 5e-7
MONITOR_FPS_ITERS = 20
REPLAY_RELIABILITY_TOL = 1e-12
# docs/parity.md:37 through the port's scan: (tick, field, value, tolerance)
TRUST_GOLDENS = (
    (50, "reliability", 0.510000, 1e-6),  # after FROZEN x50
    (80, "reliability", 0.0, 1e-9),  # after BLANK x30
    (180, "reliability", 0.0, 1e-9),  # after CORRUPTED x100
    (380, "reliability", 0.504917, 1e-6),  # after OK x200
    (380, "anomaly_integral", 0.036049, 1e-6),
)

# Phase 8: the classifier configuration (fav_tpu/checkpoints/classifier/
# metadata.json, the pretrain defaults), AugMix with JS 12.
TRAIN_BATCH = 256
TRAIN_LR = 1e-3
TRAIN_JS_LAM = 12.0
TRAIN_WARMUP = 2
TRAIN_CHUNKS = 2
TRAIN_K = 10
TRAIN_BREAKDOWN_STEPS = 3
# A step makes two views, each three shear passes (rows, columns, rows).
K9_LAUNCHES_PER_STEP = {"shear_rows": 4, "shear_cols": 2}
SHEAR_BATCH = 3 * TRAIN_BATCH  # an AugMix view's chain batch: width 3 x B
# K9a/K9b per element, counted from csrc/shear.cu: the clip (2), floor and
# fraction (2), two index adds and two clamps (6), the blend (4).
SHEAR_OPS_PER_ELEMENT = 14
# fav_tpu's golden step against the port's through K9a/K9b on the card (TF32
# off): cuDNN and XLA sum in other orders; the classes of
# tests/test_torch_train.py (loss, ce, js 1e-5 relative; a gradient leaf's
# sum within 1e-4 of its absolute sum; the updated parameters 2e-5 each, so
# a leaf's sum within 2e-5 per element).
TRAIN_GOLDEN_RTOL = 1e-5
# JS is a sum of p (log p - log m) terms of order 0.1 that cancel to some
# 3e-5 at an untrained network, where float32 leaves a few ulps of those
# terms: js is held to 1e-5 relative or 1e-7 absolute.
TRAIN_GOLDEN_JS_ATOL = 1e-7
TRAIN_GOLDEN_GRAD_RTOL = 1e-4
TRAIN_GOLDEN_PARAM_ATOL = 2e-5
# A conv whose GroupNorm has one channel per group has a bias gradient of 0
# in exact arithmetic (the normalisation removes any per-channel constant),
# so both libraries compute rounding noise there, which AdamW's first step
# turns into ±lr: those biases' gradients are held to 1e-6 absolute per
# element and their updated values to 2 lr.
TRAIN_GOLDEN_NULL_GRAD_ATOL = 1e-6
TRAIN_GOLDEN_NULL_PARAM_ATOL = 2 * TRAIN_LR
# One step from the same state and generator through the kernel and the
# plain route: the views are equal bit for bit, so only cuDNN's choice of
# algorithms can part them (its backward may sum with atomics). The loss
# comes from the forward, which cuDNN runs deterministically: 1e-6
# relative. An AdamW step moves a parameter by about lr at most, so
# gradients that differ in their last bits cannot part the parameters by
# more than lr.
ROUTE_LOSS_RTOL = 1e-6
ROUTE_PARAM_ATOL = TRAIN_LR


def phase(name: str, msg: str = "") -> None:
    print(f"[chip_smoke] {name:9s} t={time.perf_counter() - T0:7.2f}s  {msg}".rstrip(), flush=True)


def card_peaks(name: str) -> tuple[float, float, str]:
    for key, bw, ops in CARD_PEAKS:
        if key in name:
            return bw, ops, key
    return 3.35e12, 67e12, "H100 SXM (assumed: card not in CARD_PEAKS)"


# Cycles of a device sleep queued before a timed run (some 5 ms at the
# H100's 1.98 GHz): the host enqueues the run's launches meanwhile, so the
# events time the device and not the host's ctypes and Python per launch,
# which is longer than a small kernel (K9a/K9b: some 0.02-0.03 ms).
QUEUE_CYCLES = 10_000_000


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events
    around calls queued behind a device sleep."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def profile_step(step, step_ms: float, label: str) -> None:
    """Device time by kernel over one call of ``step`` (torch.profiler, CUPTI
    on the card), after one profiled warm-up call; the busy share is that
    device time over ``step_ms``, the step's wall time measured without the
    profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    tables = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: tables.append(p.key_averages())) as prof:
        for _ in range(2):
            step()
            torch.cuda.synchronize()
            prof.step()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    events = tables[-1] if tables else []
    # device-side events only; the step marker is mirrored on the device
    # timeline and spans the kernels, so it is left out of the sum
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA and dev_us(e) > 0
                      and not e.key.startswith("ProfilerStep")),
                     key=dev_us, reverse=True)
    if not kernels:
        phase("profile", f"{label}: no device time in the trace: not measured")
        return
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    phase("profile", f"{label}: device kernels {busy_ms:.3f} ms of {step_ms:.3f} ms wall "
                     f"(busy share {busy_ms / step_ms:.3f}); top kernels by device time:")
    for e in kernels[:24]:
        print(f"           {dev_us(e) / 1e3:9.3f} ms {dev_us(e) / 1e3 / busy_ms:6.1%} x{e.count:<4d} {e.key[:100]}",
              flush=True)


class LatencyRecorder:
    """The service's ``timer``: keeps every recorded duration."""

    def __init__(self):
        self.seconds: dict[str, list[float]] = {}

    def record(self, name: str, seconds: float) -> None:
        self.seconds.setdefault(name, []).append(seconds)


def k7_frames(dev, gen, b: int, h: int, w: int, offset: int = 0):
    """gray, prev [b, h, w] int32 and has_prev [b] for K7's checks: random
    levels; the first of every eight frames flat (all of them with b < 8
    but one), the top half of the last frame flat, some 1 in 1000 pixels
    outside 0..255; ``offset`` ints into their buffers, so a base off a
    16-byte boundary."""
    import torch

    def frame():
        buf = torch.empty(b * h * w + offset, dtype=torch.int32, device=dev)
        t = buf[offset:].view(b, h, w)
        t.copy_(torch.randint(0, 256, (b, h, w), generator=gen, device=dev, dtype=torch.int32))
        return t

    gray, prev = frame(), frame()
    flat = max(1, b // 8) if b > 1 else 0
    gray[:flat] = torch.randint(0, 256, (flat, 1, 1), generator=gen, device=dev, dtype=torch.int32)
    gray[-1, : h // 2] = 77
    px = gray.view(-1)
    odd = torch.randint(0, px.numel(), (max(1, px.numel() // 1000),), generator=gen, device=dev)
    px[odd] = torch.randint(-300, 600, odd.shape, generator=gen, device=dev, dtype=torch.int32)
    has_prev = torch.arange(b, device=dev) % 4 != 0
    return gray, prev, has_prev


def check_k7(dev, gen, bound) -> dict:
    """K7 against its plain version, statistics and histograms exact, at the
    service's and the grid's shapes (timed: the wrapper, the plain version
    and ``torch.bincount`` for the histogram part) and at K7_CHECK_SHAPES."""
    import torch

    from fav_tpu_torch.ops import corruptions_cuda as kern
    from fav_tpu_torch.ops import signal as sig
    from fav_tpu_torch.ops import signal_cuda

    shapes = {}
    for b, h, w in K7_SHAPES + K7_CHECK_SHAPES:
        timed = (b, h, w) in K7_SHAPES
        gray, prev, has_prev = k7_frames(dev, gen, b, h, w, offset=0 if timed else 1)
        geo = signal_cuda.frame_stats_geometry(b, h, w, kern.multiprocessors(dev))
        stats, hist = signal_cuda.frame_statistics(gray, prev, has_prev)
        want_stats, want_hist = sig.frame_statistics_plain(gray, prev, has_prev)
        torch.cuda.synchronize()
        check(torch.equal(stats, want_stats), f"K7 {(b, h, w)}: statistics differ from the plain version by "
                                              f"{float((stats - want_stats).abs().max())}")
        check(torch.equal(hist, want_hist), f"K7 {(b, h, w)}: histograms differ from the plain version")
        in_range = ((gray >= 0) & (gray <= 255)).sum((1, 2)).to(torch.int32)
        check(torch.equal(hist.sum(-1), in_range), f"K7 {(b, h, w)}: a histogram does not count every pixel in 0..255")
        # a second launch finds the ticket counters at zero again
        again = signal_cuda.frame_statistics(gray, prev, has_prev)
        check(torch.equal(again[0], stats) and torch.equal(again[1], hist), f"K7 {(b, h, w)}: a second launch differs")
        layout = (f"{geo.tiles} tiles of {geo.rows}x{geo.cols} a frame, {geo.blocks} blocks of {geo.units}x{geo.team} "
                  f"threads, {geo.shared_bytes} B shared")
        if not timed:
            phase("kernels", f"K7 frame_stats {(b, h, w)} (base 4 bytes off 16): statistics and histograms equal to "
                             f"the plain version; {layout}")
            continue
        ms = time_ms(lambda: signal_cuda.frame_statistics(gray, prev, has_prev), reps=20)
        plain_ms = time_ms(lambda: sig.frame_statistics_plain(gray, prev, has_prev), reps=3, warmup=1)
        keys = (gray.clamp(0, 255) + 256 * torch.arange(b, device=dev, dtype=torch.int32).view(b, 1, 1)).reshape(-1).long()
        library_ms = time_ms(lambda: torch.bincount(keys, minlength=b * 256), reps=20)
        pixels = b * h * w
        # two int32 frames and the int32 flags read; statistics and histograms written
        bytes_moved = 2 * pixels * 4 + b * 4 + b * 3 * 4 + b * 256 * 4
        ops = K7_OPS_PER_PIXEL * pixels
        bound_ms, by = bound(bytes_moved, ops)
        shapes[f"{b}x{h}x{w}"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                  "bound_by": by, "library_ms": library_ms}
        phase("kernels", f"K7 frame_stats {(b, h, w)}: statistics and histograms equal to the plain version; "
                         f"{layout}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({by}: "
                         f"{bytes_moved / 1e6:.1f} MB, {ops / 1e9:.3f} Gop), {ms / bound_ms:.1f}x the bound; "
                         f"torch.bincount (the histogram part only) {library_ms:.4f} ms")
    return shapes


def misaligned(t):
    """A copy of ``t`` on a base 4 bytes off a 16-byte boundary."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def check_k6p_small_batch(x) -> None:
    """K6p at K6P_SMALL_BATCH images, fewer groups than its grid has
    blocks, on a base 4 bytes off a 16-byte boundary: equal to K6 and to
    its plain version at every severity."""
    import torch

    from fav_tpu_torch.ops import corruptions as plain
    from fav_tpu_torch.ops import corruptions_cuda as kern

    b = K6P_SMALL_BATCH
    xb = misaligned(x[:b])
    groups = {}
    for level in range(1, len(plain.ELASTIC_SEV) + 1):
        fy, fx = plain.elastic_fields(SEED + 14, xb, level, uniform=kern.uniform)
        g = plain.packed_group(b, xb.shape[2] + 2 * (plain.elastic_margin(level) + 1))
        got = kern.elastic_warp(xb, fy, fx, level, packed=True)
        k6 = kern.elastic_warp(xb, fy, fx, level)
        want = plain.elastic_from_fields_packed(xb, fy, fx, level, g)
        torch.cuda.synchronize()
        check(torch.equal(got, want) and torch.equal(got, k6),
              f"elastic_warp_packed batch {b} severity {level} (G={g}): max diff "
              f"{float((got - want).abs().max())} from its plain version, {float((got - k6).abs().max())} from K6")
        geo = kern.elastic_packed_geometry(b, g, *xb.shape[1:], kern.multiprocessors(x.device))
        groups[level] = (g, geo.blocks)
    phase("kernels", f"K6p elastic_warp_packed at batch {b} (base 4 bytes off 16): equal to K6 and its plain version "
                     f"at severities 1-5 (G, blocks: {groups})")


def shot_work(x, seed: int, severity: int) -> tuple[float, float, float]:
    """K2's work on ``x`` at ``severity`` with draw 0 of ``seed``: the terms
    beyond the first that this run's data needs (min(count, k_max - 1) an
    element), and the bound's bytes and operations."""
    import torch

    from fav_tpu_torch.ops import corruptions as plain
    from fav_tpu_torch.ops.random import uniform01

    n = x.numel()
    c = plain.sev_param(plain.SHOT_C, severity)
    k_max = plain.shot_k_max(severity)
    counts = plain.poisson_inverse_cdf(x * c, uniform01(seed, n, 0, device=x.device).reshape(x.shape), k_max)
    terms = float(torch.clamp(counts, max=k_max - 1).sum())
    return terms, 2 * n * 4 + 4 * k_max, OPS_PER_ELEMENT["shot_noise"] * n + SHOT_OPS_PER_TERM * terms


def shot_library(x, got, severity: int) -> tuple[float, str]:
    """``torch.poisson`` on lam = x c, made before timing: the draw only,
    without K2's scale and clip, and from another stream, so a yardstick of
    time; the note sets the mean of clip(draw / c) beside the kernel's."""
    import torch

    from fav_tpu_torch.ops import corruptions as plain

    c = plain.sev_param(plain.SHOT_C, severity)
    lam = x * c
    ms = time_ms(lambda: torch.poisson(lam), reps=20)
    mean = float(torch.clamp(torch.poisson(lam) / c, 0.0, 1.0).double().mean())
    return ms, (f"torch.poisson(x c) {ms:.4f} ms, the draw only (another stream: mean of clip(draw / c) "
                f"{mean:.6f} against the kernel's {float(got.double().mean()):.6f})")


def check_k2(x, bound) -> dict:
    """K2 against its plain version at every severity on ``x`` and, on a
    base 4 bytes off 16, at K2_ODD_SHAPE: at most K2_MAX_TIE_FRACTION of the
    elements differ, by one count at most. Timed at the severities of
    K2_TIMED_SEVERITIES other than 3, which the kernels phase times."""
    import torch

    from fav_tpu_torch.ops import corruptions as plain
    from fav_tpu_torch.ops import corruptions_cuda as kern

    seed = SEED + 2  # the kernels phase's seed for K2
    gen = torch.Generator(device=x.device).manual_seed(SEED + 20)
    odd = misaligned(torch.rand(K2_ODD_SHAPE, generator=gen, device=x.device))
    out = {}
    for level in range(1, len(plain.SHOT_C) + 1):
        c = plain.sev_param(plain.SHOT_C, level)
        rec = {}
        for label, xx in (("batch", x), ("odd", odd)):
            got = kern.shot_noise(seed, xx, level)
            diff = (got - plain.shot_noise_plain(seed, xx, level)).abs()
            torch.cuda.synchronize()
            frac = float((diff > 0).sum()) / xx.numel()
            err = float(diff.max())
            check(frac <= K2_MAX_TIE_FRACTION and err <= 1.0 / c + 1e-6,
                  f"shot_noise severity {level} at {tuple(xx.shape)}: {frac:.2e} of elements differ (limit "
                  f"{K2_MAX_TIE_FRACTION}), max diff {err} (one count: {1.0 / c})")
            rec[label] = {"differing_fraction": frac, "max_abs_err": err}
        if level in K2_TIMED_SEVERITIES and level != 3:
            ms = time_ms(lambda: kern.shot_noise(seed, x, level), reps=20)
            plain_ms = time_ms(lambda: plain.shot_noise_plain(seed, x, level), reps=3, warmup=1)
            terms, bytes_moved, ops = shot_work(x, seed, level)
            bound_ms, by = bound(bytes_moved, ops)
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, mean_terms=1 + terms / x.numel())
            phase("kernels", f"K2 shot_noise severity {level} (k_max {plain.shot_k_max(level)}): kernel {ms:.4f} ms, "
                             f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({by}: {ops / 1e9:.3f} Gop), "
                             f"{ms / bound_ms:.2f}x the bound, mean terms per element {1 + terms / x.numel():.3f}")
        out[f"severity={level}"] = rec
    phase("kernels", f"K2 shot_noise at severities 1-5, seed {seed}: differing fractions "
                     + ", ".join(f"{r['batch']['differing_fraction']:.3e}" for r in out.values())
                     + f" at {tuple(x.shape)} and "
                     + ", ".join(f"{r['odd']['differing_fraction']:.3e}" for r in out.values())
                     + f" at {K2_ODD_SHAPE} (base 4 bytes off 16), each within {K2_MAX_TIE_FRACTION} and one count")
    return out


def check_k5(x, seed: int) -> None:
    """K5 exact to its plain version at every severity on ``x`` and, on a
    base 4 bytes off 16, at K2_ODD_SHAPE and at K5_ODD_BATCH images of
    ``x``; K5p exact to its plain version and to K5 at every severity on
    ``x`` and, on such a base, at K5P_ODD_SHAPES."""
    import torch

    from fav_tpu_torch.ops import corruptions as plain
    from fav_tpu_torch.ops import corruptions_cuda as kern

    gen = torch.Generator(device=x.device).manual_seed(SEED + 21)
    shapes = (x, misaligned(torch.rand(K2_ODD_SHAPE, generator=gen, device=x.device)), misaligned(x[:K5_ODD_BATCH]))
    packed_shapes = (x, *(misaligned(torch.rand(s, generator=gen, device=x.device)) for s in K5P_ODD_SHAPES))
    for level in range(1, len(plain.GLASS_SEV) + 1):
        _, m, iters = plain.sev_param(plain.GLASS_SEV, level)
        for xx in shapes:
            got = kern.glass_resample(seed, xx, m, iters)
            want = plain.glass_resample_plain(seed, xx, m, iters)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"glass_resample severity {level} (m={m}, iters={iters}) at "
                                          f"{tuple(xx.shape)}: max diff {float((got - want).abs().max())}, "
                                          f"expected exact")
        for xx in packed_shapes:
            got_p = kern.glass_resample(seed, xx, m, iters, packed=True)
            want_p = plain.glass_resample_packed_plain(seed, xx, m, iters)
            k5 = kern.glass_resample(seed, xx, m, iters)
            torch.cuda.synchronize()
            check(torch.equal(got_p, want_p) and torch.equal(got_p, k5),
                  f"glass_resample_packed severity {level} at {tuple(xx.shape)} (G="
                  f"{plain.packed_group(xx.shape[0], xx.shape[2])}): max diff "
                  f"{float((got_p - want_p).abs().max())} from its plain version, "
                  f"{float((got_p - k5).abs().max())} from K5, expected exact")
    groups = [plain.packed_group(s[0], s[2]) for s in (tuple(x.shape), *K5P_ODD_SHAPES)]
    phase("kernels", f"K5 glass_resample equal to its plain version at severities 1-5 (m, iters: "
                     f"{[plain.sev_param(plain.GLASS_SEV, v)[1:] for v in range(1, 6)]}) at {tuple(x.shape)}, and "
                     f"at {K2_ODD_SHAPE} and {(K5_ODD_BATCH, *x.shape[1:])} on a base 4 bytes off 16 ("
                     f"{kern.glass_shared_bytes(*x.shape[1:], 6)} B shared a block at severity 3); K5p equal to its "
                     f"plain version and to K5 at severities 1-5 at {tuple(x.shape)} and at "
                     f"{', '.join(map(str, K5P_ODD_SHAPES))} on a base 4 bytes off 16 (G {groups}; "
                     f"{kern.glass_packed_shared_bytes(groups[0], *x.shape[1:], 6)} B shared a block at severity 3)")


def check_k8(x, bound) -> dict:
    """K8 against its plain version at sigma 0 and 0.18, with the constants
    of tests/test_pallas.py:89, on ``x`` and, on a base 4 bytes off 16, at
    K2_ODD_SHAPE (d = 3069: Philox groups straddle images)."""
    import torch

    from fav_tpu_torch.ops import corruptions as plain
    from fav_tpu_torch.ops import corruptions_cuda as kern

    seed = SEED + 14
    n = x.numel()
    gen = torch.Generator(device=x.device).manual_seed(SEED + 22)
    odd = misaligned(torch.rand(K2_ODD_SHAPE, generator=gen, device=x.device))
    out = {}
    for sigma in K8_SIGMAS:
        noise = sigma > 0.0
        got = kern.corrupt_normalize(seed, x, sigma, **K8_CONSTANTS)
        want = plain.corrupt_normalize_plain(seed, x, sigma, **K8_CONSTANTS)
        odd_got = kern.corrupt_normalize(seed, odd, sigma, **K8_CONSTANTS)
        odd_want = plain.corrupt_normalize_plain(seed, odd, sigma, **K8_CONSTANTS)
        torch.cuda.synchronize()
        check(got.shape == x.shape and bool(torch.isfinite(got).all()), f"K8 sigma {sigma}: bad output")
        check(odd_got.shape == odd.shape and bool(torch.isfinite(odd_got).all()),
              f"K8 sigma {sigma} at {K2_ODD_SHAPE}: bad output")
        err = float((got - want).abs().max())
        odd_err = float((odd_got - odd_want).abs().max())
        check(err <= K8_TOL[noise], f"K8 sigma {sigma}: max diff {err} > {K8_TOL[noise]}")
        check(odd_err <= K8_TOL[noise], f"K8 sigma {sigma} at {K2_ODD_SHAPE}: max diff {odd_err} > {K8_TOL[noise]}")
        geo = kern.corrupt_normalize_geometry(n // x.shape[0], noise)
        ms = time_ms(lambda: kern.corrupt_normalize(seed, x, sigma, **K8_CONSTANTS), reps=20)
        plain_ms = time_ms(lambda: plain.corrupt_normalize_plain(seed, x, sigma, **K8_CONSTANTS), reps=3, warmup=1)
        bytes_moved = 2 * n * 4
        ops = K8_OPS_PER_ELEMENT[noise] * n
        bound_ms, by = bound(bytes_moved, ops)
        out[f"sigma={sigma}"] = {"max_abs_err": err, "odd_max_abs_err": odd_err, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound_ms, "bound_by": by}
        phase("kernels", f"K8 corrupt_normalize (sigma {sigma}): max|kernel-plain| {err:.3e}, at {K2_ODD_SHAPE} "
                         f"on a base 4 bytes off 16 {odd_err:.3e} (tol {K8_TOL[noise]}); {geo.threads} threads a "
                         f"block, {geo.groups_per_thread} groups a thread; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
                         f"bound {bound_ms:.4f} ms, {ms / bound_ms:.2f}x the bound "
                         f"({by}: {bytes_moved / 1e6:.1f} MB, {ops / 1e9:.3f} Gop); library: none (no single "
                         f"PyTorch call draws the normals and applies the fused pass)")
    return out


def check_k9(dev, gen, bound) -> dict:
    """K9a and K9b against their plain versions at an AugMix view's chain
    batch, exact, with shifts past the clip limits; ``grid_sample``
    (bilinear, border, corners aligned) computes the same shear as the
    library yardstick."""
    import torch

    from fav_tpu_torch.ops import augment as aug
    from fav_tpu_torch.ops import augment_cuda

    x = torch.rand((SHEAR_BATCH, 32, 32, 3), generator=gen, device=dev, dtype=torch.float32)
    b, h, w, c = x.shape
    n = x.numel()
    mx, my = aug.shift_bounds(h, w)
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    out = {}
    for name, kid, wrapper, plain_fn, m, rows in (
        ("shear_rows", "K9a", augment_cuda.shear_rows, aug.shift_rows, mx, True),
        ("shear_cols", "K9b", augment_cuda.shear_cols, aug.shift_cols, my, False),
    ):
        delta = (torch.rand((b, h if rows else w), generator=gen, device=dev) * 2 - 1) * (m + 2)
        got = wrapper(x, delta, m)
        want = plain_fn(x, delta, m)
        torch.cuda.synchronize()
        check(got.shape == x.shape and torch.equal(got, want),
              f"{name}: max diff {float((got - want).abs().max())} from the plain version, expected exact")
        ms = time_ms(lambda: wrapper(x, delta, m), reps=20)
        plain_ms = time_ms(lambda: plain_fn(x, delta, m), reps=3, warmup=1)
        # the same shear as sample coordinates for grid_sample
        d = torch.clamp(delta, -m, m - 1)
        ii = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1).expand(b, h, w)
        jj = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w).expand(b, h, w)
        if rows:
            jj = jj + d.view(b, h, 1)
        else:
            ii = ii + d.view(b, 1, w)
        grid = torch.stack([jj / (w - 1) * 2 - 1, ii / (h - 1) * 2 - 1], dim=-1)

        def library():
            return torch.nn.functional.grid_sample(x_nchw, grid, mode="bilinear", padding_mode="border",
                                                   align_corners=True)

        lib_err = float((library().permute(0, 2, 3, 1) - got).abs().max())
        library_ms = time_ms(library, reps=20)
        bytes_moved = 2 * n * 4 + delta.numel() * 4
        ops = SHEAR_OPS_PER_ELEMENT * n
        bound_ms, by = bound(bytes_moved, ops)
        out[name] = {"kid": kid, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": by, "library_ms": library_ms}
        phase("kernels", f"{kid} {name} at {tuple(x.shape)}, m={m}: equal to the plain version; kernel {ms:.4f} ms, "
                         f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({by}: {bytes_moved / 1e6:.1f} MB, "
                         f"{ops / 1e9:.3f} Gop); grid_sample {library_ms:.4f} ms (max|grid_sample-kernel| "
                         f"{lib_err:.3e}, another order of operations)")
    return out


def train_golden_inputs(model, seed: int, batch: int):
    """The golden step's inputs, made with numpy from ``seed``: flax-path
    parameters for ``model`` (``random_flax_params``), float32 images and
    int32 labels. ``tests/test_torch_train.py`` makes the same."""
    import numpy as np

    from fav_tpu_torch.utils.checkpoint import random_flax_params

    rng = np.random.default_rng(seed)
    images = rng.random((batch, 32, 32, 3), dtype=np.float32)
    labels = rng.integers(0, 10, batch).astype(np.int32)
    return random_flax_params(model, seed), images, labels


def draws_from_json(d: dict, dev):
    """``AugMixDraws`` from the golden's lists, float32 on ``dev``."""
    import torch

    from fav_tpu_torch.ops.augment import AugMixDraws

    return AugMixDraws(**{k: torch.tensor(d[k], dtype=torch.float32, device=dev) for k in AugMixDraws._fields})


def zero_gradient_biases(model) -> set[str]:
    """Flax paths of the conv biases whose gradient is 0 in exact
    arithmetic: those of a conv followed by a GroupNorm of one channel per
    group. Convs come three a stage, the first two normalised."""
    return {f"Conv_{3 * (i // 2) + i % 2}/bias" for i, norm in enumerate(model.norms)
            if norm.num_groups == norm.num_channels}


def check_train_golden(golden: dict, dev) -> dict:
    """The JAX package's float32 AugMix step, its views made from its own
    draws by the port (on the card through K9a/K9b), its metrics and
    per-leaf sums held to the golden."""
    import torch

    from fav_tpu_torch.models.cnn import FailureAwareCNN
    from fav_tpu_torch.models.train import augmix_step_core, create_train_state
    from fav_tpu_torch.ops.augment import augmix_apply
    from fav_tpu_torch.utils.checkpoint import flax_to_torch, torch_to_flax

    model = FailureAwareCNN(widths=tuple(golden["widths"]), dense_width=golden["dense_width"], dropout_rate=0.0,
                            compute_dtype="float32")
    params, images, labels = train_golden_inputs(model, golden["seed"], golden["batch"])
    model.load_state_dict(flax_to_torch(params), strict=True)
    model.to(dev)
    x = torch.from_numpy(images).to(dev)
    y = torch.from_numpy(labels).long().to(dev)
    aug1, aug2 = (augmix_apply(x, draws_from_json(d, dev)) for d in golden["draws"])
    state = create_train_state(model, golden["lr"], golden["weight_decay"])
    metrics = augmix_step_core(state, x, y, aug1, aug2, golden["js_lam"], None)
    rel = {k: abs(float(metrics[k]) - golden[k]) / abs(golden[k]) for k in ("loss", "ce", "js")}
    for k, err in rel.items():
        atol = TRAIN_GOLDEN_JS_ATOL if k == "js" else 0.0
        check(err <= TRAIN_GOLDEN_RTOL or abs(float(metrics[k]) - golden[k]) <= atol,
              f"train golden: {k} {float(metrics[k])} vs {golden[k]} ({err:.2e} relative)")
    grads = torch_to_flax({n: p.grad for n, p in model.named_parameters()})
    new = torch_to_flax(model.state_dict())
    null = zero_gradient_biases(model)
    grad_err = param_err = 0.0
    for k, g in grads.items():
        if k in null:
            e = max(float(abs(g).max()), golden["grad_abs_sum"][k] / g.size)
            check(e <= TRAIN_GOLDEN_NULL_GRAD_ATOL, f"train golden: gradient {k} (0 in exact arithmetic) is {e:.2e}")
        else:
            e = abs(float(g.sum(dtype="float64")) - golden["grad_sum"][k]) / golden["grad_abs_sum"][k]
            check(e <= TRAIN_GOLDEN_GRAD_RTOL, f"train golden: gradient {k} sum off by {e:.2e} of its absolute sum")
            grad_err = max(grad_err, e)
        e = abs(float(new[k].sum(dtype="float64")) - golden["param_sum"][k]) / new[k].size
        tol = TRAIN_GOLDEN_NULL_PARAM_ATOL if k in null else TRAIN_GOLDEN_PARAM_ATOL
        check(e <= tol, f"train golden: parameter {k} sum off by {e:.2e} per element (tol {tol})")
        if k not in null:
            param_err = max(param_err, e)
    return {"max_rel_err": rel, "grad_sum_err": grad_err, "param_sum_err_per_element": param_err,
            "zero_gradient_biases": sorted(null)}


def train_phase(dev, profile: bool = False) -> dict:
    """The AugMix training path of the ``classifier`` configuration; see the
    module docstring, phase 8."""
    import copy

    import numpy as np
    import torch

    from fav_tpu_torch.config import ModelParams
    from fav_tpu_torch.data.cifar import index_iterator, synthetic_cifar10
    from fav_tpu_torch.models.cnn import create_model, init_params
    from fav_tpu_torch.models.train import (augmix_objective, augmix_train_step, augmix_views, create_train_state,
                                            make_train_megastep)
    from fav_tpu_torch.ops import corruptions_cuda as kern
    from fav_tpu_torch.utils.checkpoint import WEIGHTS_DIR

    golden = json.loads((WEIGHTS_DIR / "train_step.golden.json").read_text())
    g = check_train_golden(golden, dev)
    phase("train", f"the JAX package's float32 AugMix step at widths {tuple(golden['widths'])}, batch "
                   f"{golden['batch']}, its draws through K9a/K9b: loss, ce, js within "
                   f"{', '.join(f'{v:.2e}' for v in g['max_rel_err'].values())} relative (tol {TRAIN_GOLDEN_RTOL}; "
                   f"js also {TRAIN_GOLDEN_JS_ATOL} abs), gradient sums within "
                   f"{g['grad_sum_err']:.2e} (tol {TRAIN_GOLDEN_GRAD_RTOL}), updated parameter sums within "
                   f"{g['param_sum_err_per_element']:.2e} per element (tol {TRAIN_GOLDEN_PARAM_ATOL}); the biases "
                   f"whose gradient is 0 in exact arithmetic ({', '.join(g['zero_gradient_biases'])}) within "
                   f"{TRAIN_GOLDEN_NULL_GRAD_ATOL} and {TRAIN_GOLDEN_NULL_PARAM_ATOL}")

    t = time.perf_counter()
    ds = synthetic_cifar10()
    data_s = time.perf_counter() - t
    images_all = torch.from_numpy(ds.train_images).to(dev)
    labels_all = torch.from_numpy(ds.train_labels).to(dev)
    mp = ModelParams()
    model = init_params(create_model(mp).to(dev), torch.Generator(device=dev).manual_seed(SEED))
    state = create_train_state(model, TRAIN_LR)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    idx_it = index_iterator(ds.train_images.shape[0], TRAIN_BATCH, seed=SEED)
    phase("train", f"classifier config: vgg widths {mp.widths}, dense {mp.dense_width}, dropout {mp.dropout_rate}, "
                   f"{mp.compute_dtype}; {sum(p.numel() for p in model.parameters())} parameters; synthetic "
                   f"draw 0 ({ds.train_images.shape[0]} train images) made in {data_s:.2f} s")

    def batch(idx):
        i = torch.from_numpy(idx).to(dev)
        return images_all.index_select(0, i), labels_all.index_select(0, i)

    losses = []
    kern.reset_launch_counts()
    torch.cuda.synchronize()
    for i in range(TRAIN_WARMUP):
        m = augmix_train_step(state, *batch(next(idx_it)), gen, TRAIN_JS_LAM)
        losses.append({k: m[k].view(1) for k in ("loss", "ce", "js")})
        if i == 0:
            torch.cuda.synchronize()
            first = kern.launch_counts()
            want = {k: K9_LAUNCHES_PER_STEP.get(k, 0) for k in first}
            check(first == want, f"train: launches in one step {first}, expected {want}")
    mega = make_train_megastep(augmix=True, js_lam=TRAIN_JS_LAM, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(TRAIN_CHUNKS):
        chunk = np.stack([next(idx_it) for _ in range(TRAIN_K)])
        state, m = mega(state, images_all, labels_all, chunk, gen)
        losses.append(m)
    torch.cuda.synchronize()
    timed = TRAIN_CHUNKS * TRAIN_K
    step_ms = (time.perf_counter() - t) / timed * 1e3
    counts = kern.launch_counts()
    steps = TRAIN_WARMUP + timed
    want = {k: K9_LAUNCHES_PER_STEP.get(k, 0) * steps for k in counts}
    check(counts == want, f"train: launches over {steps} steps {counts}, expected {want}")
    curve = {k: torch.cat([m[k] for m in losses]).cpu().numpy() for k in ("loss", "ce", "js")}
    check(all(np.isfinite(v).all() for v in curve.values()), f"train: non-finite losses {curve}")
    check(curve["loss"][-5:].mean() < curve["loss"][:5].mean(),
          f"train: the loss does not fall: {curve['loss'].tolist()}")
    img_s = TRAIN_BATCH / (step_ms / 1e3)
    phase("train", f"{steps} steps at batch {TRAIN_BATCH} ({TRAIN_WARMUP} per-step warm-up, {TRAIN_CHUNKS} megastep "
                   f"chunks of {TRAIN_K} timed): {step_ms:.3f} ms/step, {img_s:.0f} training images/s; launches "
                   f"{counts} (first step {first})")
    phase("train", f"step 1: loss {curve['loss'][0]:.4f} ce {curve['ce'][0]:.4f} js {curve['js'][0]:.4f}; step "
                   f"{steps}: loss {curve['loss'][-1]:.4f} ce {curve['ce'][-1]:.4f} js {curve['js'][-1]:.4f}; mean of "
                   f"the first 5 {curve['loss'][:5].mean():.4f}, of the last 5 {curve['loss'][-5:].mean():.4f}")

    # where a step's time goes: CUDA events around the two views, the
    # forward and backward, and the optimizer
    x, y = batch(next(idx_it))
    split = {"augmix": 0.0, "forward_backward": 0.0, "optimizer": 0.0}
    for _ in range(TRAIN_BREAKDOWN_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        aug1, aug2 = augmix_views(gen, x)
        ev[1].record()
        loss, _ = augmix_objective(state.model, x, y, aug1, aug2, TRAIN_JS_LAM, gen)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ev[2].record()
        state.optimizer.step()
        ev[3].record()
        torch.cuda.synchronize()
        for key, (a, b) in zip(split, ((0, 1), (1, 2), (2, 3))):
            split[key] += ev[a].elapsed_time(ev[b]) / TRAIN_BREAKDOWN_STEPS
    total = sum(split.values())
    phase("train", f"breakdown (CUDA events, mean of {TRAIN_BREAKDOWN_STEPS} steps): augmix x2 "
                   f"{split['augmix']:.3f} ms ({split['augmix'] / total:.1%}), forward+backward "
                   f"{split['forward_backward']:.3f} ms ({split['forward_backward'] / total:.1%}), optimizer "
                   f"{split['optimizer']:.3f} ms ({split['optimizer'] / total:.1%})")

    # the kernel route against the plain route from one state and generator
    seed = SEED + 5
    k_views = augmix_views(torch.Generator(device=dev).manual_seed(seed), x)
    p_views = augmix_views(torch.Generator(device=dev).manual_seed(seed), x, plain=True)
    check(all(torch.equal(a, b) for a, b in zip(k_views, p_views)), "train: views differ between the routes")
    other = copy.deepcopy(state)
    mk = augmix_train_step(state, x, y, torch.Generator(device=dev).manual_seed(seed), TRAIN_JS_LAM)
    mp_ = augmix_train_step(other, x, y, torch.Generator(device=dev).manual_seed(seed), TRAIN_JS_LAM, plain=True)
    loss_err = abs(float(mk["loss"]) - float(mp_["loss"])) / abs(float(mp_["loss"]))
    with torch.no_grad():
        param_err = max(float((a - b).abs().max()) for a, b in zip(state.model.parameters(), other.model.parameters()))
    check(loss_err <= ROUTE_LOSS_RTOL and param_err <= ROUTE_PARAM_ATOL,
          f"train: kernel vs plain route: loss {loss_err:.2e} relative, parameters {param_err:.2e}")
    phase("train", f"kernel vs plain route from one generator: both views equal bit for bit; one step's loss "
                   f"within {loss_err:.2e} relative (tol {ROUTE_LOSS_RTOL}), parameters within {param_err:.2e} "
                   f"(tol {ROUTE_PARAM_ATOL})")
    del other
    if profile:
        profile_step(lambda: augmix_train_step(state, x, y, gen, TRAIN_JS_LAM), step_ms, "one train step")
    return {"counts": counts, "first_step_counts": first, "step_ms": step_ms, "img_per_s": img_s,
            "split_ms": split, "loss_first": float(curve["loss"][0]), "loss_last": float(curve["loss"][-1]),
            "ce": [float(curve["ce"][0]), float(curve["ce"][-1])],
            "js": [float(curve["js"][0]), float(curve["js"][-1])],
            "data_s": data_s, "golden": g, "route_loss_err": loss_err, "route_param_err": param_err}


def monitor_phase(dev, profile: bool = False) -> dict:
    """The analysis service on the card with the scripted streams; see the
    module docstring, phase 6."""
    import asyncio

    import numpy as np
    import torch

    from fav_tpu_torch.config import STATUS_NAMES, AnalyzerParams, TrustParams
    from fav_tpu_torch.core.policy_replay import POLICY_TICKS_DEFAULT, replay_outputs, summarize_policy
    from fav_tpu_torch.core.trust_scan import simulate_sequence
    from fav_tpu_torch.ops import corruptions_cuda as kern
    from fav_tpu_torch.ops.signal import analyze_frame, init_analyzer_carry
    from fav_tpu_torch.serving.analysis import AnalysisService
    from fav_tpu_torch.sim.frames import GOLDEN_STREAMS, MONITOR_STREAMS, MONITOR_TICKS, scripted_stream
    from fav_tpu_torch.utils.checkpoint import WEIGHTS_DIR

    golden = json.loads((WEIGHTS_DIR / "monitor.golden.json").read_text())
    h, w = golden["height"], golden["width"]
    check(golden["ticks"] == MONITOR_TICKS and golden["streams"] == list(GOLDEN_STREAMS), "monitor golden is stale")
    clips = [scripted_stream(kind, i, MONITOR_TICKS, h, w) for kind, i in MONITOR_STREAMS]
    code = {name: i for i, name in enumerate(STATUS_NAMES)}

    async def drive(service, paced: bool):
        slots = [service.acquire_slot() for _ in clips]
        check(None not in slots, "monitor: the service refused a slot")
        check(await service.maybe_analyze(clips[0][0], slots[0]) is None, "monitor: ready before its warm-up")
        while not service.ready:
            await asyncio.sleep(0.01)
        kern.reset_launch_counts()
        service.dispatches = 0
        loop = asyncio.get_running_loop()
        start = loop.time()
        rows = []
        for tick in range(MONITOR_TICKS):
            if paced:
                await asyncio.sleep(max(0.0, start + tick / 30.0 - loop.time()))
            rows.append(await asyncio.gather(*[service.analyze(c[tick], s) for c, s in zip(clips, slots)]))
        counts, dispatches = kern.launch_counts(), service.dispatches
        await service.close()
        return rows, counts, dispatches, loop.time() - start

    timer = LatencyRecorder()
    service = AnalysisService(AnalyzerParams(), h, w, capacity=64, timer=timer, device=dev)
    rows, counts, dispatches, run_s = asyncio.run(drive(service, paced=True))
    want = {k: 0 for k in counts}
    want["frame_stats"] = dispatches
    check(dispatches >= MONITOR_TICKS and counts == want,
          f"monitor: launch counts {counts} over {dispatches} dispatched batches; expected {want}")
    status = np.array([[code[r["vision_status"]] for r in tick] for tick in rows]).T  # [streams, ticks]
    anomaly = np.array([[r["anomaly_score"] for r in tick] for tick in rows]).T
    expect = {"ok": [0] * MONITOR_TICKS, "frozen": [0] * 5 + [1] * (MONITOR_TICKS - 5),
              "blank": [2] * MONITOR_TICKS, "corrupted": [3] * MONITOR_TICKS}
    for j, (kind, _) in enumerate(MONITOR_STREAMS):
        check(status[j].tolist() == expect[kind], f"monitor: stream {j} ({kind}) statuses {status[j].tolist()}")
    g_status = np.asarray(golden["status"])
    g_anomaly = np.asarray(golden["anomaly"])
    check(np.array_equal(status[list(GOLDEN_STREAMS)], g_status), "monitor: statuses differ from the JAX golden")
    gerr = float(np.abs(anomaly[list(GOLDEN_STREAMS)] - g_anomaly).max())
    check(gerr <= MONITOR_ATOL, f"monitor: anomalies {gerr} from the JAX golden (tol {MONITOR_ATOL})")
    lat = np.asarray(timer.seconds.get("analysis_device", [])) * 1e3
    check(lat.size == dispatches, f"monitor: {lat.size} latencies for {dispatches} batches")
    phase("monitor", f"{len(clips)} streams x {MONITOR_TICKS} ticks at {h}x{w} in {run_s:.3f} s: {dispatches} "
                     f"batches, launches {counts}; statuses as scripted; the {len(GOLDEN_STREAMS)} golden streams "
                     f"equal the JAX statuses, anomalies within {gerr:.2e} (tol {MONITOR_ATOL:.2e})")
    phase("monitor", f"dispatch-to-result latency per batch: mean {lat.mean():.3f} ms, median "
                     f"{np.median(lat):.3f} ms, max {lat.max():.3f} ms ({lat.size} batches)")

    # the same frames through the plain versions on the card
    plain_rows, plain_counts, _, _ = asyncio.run(drive(
        AnalysisService(AnalyzerParams(), h, w, capacity=64, device=dev, plain=True), paced=False))
    check(plain_counts["frame_stats"] == 0, "monitor: the plain route launched K7")
    check(plain_rows == rows, "monitor: the plain route's results differ from K7's")
    idx = np.arange(POLICY_TICKS_DEFAULT) % MONITOR_TICKS
    p_status = np.array([[code[r["vision_status"]] for r in tick] for tick in plain_rows]).T
    p_anomaly = np.array([[r["anomaly_score"] for r in tick] for tick in plain_rows]).T
    torch.cuda.synchronize()
    t = time.perf_counter()
    outs = replay_outputs(status[:, idx], anomaly[:, idx].astype(np.float64), device=dev)
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t) * 1e3
    plain_outs = replay_outputs(p_status[:, idx], p_anomaly[:, idx].astype(np.float64), device=dev)
    check(torch.equal(outs.policy, plain_outs.policy), "monitor: policy codes differ between the routes")
    rel_err = float((outs.reliability - plain_outs.reliability).abs().max())
    check(rel_err <= REPLAY_RELIABILITY_TOL, f"monitor: reliabilities differ by {rel_err}")
    summary = summarize_policy(outs)
    plain_summary = summarize_policy(plain_outs)
    for a, b in zip(summary, plain_summary):
        check(all(a[k] == b[k] for k in a if k.startswith("policy_share")), "monitor: policy shares differ")
    phase("monitor", f"replay of [{len(clips)}, {POLICY_TICKS_DEFAULT}] on the card: {replay_ms:.3f} ms; the "
                     f"plain route's replay equal (policy codes and shares exact, reliabilities within "
                     f"{rel_err:.1e})")
    for kind in expect:
        j = next(j for j, (k, _) in enumerate(MONITOR_STREAMS) if k == kind)
        r = summary[j]
        phase("monitor", f"  {kind:9s} allowed {r['policy_share_vision_allowed']:.4f} declining "
                         f"{r['policy_share_vision_declining']:.4f} degraded {r['policy_share_vision_degraded']:.4f} "
                         f"blocked {r['policy_share_vision_blocked']:.4f}, to BLOCKED {r['time_to_blocked_s']:.3f} s, "
                         f"final reliability {r['final_reliability']:.6f}")

    # the trust goldens through the port's scan on the card
    dt = 1.0 / 30.0
    seq = ([(0, 0.019, True)] + [(1, 0.019, True)] * 50 + [(2, 0.0, False)] * 30
           + [(3, 0.0, False)] * 100 + [(0, 0.019, True)] * 200)
    st = torch.tensor([s for s, _, _ in seq], dtype=torch.int32, device=dev)
    an = torch.tensor([a for _, a, _ in seq], dtype=torch.float64, device=dev)
    ha = torch.tensor([x for _, _, x in seq], dtype=torch.bool, device=dev)
    _, trust = simulate_sequence(TrustParams(), st, an, ha, torch.full((len(seq),), dt, dtype=torch.float64,
                                                                      device=dev))
    got = []
    for tick, field, value, tol in TRUST_GOLDENS:
        v = float(getattr(trust, field)[tick])
        check(abs(v - value) <= tol, f"trust golden: {field}[{tick}] = {v}, expected {value} within {tol}")
        got.append(f"{field}[{tick}] {v:.6f}")
    phase("monitor", "trust goldens on the card (docs/parity.md:37): " + ", ".join(got))

    # the batched analyzer at bucket 32, frames already on the card
    frames = torch.from_numpy(np.stack([c[1] for c in clips])).to(dev)
    fps = {}
    for route, plain_route in (("K7", False), ("plain", True)):
        carry = init_analyzer_carry(h, w, (frames.shape[0],), device=dev)
        for _ in range(3):
            analyze_frame(AnalyzerParams(), carry, frames, plain=plain_route)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(MONITOR_FPS_ITERS):
            analyze_frame(AnalyzerParams(), carry, frames, plain=plain_route)
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t) / MONITOR_FPS_ITERS * 1e3
        fps[route] = {"batch_ms": batch_ms, "frames_per_s": frames.shape[0] / (batch_ms / 1e3)}
        if profile and not plain_route:
            profile_step(lambda: analyze_frame(AnalyzerParams(), carry, frames), batch_ms,
                         f"one analyzer batch of {frames.shape[0]} at {h}x{w}")
    phase("monitor", f"batched analyzer at bucket {frames.shape[0]}, {h}x{w}: {fps['K7']['batch_ms']:.3f} ms a "
                     f"batch, {fps['K7']['frames_per_s']:.0f} frames/s through K7 (plain versions "
                     f"{fps['plain']['batch_ms']:.3f} ms, {fps['plain']['frames_per_s']:.0f} frames/s)")
    return {"counts": counts, "dispatches": dispatches, "latency_ms_mean": float(lat.mean()),
            "latency_ms_median": float(np.median(lat)), "latency_ms_max": float(lat.max()),
            "replay_ms": replay_ms, "analyzer": fps, "golden_max_abs_err": gerr}


def policy_phase(model, images, dev) -> dict:
    """The grid's L1 pass and policy replay over the 15 cells; see the
    module docstring, phase 7."""
    import torch

    from fav_tpu_torch.core.policy_replay import POLICY_TICKS_DEFAULT, grid_policy
    from fav_tpu_torch.models.uncertainty import msp
    from fav_tpu_torch.ops import corruptions_cuda as kern
    from fav_tpu_torch.parallel.sweep import l1_rows
    from fav_tpu_torch.pipeline import BENCH_CELLS, SEED_HIGH

    seeds = torch.randint(0, SEED_HIGH, (len(BENCH_CELLS),), generator=torch.Generator().manual_seed(SEED + 7))
    with torch.no_grad():
        clean = model(images).argmax(-1)
    kern.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    corrupted, rows = [], {"l1_status": [], "l1_anomaly": [], "conf": [], "correct": []}
    with torch.no_grad():
        for (name, severity), seed in zip(BENCH_CELLS, seeds.tolist()):
            x = kern.corruption_fn(name)(seed, images, severity)
            status, anomaly = l1_rows(x)
            logits = model(x)
            rows["l1_status"].append(status)
            rows["l1_anomaly"].append(anomaly)
            rows["conf"].append(msp(logits))
            rows["correct"].append(logits.argmax(-1) == clean)
            corrupted.append(x)
    rows = {k: torch.stack(v) for k, v in rows.items()}
    summaries = grid_policy(BENCH_CELLS, rows, device=dev)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    counts = kern.launch_counts()
    expected = {**MEGASTEP_LAUNCHES, "frame_stats": len(BENCH_CELLS)}
    check(counts == expected, f"policy: launch counts {counts}, expected {expected}")
    for (name, _), x, status, anomaly in zip(BENCH_CELLS, corrupted, rows["l1_status"], rows["l1_anomaly"]):
        p_status, p_anomaly = l1_rows(x, plain=True)
        check(torch.equal(status, p_status) and torch.equal(anomaly, p_anomaly),
              f"policy: {name}: l1_rows through K7 differ from the plain versions")
    for r in summaries:
        shares = sum(v for k, v in r.items() if k.startswith("policy_share"))
        check(abs(shares - 1.0) < 1e-9 and 0.0 <= r["min_reliability"] <= r["final_reliability"] + 1e-12 <= 1.0 + 1e-12,
              f"policy: implausible summary {r}")
    phase("policy", f"{len(BENCH_CELLS)} cells at batch {images.shape[0]}: corrupt, l1_rows (K7), nano confidence "
                     f"and grid_policy over {POLICY_TICKS_DEFAULT} ticks in {step_s * 1e3:.3f} ms; launches "
                     f"{counts}; l1_rows through K7 equal to the plain versions in every cell")
    counts_l1 = rows["l1_status"].cpu()
    for i, ((name, severity), r) in enumerate(zip(BENCH_CELLS, summaries)):
        frac = [float((counts_l1[i] == c).float().mean()) for c in range(4)]
        phase("policy", f"  {name:17s} L1 ok/frozen/blank/corrupted {frac[0]:.3f}/{frac[1]:.3f}/{frac[2]:.3f}/"
                        f"{frac[3]:.3f}; allowed {r['policy_share_vision_allowed']:.4f} declining "
                        f"{r['policy_share_vision_declining']:.4f} degraded {r['policy_share_vision_degraded']:.4f} "
                        f"blocked {r['policy_share_vision_blocked']:.4f}, to BLOCKED {r['time_to_blocked_s']:.3f} s, "
                        f"final {r['final_reliability']:.6f}, allowed-wrong {r['allowed_wrong_share']:.4f}")
    return {"counts": counts, "step_ms": step_s * 1e3, "summaries": summaries}


def packed_phase(dev) -> dict:
    """The packed A/B through ``run_ab``; see the module docstring, phase 9."""
    from fav_tpu_torch.pipeline import BATCH
    from fav_tpu_torch.tools.ab_packed_kernels import run_ab

    ab = run_ab(batch=BATCH, iters=ITERS, megastep=True, device=dev, log=lambda msg: phase("packed", msg))
    for family, r in ab["packed_equals_unpacked"].items():
        check(r["equal"], f"packed: {family}: the packed arm's batch differs from the unpacked arm's by "
                          f"{r['max_abs_diff']}")
    mega = ab["ab_packed"]
    for arm, want in (("packed", PACKED_MEGASTEP_LAUNCHES), ("unpacked", MEGASTEP_LAUNCHES)):
        check(mega[arm]["launches"] == want, f"packed: {arm} megastep launches {mega[arm]['launches']}, "
                                             f"expected {want}")
    check(mega["max_abs_diff"] <= MEGASTEP_TOL, f"packed: megastep arms {mega['packed']['out']} vs "
                                                f"{mega['unpacked']['out']}")
    phase("packed", f"kernel arms at batch {BATCH}, median of {ITERS} interleaved (CUDA events): "
                    + ", ".join(f"{k} {v:.4f} ms" for k, v in ab["median_ms"].items())
                    + "; packed and unpacked batches equal bit for bit in every family")
    phase("packed", f"megastep arms: packed {mega['packed']['ms_per_megastep']:.3f} ms "
                    f"({mega['packed']['img_per_sec']:.0f} img/s), unpacked {mega['unpacked']['ms_per_megastep']:.3f} "
                    f"ms ({mega['unpacked']['img_per_sec']:.0f} img/s); outputs within {mega['max_abs_diff']:.3e} "
                    f"(tol {MEGASTEP_TOL}); K5p/K6p once in the packed megastep, K5/K6 once in the unpacked one")
    return ab


def main(argv: list[str]) -> int:
    import torch

    # ── 1. device ──────────────────────────────────────────────────────────
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    bw, peak_ops, peak_row = card_peaks(kind)
    phase("device", f"{kind} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
                    f"peaks used: {peak_row} {bw / 1e12:.2f} TB/s, {peak_ops / 1e12:.0f} Tops/s")
    # The band-matrix products of the corruption families are float32
    # matmuls, the counterpart of fav_tpu's Precision.HIGHEST: full float32,
    # never TF32. cuDNN convolutions would take TF32 by default; the compared
    # forward is bf16, but the setting is pinned all the same.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("device", f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
                    f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    import numpy as np

    from fav_tpu_torch.ops import _build
    from fav_tpu_torch.ops import corruptions as plain
    from fav_tpu_torch.ops import corruptions_cuda as kern
    from fav_tpu_torch.ops.random import uniform01
    from fav_tpu_torch.pipeline import BATCH, BENCH_CELLS, make_megastep
    from fav_tpu_torch.utils.checkpoint import WEIGHTS_DIR, load_student

    dev = torch.device("cuda")

    # ── 2. build ───────────────────────────────────────────────────────────
    t = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t
    check(build_s < BUILD_LIMIT_S, f"kernel build took {build_s:.1f} s (limit {BUILD_LIMIT_S} s)")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        usage = [ln.strip() for ln in log.read_text().splitlines() if "Used" in ln or "Compiling entry" in ln] if log.exists() else []
        phase("build", f"{name}: {path.name} in {build_s:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
        for ln in usage:
            print(f"           ptxas {ln}", flush=True)

    # ── 3. kernels against their plain versions ───────────────────────────
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.rand((BATCH, 32, 32, 3), generator=gen, device=dev, dtype=torch.float32)
    n = x.numel()
    sev = 3
    report = {}
    specs = [
        # (entry name, kernel id, wrapper, plain version)
        ("gaussian_noise", "K1", kern.gaussian_noise, plain.gaussian_noise_plain),
        ("shot_noise", "K2", kern.shot_noise, plain.shot_noise_plain),
        ("impulse_noise", "K3", kern.impulse_noise, plain.impulse_noise_plain),
        ("brightness", "K4", kern.brightness, plain.brightness_plain),
        ("contrast", "K4", kern.contrast, plain.contrast_plain),
    ]
    for i, (name, kid, wrapper, plain_fn) in enumerate(specs):  # K1-K4
        seed = SEED + 1 + i
        got = wrapper(seed, x, sev)
        want = plain_fn(seed, x, sev)
        torch.cuda.synchronize()
        check(got.shape == x.shape and got.dtype == torch.float32, f"{name}: bad output {got.shape} {got.dtype}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        diff = (got - want).abs()
        err = float(diff.max())
        if name == "shot_noise":
            c = plain.sev_param(plain.SHOT_C, sev)
            frac = float((diff > 0).sum()) / n
            check(frac <= K2_MAX_TIE_FRACTION, f"{name}: {frac:.2e} of elements differ (limit {K2_MAX_TIE_FRACTION})")
            check(err <= 1.0 / c + 1e-6, f"{name}: max diff {err} exceeds one count (1/c = {1.0 / c})")
            extra = f"differing fraction {frac:.3e}"
        elif name in ("impulse_noise", "brightness"):
            check(err == 0.0, f"{name}: max diff {err}, expected exact")
            extra = "exact"
        else:
            tol = K1_TOL if name == "gaussian_noise" else K4_CONTRAST_TOL
            check(err <= tol, f"{name}: max diff {err} > {tol}")
            extra = f"tol {tol}"
        ms = time_ms(lambda: wrapper(seed, x, sev), reps=20)
        plain_ms = time_ms(lambda: plain_fn(seed, x, sev), reps=3, warmup=1)
        bytes_moved = 2 * n * 4
        ops = OPS_PER_ELEMENT[name] * n
        library_ms = None
        if name == "shot_noise":
            terms, bytes_k, ops_k = shot_work(x, seed, sev)
            bytes_moved, ops = bytes_k, ops_k
            extra += f" at seed {seed}, mean terms per element {1 + terms / n:.3f} of {plain.shot_k_max(sev)}"
            library_ms, lib_note = shot_library(x, got, sev)
            extra += f"; {lib_note}"
        t_bytes, t_ops = bytes_moved / bw * 1e3, ops / peak_ops * 1e3
        bound_ms = max(t_bytes, t_ops)
        report[name] = {
            "kid": kid, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": bytes_moved, "ops": ops,
            "library_ms": library_ms,
        }
        phase("kernels", f"{kid} {name}: max|kernel-plain| {err:.3e} ({extra}); kernel {ms:.4f} ms, "
                         f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({report[name]['bound_by']}: "
                         f"{bytes_moved / 1e6:.1f} MB, {ops / 1e9:.3f} Gop)")
    del got, want, diff

    b, h, w, c = x.shape
    pixels = b * h * w

    def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
        t_bytes, t_ops = bytes_moved / bw * 1e3, ops / peak_ops * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    # K2 across its range, timed at severity 1 as well
    k2_report = check_k2(x, bound)

    # the Philox helper against uniform01, word for word
    seed = SEED + 11
    got = kern.uniform(seed, (n,), 1, dev)
    want = uniform01(seed, n, 1, device=dev)
    check(torch.equal(got, want), "philox_uniform: the helper's uniforms differ from uniform01")
    ms = time_ms(lambda: kern.uniform(seed, (n,), 1, dev), reps=20)
    plain_ms = time_ms(lambda: uniform01(seed, n, 1, device=dev), reps=3, warmup=1)
    bound_ms, by = bound(4 * n, PHILOX_UNIFORM_OPS * n)
    # the library yardstick: torch.rand draws the same law from another stream
    library_ms = time_ms(lambda: torch.rand(n, device=dev), reps=20)
    lib_mean = float(torch.rand(n, device=dev).double().mean())
    report["philox_uniform"] = {"kid": "helper", "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms}
    phase("kernels", f"philox_uniform helper: bit-equal to uniform01 over {n} draws; kernel {ms:.4f} ms, "
                     f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({by}); torch.rand {library_ms:.4f} ms "
                     f"(another stream: mean {lib_mean:.6f} against the kernel's {float(got.double().mean()):.6f})")

    # K5: the glass resample cascade, exact at every severity and on odd
    # shapes; K5p exact to K5 at every severity; timed at severity 3 (m = 2,
    # 3 rounds)
    seed = SEED + 12
    check_k5(x, seed)
    _, m, iters = plain.sev_param(plain.GLASS_SEV, sev)
    got = kern.glass_resample(seed, x, m, iters)
    want = plain.glass_resample_plain(seed, x, m, iters)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(got.shape == x.shape and err <= K5_K6_TOL, f"glass_resample: max diff {err}, expected exact")
    ms = time_ms(lambda: kern.glass_resample(seed, x, m, iters), reps=20)
    plain_ms = time_ms(lambda: plain.glass_resample_plain(seed, x, m, iters), reps=3, warmup=1)
    bytes_moved = 2 * n * 4
    ops = 2 * iters * GLASS_OPS_PER_PIXEL_PASS * pixels
    bound_ms, by = bound(bytes_moved, ops)
    report["glass_resample"] = {"kid": "K5", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": bound_ms, "bound_by": by, "library_ms": None}
    phase("kernels", f"K5 glass_resample (m={m}, iters={iters}): max|kernel-plain| {err:.3e} (exact); "
                     f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({by}: "
                     f"{bytes_moved / 1e6:.1f} MB, {ops / 1e9:.3f} Gop); library: none (no single PyTorch "
                     f"call draws and applies the cascade)")

    # K5p: the same cascade on groups of G = packed_group(B, W) images, held
    # to its plain version and to K5; the same bytes and operations as K5
    g5 = plain.packed_group(b, w)
    got_p = kern.glass_resample(seed, x, m, iters, packed=True)
    want_p = plain.glass_resample_packed_plain(seed, x, m, iters)
    torch.cuda.synchronize()
    err = float((got_p - want_p).abs().max())
    err_k5 = float((got_p - got).abs().max())
    check(got_p.shape == x.shape and max(err, err_k5) <= K5_K6_TOL,
          f"glass_resample_packed: max diff {err} from its plain version, {err_k5} from K5, expected exact")
    ms = time_ms(lambda: kern.glass_resample(seed, x, m, iters, packed=True), reps=20)
    plain_ms = time_ms(lambda: plain.glass_resample_packed_plain(seed, x, m, iters), reps=3, warmup=1)
    report["glass_resample_packed"] = {"kid": "K5p", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                       "bound_ms": bound_ms, "bound_by": by, "library_ms": None}
    phase("kernels", f"K5p glass_resample_packed (G={g5}): max|kernel-plain| {err:.3e}, max|K5p-K5| "
                     f"{err_k5:.3e} (exact); {kern.glass_packed_shared_bytes(g5, h, w, c, 2 * iters)} B shared a "
                     f"block; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({by}, as K5), "
                     f"{ms / bound_ms:.2f}x the bound; library: none")
    del got, want, got_p, want_p

    # K6: the elastic warp on the fields of a seed, exact at every severity
    # (m = 2 .. 6), timed at severity 3 (alpha 3.5, m = 4)
    # K6p on groups of G = packed_group(B, W + 2(m + 1)) images (3 at
    # severities 1-3, 2 at 4-5), held to its plain version and to K6
    packed_err = {}
    for level in range(1, len(plain.ELASTIC_SEV) + 1):
        fy, fx = plain.elastic_fields(SEED + 13, x, level, uniform=kern.uniform)
        got = kern.elastic_warp(x, fy, fx, level)
        diff = float((got - plain.elastic_from_fields(x, fy, fx, level)).abs().max())
        check(got.shape == x.shape and diff <= K5_K6_TOL,
              f"elastic_warp severity {level}: max diff {diff}, expected exact")
        g6 = plain.packed_group(b, w + 2 * (plain.elastic_margin(level) + 1))
        got_p = kern.elastic_warp(x, fy, fx, level, packed=True)
        diff_p = float((got_p - plain.elastic_from_fields_packed(x, fy, fx, level, g6)).abs().max())
        diff_k6 = float((got_p - got).abs().max())
        check(got_p.shape == x.shape and max(diff_p, diff_k6) <= K5_K6_TOL,
              f"elastic_warp_packed severity {level} (G={g6}): max diff {diff_p} from its plain version, "
              f"{diff_k6} from K6, expected exact")
        packed_err[level] = (g6, diff_p, diff_k6)
        if level == sev:
            ys, xs, err = fy, fx, diff
        del got, got_p, fy, fx
    em = plain.elastic_margin(sev)
    got = kern.elastic_warp(x, ys, xs, sev)
    ms = time_ms(lambda: kern.elastic_warp(x, ys, xs, sev), reps=20)
    plain_ms = time_ms(lambda: plain.elastic_from_fields(x, ys, xs, sev), reps=3, warmup=1)
    # the library yardstick: grid_sample's clamped bilinear warp, same coordinates
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([xs / (w - 1) * 2 - 1, ys / (h - 1) * 2 - 1], dim=-1)
    sample = torch.nn.functional.grid_sample

    def library():
        return sample(x_nchw, grid, mode="bilinear", padding_mode="border", align_corners=True)

    lib_err = float((library().permute(0, 2, 3, 1) - got).abs().max())
    library_ms = time_ms(library, reps=20)
    bytes_moved = 2 * n * 4 + 2 * pixels * 4
    ops = elastic_live_ops(ys, xs, em, c)
    bound_ms, by = bound(bytes_moved, ops)
    report["elastic_warp"] = {"kid": "K6", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms}
    phase("kernels", f"K6 elastic_warp (m={em}): max|kernel-plain| {err:.3e} (exact, and at severities "
                     f"1-5); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({by}: "
                     f"{bytes_moved / 1e6:.1f} MB, {ops / 1e9:.3f} Gop of live taps); grid_sample "
                     f"{library_ms:.4f} ms (max|grid_sample-kernel| {lib_err:.3e}, another order of operations)")
    g6, err, err_k6 = packed_err[sev]
    geo6 = kern.elastic_packed_geometry(b, g6, h, w, c, kern.multiprocessors(dev))
    k6_ms = ms
    ms = time_ms(lambda: kern.elastic_warp(x, ys, xs, sev, packed=True), reps=20)
    plain_ms = time_ms(lambda: plain.elastic_from_fields_packed(x, ys, xs, sev, g6), reps=3, warmup=1)
    report["elastic_warp_packed"] = {"kid": "K6p", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                     "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms}
    phase("kernels", f"K6p elastic_warp_packed (m={em}, G={g6}): max|kernel-plain| {err:.3e}, max|K6p-K6| "
                     f"{err_k6:.3e} (exact, and at severities 1-5: G "
                     f"{'/'.join(str(v[0]) for v in packed_err.values())}); {geo6.blocks} blocks, "
                     f"{geo6.shared_bytes} B shared; kernel {ms:.4f} ms, plain "
                     f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({by}, as K6), {ms / bound_ms:.2f}x the bound; "
                     f"grid_sample {library_ms:.4f} ms, K6 {k6_ms:.4f} ms")
    del got, ys, xs, x_nchw, grid
    check_k6p_small_batch(x)

    # K7 at the service's and the grid's shapes; K8 at the megastep's
    k7_report = check_k7(dev, gen, bound)
    k8_report = check_k8(x, bound)
    # K9a and K9b at an AugMix view's chain batch
    k9_report = check_k9(dev, gen, bound)

    # ── 4. the nano student against the JAX package's golden logits ──────
    model, meta = load_student("student_nano", device=dev)
    golden = json.loads((WEIGHTS_DIR / "student_nano.golden.json").read_text())
    gimg = np.random.default_rng(golden["seed"]).random(tuple(golden["shape"]), dtype=np.float32)
    with torch.no_grad():
        logits = model(torch.from_numpy(gimg).to(dev)).cpu().numpy()
    want_logits = np.asarray(golden["logits"], np.float32)
    gerr = float(np.abs(logits - want_logits).max())
    check(np.isfinite(logits).all(), "golden: non-finite logits")
    check(gerr <= GOLDEN_ATOL, f"golden: max |logit - JAX logit| {gerr} > {GOLDEN_ATOL}")
    top2 = np.sort(want_logits, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * GOLDEN_ATOL
    check(bool((logits.argmax(-1) == want_logits.argmax(-1))[clear].all()), "golden: argmax differs from JAX's")
    phase("golden", f"nano bf16 logits vs JAX: max abs diff {gerr:.4f} (tol {GOLDEN_ATOL}), argmax equal "
                    f"on the {int(clear.sum())} of {gimg.shape[0]} images with a clear margin")

    # ── 5. the megastep ────────────────────────────────────────────────────
    images = torch.rand((BATCH, 32, 32, 3), generator=gen, device=dev, dtype=torch.float32)
    megastep = make_megastep(model, BENCH_CELLS, dev)
    # one megastep, its launches counted from zero
    kern.reset_launch_counts()
    torch.cuda.synchronize()
    out = megastep(images, torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    counts = kern.launch_counts()
    check(counts == MEGASTEP_LAUNCHES, f"launch counts {counts}, expected {MEGASTEP_LAUNCHES}")
    vals = out.cpu()
    check(vals.shape == (3,) and bool(torch.isfinite(vals).all()), f"megastep output {vals}")
    check(bool(((vals >= 0) & (vals <= 1)).all()), f"megastep output outside [0, 1]: {vals}")
    phase("megastep", f"{len(BENCH_CELLS)} cells at batch {BATCH}: out {[round(float(v), 6) for v in vals]}; "
                      f"launches in one megastep {counts}")

    step_gen = torch.Generator().manual_seed(SEED)
    for _ in range(WARMUP):
        megastep(images, step_gen)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(ITERS):
        megastep(images, step_gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) / ITERS * 1e3
    img_s = BATCH * len(BENCH_CELLS) / (step_ms / 1e3)
    phase("megastep", f"{step_ms:.3f} ms/megastep, {img_s:.0f} img/s ({BATCH}x{len(BENCH_CELLS)} images, "
                      f"{ITERS} timed after {WARMUP} warm-up) on {smi}")

    # where the megastep's time goes: each family's corruption, and the forwards
    family_ms = {}
    for name, s in BENCH_CELLS:
        fn = kern.corruption_fn(name)
        family_ms[name] = time_ms(lambda: fn(SEED, images, s), reps=5)
    corrupted = kern.corruption_fn("gaussian_noise")(SEED, images, 3)
    with torch.no_grad():
        forward_ms = time_ms(lambda: model(corrupted), reps=5)
    del corrupted
    corrupt_ms = sum(family_ms.values())
    phase("megastep", f"breakdown (CUDA events): {len(BENCH_CELLS)} corruptions {corrupt_ms:.3f} ms, "
                      f"{len(BENCH_CELLS)} nano forwards {forward_ms * len(BENCH_CELLS):.3f} ms "
                      f"({forward_ms:.3f} ms each)")
    phase("megastep", "per-family corruption ms: " + ", ".join(f"{k} {v:.4f}" for k, v in family_ms.items()))

    kernel_out = megastep(images, torch.Generator().manual_seed(SEED + 99))
    plain_step = make_megastep(model, BENCH_CELLS, dev, corruption_fn=plain.corruption_fn)
    plain_out = plain_step(images, torch.Generator().manual_seed(SEED + 99))
    merr = float((kernel_out - plain_out).abs().max())
    check(merr <= MEGASTEP_TOL, f"megastep kernels vs plain: {kernel_out.tolist()} vs {plain_out.tolist()}")
    phase("megastep", f"kernels vs plain versions: max abs diff {merr:.3e} (tol {MEGASTEP_TOL})")
    if "--profile" in argv:
        profile_step(lambda: megastep(images, torch.Generator().manual_seed(SEED)), step_ms, "one megastep")

    # ── 6. the analysis service on scripted streams ───────────────────────
    monitor = monitor_phase(dev, profile="--profile" in argv)

    # ── 7. the grid's L1 pass into the policy replay ──────────────────────
    policy = policy_phase(model, images, dev)

    # ── 8. the AugMix training path of the classifier configuration ──────
    train = train_phase(dev, profile="--profile" in argv)

    # ── 9. the packed A/B: kernel arms and megastep arms ──────────────────
    ab = packed_phase(dev)
    packed_counts = ab["ab_packed"]["packed"]["launches"]

    # ── report ─────────────────────────────────────────────────────────────
    pallas = "fav_tpu/ops/corruptions_pallas.py"
    csrc = "fav_tpu_torch/ops/csrc"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    entries = []
    for name, src, replaces, launches in (
        ("gaussian_noise", "corruptions.cu", f"{pallas}:93", counts["gaussian_noise"]),
        ("shot_noise", "corruptions.cu", f"{pallas}:107", counts["shot_noise"]),
        ("impulse_noise", "corruptions.cu", f"{pallas}:100", counts["impulse_noise"]),
    ):
        r = report[name]
        entries.append({"name": f"{r['kid']} {name}", "route": "cuda", "source": f"{csrc}/{src}",
                        "replaces": replaces, "launches": launches, **{k: r[k] for k in keys},
                        "library_ms": r["library_ms"]})
        if name == "shot_noise":
            entries[-1]["library_note"] = "torch.poisson(x c), the draw only (no scale or clip), another stream"
            entries[-1]["variants"] = k2_report
    # K4 runs twice per megastep, once as each cell: its numbers are per launch,
    # averaged over the two, and each cell's own stand under "variants".
    b4, c4 = report["brightness"], report["contrast"]
    entries.append({
        "name": "K4 photometric", "route": "cuda", "source": f"{csrc}/corruptions.cu", "replaces": f"{pallas}:143",
        "launches": counts["photometric"], "max_abs_err": max(b4["max_abs_err"], c4["max_abs_err"]),
        "ms": (b4["ms"] + c4["ms"]) / 2, "plain_ms": (b4["plain_ms"] + c4["plain_ms"]) / 2,
        "bound_ms": (b4["bound_ms"] + c4["bound_ms"]) / 2, "bound_by": "bytes", "library_ms": None,
        "variants": {k: {f: report[k][f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms")}
                     for k in ("brightness", "contrast")},
    })
    for name, src, replaces, launches in (
        ("glass_resample", "glass.cu", f"{pallas}:295", counts["glass_resample"]),
        ("glass_resample_packed", "glass.cu", f"{pallas}:319", packed_counts["glass_resample_packed"]),
        ("elastic_warp", "elastic.cu", f"{pallas}:441", counts["elastic_warp"]),
        ("elastic_warp_packed", "elastic.cu", f"{pallas}:478", packed_counts["elastic_warp_packed"]),
    ):
        r = report[name]
        entries.append({"name": f"{r['kid']} {name}", "route": "cuda", "source": f"{csrc}/{src}",
                        "replaces": replaces, "launches": launches, **{k: r[k] for k in keys},
                        "library_ms": r["library_ms"]})
    signal_pallas = "fav_tpu/ops/signal_pallas.py"
    k7_top = k7_report["32x240x320"]
    entries.append({
        "name": "K7 frame_stats", "route": "cuda", "source": f"{csrc}/frame_stats.cu",
        "replaces": f"{signal_pallas}:51",
        "launches": monitor["counts"]["frame_stats"] + policy["counts"]["frame_stats"],
        **{k: k7_top[k] for k in keys}, "library_ms": k7_top["library_ms"],
        "library_note": "torch.bincount computes the histogram part only",
        "variants": k7_report,
    })
    k8_top = k8_report[f"sigma={K8_SIGMAS[-1]}"]
    entries.append({
        "name": "K8 corrupt_normalize", "route": "cuda", "source": f"{csrc}/corruptions.cu",
        "replaces": f"{pallas}:129", "launches": 0, **{k: k8_top[k] for k in keys}, "library_ms": None,
        "path_note": "no path of fav_tpu calls corrupt_normalize_pallas; held to its plain version only",
        "variants": k8_report,
    })
    augment_pallas = "fav_tpu/ops/augment_pallas.py"
    for name, replaces in (("shear_rows", f"{augment_pallas}:40"), ("shear_cols", f"{augment_pallas}:54")):
        r = k9_report[name]
        entries.append({"name": f"{r['kid']} {name}", "route": "cuda", "source": f"{csrc}/shear.cu",
                        "replaces": replaces, "launches": train["counts"][name], **{k: r[k] for k in keys},
                        "library_ms": r["library_ms"]})
    paths = {"megastep": counts, "monitor": monitor["counts"], "policy": policy["counts"], "train": train["counts"],
             "packed": packed_counts}
    kernel_keys = {"K1 gaussian_noise": "gaussian_noise", "K2 shot_noise": "shot_noise",
                   "K3 impulse_noise": "impulse_noise", "K4 photometric": "photometric",
                   "K5 glass_resample": "glass_resample", "K5p glass_resample_packed": "glass_resample_packed",
                   "K6 elastic_warp": "elastic_warp", "K6p elastic_warp_packed": "elastic_warp_packed",
                   "K7 frame_stats": "frame_stats", "K8 corrupt_normalize": "corrupt_normalize",
                   "K9a shear_rows": "shear_rows", "K9b shear_cols": "shear_cols"}
    for e in entries:
        e["launches_by_path"] = {path: c[kernel_keys[e["name"]]] for path, c in paths.items()}
    r = report["philox_uniform"]
    helpers = [{"name": "philox_uniform", "route": "cuda", "source": f"{csrc}/corruptions.cu",
                "replaces": None, "launches": counts["philox_uniform"], **{k: r[k] for k in keys},
                "library_ms": r["library_ms"], "library_note": "torch.rand(n), another stream",
                "launches_by_path": {path: c["philox_uniform"] for path, c in paths.items()}}]
    print(json.dumps({"kernels": entries, "helpers": helpers, "megastep_ms": step_ms, "img_per_s": img_s,
                      "family_ms": family_ms, "forward_ms": forward_ms,
                      "monitor": {k: v for k, v in monitor.items() if k != "counts"},
                      "policy_step_ms": policy["step_ms"],
                      "train": {k: v for k, v in train.items() if k != "counts"},
                      "packed_ab": {"median_ms": ab["median_ms"],
                                    "megastep": {arm: {k: ab["ab_packed"][arm][k]
                                                       for k in ("ms_per_megastep", "img_per_sec")}
                                                 for arm in ("packed", "unpacked")}}}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    faulthandler.dump_traceback_later(480, exit=True)
    rc = main(sys.argv[1:])
    faulthandler.cancel_dump_traceback_later()
    sys.exit(rc)
