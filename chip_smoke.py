#!/usr/bin/env python3
"""Drive fav_tpu_torch on one NVIDIA card: build the CUDA kernels, hold each
to its plain PyTorch version, run the fifteen-family detection megastep of
``bench.py``'s cells with the nano student, and report.

    python3 chip_smoke.py             # what the checks run
    python3 chip_smoke.py --profile   # adds a torch.profiler table of one megastep

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
               for K6, the time of ``grid_sample`` computing the same warp;
4. golden   -- the nano student's bf16 logits on fixed images against the
               JAX package's, committed in ``weights/student_nano.golden.json``;
5. megastep -- one megastep at batch 6144 over all fifteen cells with the
               launch counts reset just before and read just after (K1, K2,
               K3, K5, K6 once each, K4 twice); 2 warm-up and 8 timed
               megasteps; each family's corruption time; then one megastep
               against the same megastep through the plain versions.

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

# Tolerances of kernel against plain version, on the same inputs on the card.
K1_TOL = 1e-5  # logf/cosf/sqrtf ulps between the kernel's and PyTorch's builds
K4_CONTRAST_TOL = 1e-6  # the per-image mean is summed in another order
K2_MAX_TIE_FRACTION = 1e-4  # counts may differ only where u sits on a CDF partial sum
# K5 (pure selection) and K6 (the plain version's operations in its order,
# no contraction) are held to their plain versions exactly; so is the
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


def phase(name: str, msg: str = "") -> None:
    print(f"[chip_smoke] {name:9s} t={time.perf_counter() - T0:7.2f}s  {msg}".rstrip(), flush=True)


def card_peaks(name: str) -> tuple[float, float, str]:
    for key, bw, ops in CARD_PEAKS:
        if key in name:
            return bw, ops, key
    return 3.35e12, 67e12, "H100 SXM (assumed: card not in CARD_PEAKS)"


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def profile_megastep(megastep, images, step_ms: float) -> None:
    """Device time by kernel over one megastep (torch.profiler, CUPTI on the
    card), after one profiled warm-up step; the busy share is that device
    time over ``step_ms``, the megastep's wall time measured without the
    profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    tables = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: tables.append(p.key_averages())) as prof:
        for _ in range(2):
            megastep(images, torch.Generator().manual_seed(SEED))
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
        phase("profile", "no device time in the trace: not measured")
        return
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    phase("profile", f"one megastep: device kernels {busy_ms:.3f} ms of {step_ms:.3f} ms wall "
                     f"(busy share {busy_ms / step_ms:.3f}); top kernels by device time:")
    for e in kernels[:24]:
        print(f"           {dev_us(e) / 1e3:9.3f} ms {dev_us(e) / 1e3 / busy_ms:6.1%} x{e.count:<4d} {e.key[:100]}",
              flush=True)


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
        if name == "shot_noise":
            # terms beyond the first that this run's data needs: min(count, k_max - 1)
            k_max = plain.shot_k_max(sev)
            counts = plain.poisson_inverse_cdf(x * c, uniform01(seed, n, 0, device=dev).reshape(x.shape), k_max)
            terms = float(torch.clamp(counts, max=k_max - 1).sum())
            ops += SHOT_OPS_PER_TERM * terms
            bytes_moved += 4 * k_max
            extra += f", mean terms per element {1 + terms / n:.3f} of {k_max}"
        t_bytes, t_ops = bytes_moved / bw * 1e3, ops / peak_ops * 1e3
        bound_ms = max(t_bytes, t_ops)
        report[name] = {
            "kid": kid, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": bytes_moved, "ops": ops,
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

    # the Philox helper against uniform01, word for word
    seed = SEED + 11
    got = kern.uniform(seed, (n,), 1, dev)
    want = uniform01(seed, n, 1, device=dev)
    check(torch.equal(got, want), "philox_uniform: the helper's uniforms differ from uniform01")
    ms = time_ms(lambda: kern.uniform(seed, (n,), 1, dev), reps=20)
    plain_ms = time_ms(lambda: uniform01(seed, n, 1, device=dev), reps=3, warmup=1)
    bound_ms, by = bound(4 * n, PHILOX_UNIFORM_OPS * n)
    report["philox_uniform"] = {"kid": "helper", "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": bound_ms, "bound_by": by}
    phase("kernels", f"philox_uniform helper: bit-equal to uniform01 over {n} draws; kernel {ms:.4f} ms, "
                     f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({by})")

    # K5: the glass resample cascade, severity 3 (m = 2, 3 rounds)
    _, m, iters = plain.sev_param(plain.GLASS_SEV, sev)
    seed = SEED + 12
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
    del got, want

    # K6: the elastic warp on the fields of a seed, exact at every severity
    # (m = 2 .. 6), timed at severity 3 (alpha 3.5, m = 4)
    for level in range(1, len(plain.ELASTIC_SEV) + 1):
        fy, fx = plain.elastic_fields(SEED + 13, x, level, uniform=kern.uniform)
        got = kern.elastic_warp(x, fy, fx, level)
        diff = float((got - plain.elastic_from_fields(x, fy, fx, level)).abs().max())
        check(got.shape == x.shape and diff <= K5_K6_TOL,
              f"elastic_warp severity {level}: max diff {diff}, expected exact")
        if level == sev:
            ys, xs, err = fy, fx, diff
        del got, fy, fx
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
    del got, ys, xs, x_nchw, grid

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
    expected = {"gaussian_noise": 1, "shot_noise": 1, "impulse_noise": 1, "photometric": 2, "glass_resample": 1,
                "elastic_warp": 1, "philox_uniform": PHILOX_DRAWS_PER_MEGASTEP}
    check(counts == expected, f"launch counts {counts}, expected {expected}")
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
        profile_megastep(megastep, images, step_ms)

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
                        "library_ms": None})
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
    for name, src, replaces in (("glass_resample", "glass.cu", f"{pallas}:295"),
                                ("elastic_warp", "elastic.cu", f"{pallas}:441")):
        r = report[name]
        entries.append({"name": f"{r['kid']} {name}", "route": "cuda", "source": f"{csrc}/{src}",
                        "replaces": replaces, "launches": counts[name], **{k: r[k] for k in keys},
                        "library_ms": r["library_ms"]})
    r = report["philox_uniform"]
    helpers = [{"name": "philox_uniform", "route": "cuda", "source": f"{csrc}/corruptions.cu",
                "replaces": None, "launches": counts["philox_uniform"], **{k: r[k] for k in keys},
                "library_ms": None}]
    print(json.dumps({"kernels": entries, "helpers": helpers, "megastep_ms": step_ms, "img_per_s": img_s,
                      "family_ms": family_ms, "forward_ms": forward_ms}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    faulthandler.dump_traceback_later(480, exit=True)
    rc = main(sys.argv[1:])
    faulthandler.cancel_dump_traceback_later()
    sys.exit(rc)
