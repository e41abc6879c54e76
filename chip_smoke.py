#!/usr/bin/env python3
"""Drive fav_tpu_torch on one NVIDIA card: build the CUDA kernels, hold each
to its plain PyTorch version, run the five-family detection megastep with
the nano student, and report.

    python3 chip_smoke.py             # what the checks run
    python3 chip_smoke.py --profile   # adds a torch.profiler table of one megastep

Phases, each printing one ``[chip_smoke]`` line with its elapsed seconds:

1. device   -- exit non-zero at once without CUDA; print the card's name and
               power limit from nvidia-smi;
2. build    -- compile ``fav_tpu_torch/ops/csrc`` with plain nvcc for sm_90a
               into ``build/torch_kernels/`` (must stay under 60 s);
3. kernels  -- at the megastep's shape (6144, 32, 32, 3) float32, each kernel
               against its plain version on the card, with its time, the
               plain version's time and its bound;
4. golden   -- the nano student's bf16 logits on fixed images against the
               JAX package's, committed in ``weights/student_nano.golden.json``;
5. megastep -- 2 warm-up and 8 timed megasteps at batch 6144 with the launch
               counts reset just before and read just after; then one
               megastep against the same megastep through the plain versions.

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

# Tolerances of kernel against plain version, on the same inputs on the card.
K1_TOL = 1e-5  # logf/cosf/sqrtf ulps between the kernel's and PyTorch's builds
K4_CONTRAST_TOL = 1e-6  # the per-image mean is summed in another order
K2_MAX_TIE_FRACTION = 1e-4  # counts may differ only where u sits on a CDF partial sum
# Megastep through the kernels against the plain versions: the corrupted
# batches differ only as above, and the bf16 forward turns that into
# confidence changes far below 2e-3; a failure-rate step is 1/30720, so 2e-3
# allows some 60 images to cross conf = 0.5.
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
    for e in kernels[:16]:
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
    # float32 results compared below: matmuls in full float32 (the default);
    # cuDNN convolutions would take TF32, but the compared forward is bf16.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np

    from fav_tpu_torch.ops import _build
    from fav_tpu_torch.ops import corruptions as plain
    from fav_tpu_torch.ops import corruptions_cuda as kern
    from fav_tpu_torch.ops.random import uniform01
    from fav_tpu_torch.pipeline import BATCH, SLICE_CELLS, make_megastep
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
    for i, (name, kid, wrapper, plain_fn) in enumerate(specs):
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
    megastep = make_megastep(model, SLICE_CELLS, dev)
    step_gen = torch.Generator().manual_seed(SEED)
    kern.reset_launch_counts()
    torch.cuda.synchronize()
    for _ in range(WARMUP):
        out = megastep(images, step_gen)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(ITERS):
        out = megastep(images, step_gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) / ITERS * 1e3
    counts = kern.launch_counts()
    runs = WARMUP + ITERS
    expected = {"gaussian_noise": runs, "shot_noise": runs, "impulse_noise": runs, "photometric": 2 * runs}
    check(counts == expected, f"launch counts {counts}, expected {expected}")
    vals = out.cpu()
    check(vals.shape == (3,) and bool(torch.isfinite(vals).all()), f"megastep output {vals}")
    check(bool(((vals >= 0) & (vals <= 1)).all()), f"megastep output outside [0, 1]: {vals}")
    img_s = BATCH * len(SLICE_CELLS) / (step_ms / 1e3)
    phase("megastep", f"{step_ms:.3f} ms/megastep, {img_s:.0f} img/s ({BATCH}x{len(SLICE_CELLS)} images) "
                      f"on {smi}; out {[round(float(v), 6) for v in vals]}; launches {counts}")

    # where the megastep's time goes: the five corruptions against the five forwards
    fns = [(kern.corruption_fn(name), s) for name, s in SLICE_CELLS]
    corrupted = [fn(SEED, images, s) for fn, s in fns]
    with torch.no_grad():
        corrupt_ms = time_ms(lambda: [fn(SEED, images, s) for fn, s in fns], reps=3)
        forward_ms = time_ms(lambda: [model(c) for c in corrupted], reps=3)
    phase("megastep", f"breakdown: 5 corruptions {corrupt_ms:.3f} ms, 5 nano forwards {forward_ms:.3f} ms")
    del corrupted

    kernel_out = megastep(images, torch.Generator().manual_seed(SEED + 99))
    plain_step = make_megastep(model, SLICE_CELLS, dev, corruption_fn=plain.corruption_fn)
    plain_out = plain_step(images, torch.Generator().manual_seed(SEED + 99))
    merr = float((kernel_out - plain_out).abs().max())
    check(merr <= MEGASTEP_TOL, f"megastep kernels vs plain: {kernel_out.tolist()} vs {plain_out.tolist()}")
    phase("megastep", f"kernels vs plain versions: max abs diff {merr:.3e} (tol {MEGASTEP_TOL})")
    if "--profile" in argv:
        profile_megastep(megastep, images, step_ms)

    # ── report ─────────────────────────────────────────────────────────────
    src = "fav_tpu_torch/ops/csrc/corruptions.cu"
    pallas = "fav_tpu/ops/corruptions_pallas.py"
    entries = []
    for name, replaces, launches in (
        ("gaussian_noise", f"{pallas}:93", counts["gaussian_noise"]),
        ("shot_noise", f"{pallas}:107", counts["shot_noise"]),
        ("impulse_noise", f"{pallas}:100", counts["impulse_noise"]),
    ):
        r = report[name]
        entries.append({"name": f"{r['kid']} {name}", "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": None})
    # K4 runs twice per megastep, once as each cell: its numbers are per launch,
    # averaged over the two, and each cell's own stand under "variants".
    b, c = report["brightness"], report["contrast"]
    entries.append({
        "name": "K4 photometric", "route": "cuda", "source": src, "replaces": f"{pallas}:143",
        "launches": counts["photometric"], "max_abs_err": max(b["max_abs_err"], c["max_abs_err"]),
        "ms": (b["ms"] + c["ms"]) / 2, "plain_ms": (b["plain_ms"] + c["plain_ms"]) / 2,
        "bound_ms": (b["bound_ms"] + c["bound_ms"]) / 2, "bound_by": "bytes", "library_ms": None,
        "variants": {k: {f: report[k][f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms")}
                     for k in ("brightness", "contrast")},
    })
    print(json.dumps({"kernels": entries, "megastep_ms": step_ms, "img_per_s": img_s}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    faulthandler.dump_traceback_later(480, exit=True)
    rc = main(sys.argv[1:])
    faulthandler.cancel_dump_traceback_later()
    sys.exit(rc)
