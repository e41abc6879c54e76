"""Interleaved A/B of the lane-packed glass and elastic kernels (K5p, K6p)
against the unpacked ones (K5, K6), and of the megastep with and without them.

    python -m fav_tpu_torch.tools.ab_packed_kernels [--batch 6144] [--iters 8] [--megastep]
    python -m fav_tpu_torch.tools.ab_packed_kernels --device cpu --batch 8 --iters 1

Counterpart of ``tools/ab_packed_kernels.py`` (the kernel arms, with its
arm names and flags) and of ``bench.py --ab-packed`` (``bench.py:149-169``,
the megastep arms), with ``packed`` passed explicitly in both arms: in
``bench.py`` the packed arm relied on the callees' defaults, which are
unpacked, so both of its arms ran unpacked.

The kernel arms ``glass_sev{3,5}_{packed,unpacked}`` and
``elastic_sev{3,5}_{packed,unpacked}`` each run the whole family
(``glass_blur``, ``elastic_transform`` of ``ops/corruptions_cuda.py``) on
one random batch with one seed; the packed and unpacked arms of a family
give the same batch bit for bit, and the report says whether they did.
``--megastep`` adds ``make_megastep(packed=True)`` and ``(packed=False)``
over ``BENCH_CELLS`` with the nano student: one megastep of each from
equal generators, its launch counts reset just before and read just after,
then the timed turns.

Every arm is run once to warm up, then the arms take turns ``iters``
times. On the card each call is timed by CUDA events recorded after a
synchronize; on the CPU (``--device cpu``) by the host clock. The report,
one JSON line: the median ms of each kernel arm and, with ``--megastep``,
ms per megastep and images/s of each megastep arm.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from fav_tpu_torch.device import resolve_device
from fav_tpu_torch.ops import corruptions_cuda as kern
from fav_tpu_torch.pipeline import BATCH, BENCH_CELLS, make_megastep
from fav_tpu_torch.utils.checkpoint import load_student

__all__ = ["SEVERITIES", "run_ab", "main"]

SEVERITIES = (3, 5)  # tools/ab_packed_kernels.py:49
FAMILIES = (("glass", kern.glass_blur), ("elastic", kern.elastic_transform))
SEED = 3  # the seed of tools/ab_packed_kernels.py's glass arms; the images and megastep seeds derive from it


def _arm(packed: bool) -> str:
    return "packed" if packed else "unpacked"


def _kernel_arms(x: torch.Tensor) -> dict:
    """``{arm name: fn()}`` in ``tools/ab_packed_kernels.py``'s order."""
    return {f"{family}_sev{sev}_{_arm(packed)}": (lambda f=fn, s=sev, p=packed: f(SEED, x, s, packed=p))
            for sev in SEVERITIES for family, fn in FAMILIES for packed in (True, False)}


def _timer(dev: torch.device):
    """``time(fn) -> ms`` of one call: CUDA events after a synchronize on the
    card, the host clock on the CPU."""
    if dev.type == "cuda":
        def time_cuda(fn) -> float:
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        return time_cuda

    def time_host(fn) -> float:
        t = time.perf_counter()
        fn()
        return (time.perf_counter() - t) * 1e3
    return time_host


def _interleaved(arms: dict, iters: int, time_ms) -> dict[str, list[float]]:
    times: dict[str, list[float]] = {name: [] for name in arms}
    for _ in range(iters):
        for name, fn in arms.items():
            times[name].append(time_ms(fn))
    return times


def _median(ts: list[float]) -> float:
    return sorted(ts)[len(ts) // 2]  # tools/ab_packed_kernels.py's median


def run_ab(batch: int = BATCH, iters: int = 8, megastep: bool = False, device: str | torch.device | None = None,
           log=print) -> dict:
    """The A/B on ``device`` (the card unless ``"cpu"`` is asked for);
    ``log`` takes one progress line per warmed arm. Returns the report."""
    dev = resolve_device(device)
    time_ms = _timer(dev)
    x = torch.rand((batch, 32, 32, 3), generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    arms = _kernel_arms(x)
    first = {}
    for name, fn in arms.items():
        t = time.perf_counter()
        first[name] = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        log(f"warm {name}: {time.perf_counter() - t:.3f}s")
    same = {}
    for sev in SEVERITIES:
        for family, _ in FAMILIES:
            a, b = first[f"{family}_sev{sev}_packed"], first[f"{family}_sev{sev}_unpacked"]
            same[f"{family}_sev{sev}"] = {"equal": bool(torch.equal(a, b)),
                                          "max_abs_diff": float((a - b).abs().max())}
    del first
    times = _interleaved(arms, iters, time_ms)
    report = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu", "batch": batch,
              "iters": iters, "median_ms": {name: _median(ts) for name, ts in times.items()},
              "packed_equals_unpacked": same}
    if megastep:
        report["ab_packed"] = _megastep_ab(x, iters, dev, time_ms, log)
    return report


def _megastep_ab(x: torch.Tensor, iters: int, dev: torch.device, time_ms, log) -> dict:
    """``bench.py --ab-packed``'s two arms with the nano student."""
    model, _ = load_student("student_nano", device=dev)
    steps = {arm: make_megastep(model, BENCH_CELLS, dev, packed=arm == "packed") for arm in ("packed", "unpacked")}
    out, launches = {}, {}
    for arm, step in steps.items():
        kern.reset_launch_counts()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out[arm] = step(x, torch.Generator().manual_seed(SEED))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        launches[arm] = kern.launch_counts()
        log(f"megastep {arm}: out {[round(float(v), 6) for v in out[arm]]}, launches "
            f"{ {k: v for k, v in launches[arm].items() if v} }")
    step_gen = torch.Generator().manual_seed(SEED + 1)
    times = _interleaved({arm: (lambda s=step: s(x, step_gen)) for arm, step in steps.items()}, iters, time_ms)
    report = {}
    for arm, ts in times.items():
        ms = _median(ts)
        report[arm] = {"ms_per_megastep": ms, "img_per_sec": x.shape[0] * len(BENCH_CELLS) / (ms / 1e3),
                       "out": out[arm].tolist(), "launches": launches[arm]}
    report["max_abs_diff"] = float((out["packed"] - out["unpacked"]).abs().max())
    return report


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--megastep", action="store_true", help="add bench.py --ab-packed's two megastep arms")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    report = run_ab(args.batch, args.iters, args.megastep, args.device)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
