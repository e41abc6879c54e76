"""The port's batched analysis service (``fav_tpu_torch.serving.analysis``)
against the port's own facade and against ``fav_tpu``'s service, and the
monitor golden that ``chip_smoke.py`` holds the card to.

The cases of ``tests/test_analysis_service.py`` run on the port's service
on the CPU (the plain versions): a stream matches the per-stream facade,
streams keep their own freeze state in a shared batch, padding rows do not
leak, a reused or reset slot restarts its temporal state, and capacity is
refused past its end. Tolerance classes: the port's service against the
port's facade, exact (the same code on the same device); against
``fav_tpu``'s service, statuses exact, the anomaly within 1e-5 and the raw
statistics within 1e-5 relative, each up to one rounding step of its
reported digits.

``fav_tpu_torch/weights/monitor.golden.json`` holds ``fav_tpu``'s statuses
and anomalies (``analyze_frame_jax``, float32) for every frame of two
streams of each scripted kind of the monitor run (``sim/frames.py``: 240x320,
60 ticks). Run as a script with ``--write`` to regenerate it:

    JAX_PLATFORMS=cpu python tests/test_torch_analysis_service.py --write

As a test, the golden must equal a fresh ``fav_tpu`` analysis (statuses
exact, anomalies within 1e-6 for float32 reassociation between XLA builds),
and the port's service must reproduce it on the CPU (statuses exact,
anomalies within 1e-5).
"""

from __future__ import annotations

import asyncio
import json
import os
import sys

import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from fav_tpu.config import AnalyzerParams as JaxAnalyzerParams  # noqa: E402
from fav_tpu.ops.signal import analyze_frame_jax, init_analyzer_carry  # noqa: E402
from fav_tpu_torch.sim.frames import GOLDEN_STREAMS, MONITOR_STREAMS, MONITOR_TICKS, scripted_stream  # noqa: E402

GOLDEN = os.path.join(REPO, "fav_tpu_torch", "weights", "monitor.golden.json")
GOLDEN_H, GOLDEN_W = 240, 320


def golden_frames() -> np.ndarray:
    """uint8 [ticks, len(GOLDEN_STREAMS), 240, 320, 3]: the golden streams' frames."""
    return np.stack([scripted_stream(*MONITOR_STREAMS[j], MONITOR_TICKS, GOLDEN_H, GOLDEN_W)
                     for j in GOLDEN_STREAMS], axis=1)


def jax_monitor(frames: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``fav_tpu``'s statuses (int) and anomalies (float32) [streams, ticks]."""
    params = JaxAnalyzerParams()
    carry = init_analyzer_carry(GOLDEN_H, GOLDEN_W, (frames.shape[1],))
    status, anomaly = [], []
    for frame in frames:
        carry, m = analyze_frame_jax(params, carry, jnp.asarray(frame))
        status.append(np.asarray(m.status))
        anomaly.append(np.asarray(m.anomaly_score, np.float32))
    return np.stack(status, 1), np.stack(anomaly, 1)


def write() -> None:
    status, anomaly = jax_monitor(golden_frames())
    golden = {
        "about": "fav_tpu analyze_frame_jax on the scripted monitor streams (fav_tpu_torch/sim/frames.py); "
                 "written by tests/test_torch_analysis_service.py --write",
        "height": GOLDEN_H,
        "width": GOLDEN_W,
        "ticks": MONITOR_TICKS,
        "streams": list(GOLDEN_STREAMS),
        "status": status.astype(int).tolist(),
        "anomaly": [[float(f"{v:.9g}") for v in row] for row in anomaly.astype(np.float64)],
    }
    with open(GOLDEN, "w") as f:
        json.dump(golden, f, separators=(",", ":"))
        f.write("\n")
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_analysis_service.py --write")
    import jax

    jax.config.update("jax_platforms", "cpu")
    write()
    sys.exit(0)

import pytest  # noqa: E402
import torch  # noqa: E402

from fav_tpu.ops.signal import SignalAnalyzer as JaxSignalAnalyzer  # noqa: E402
from fav_tpu.serving.analysis import AnalysisService as JaxAnalysisService  # noqa: E402
from fav_tpu_torch.config import AnalyzerParams  # noqa: E402
from fav_tpu_torch.ops.signal import SignalAnalyzer  # noqa: E402
from fav_tpu_torch.serving.analysis import BUCKETS, AnalysisService  # noqa: E402

H, W = 48, 64
ANOMALY_ATOL = 1e-5
RAW_RTOL = 1e-5
MONITOR_ATOL = 1e-5
GOLDEN_SELF_ATOL = 1e-6


def _frame(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (H, W, 3)).astype(np.uint8)


def _smooth(seed: int) -> np.ndarray:
    """A frame of the OK kind at 48x64."""
    return scripted_stream("ok", seed, 1, H, W)[0]


def _service(**kw) -> AnalysisService:
    return AnalysisService(AnalyzerParams(), height=H, width=W, device="cpu", **kw)


def _near(got: float, want: float, digits: int, tol: float) -> bool:
    """Equal after rounding to ``digits``, up to one rounding step where the
    unrounded values lie within ``tol`` of a rounding boundary."""
    return abs(got - want) <= 10.0 ** -digits + tol


def _assert_like_fav_tpu(got: dict, want: dict) -> None:
    assert got["vision_status"] == want["vision_status"]
    assert _near(got["anomaly_score"], want["anomaly_score"], 6, ANOMALY_ATOL)
    for k, digits in (("laplacian_var", 2), ("mean_brightness", 1), ("frame_diff", 2), ("entropy", 3)):
        w = want["metrics"]["raw"][k]
        assert _near(got["metrics"]["raw"][k], w, digits, abs(w) * RAW_RTOL + ANOMALY_ATOL), k


def test_service_matches_facade_and_fav_tpu_service():
    frames = [_smooth(0)] * 3 + [_frame(i) for i in range(3)]
    service = _service()
    jax_service = JaxAnalysisService(JaxAnalyzerParams(), height=H, width=W)

    async def run(svc):
        slot = svc.acquire_slot()
        out = [await svc.analyze(f, slot) for f in frames]
        svc.release_slot(slot)
        await svc.close()
        return out

    got = asyncio.run(run(service))
    want = asyncio.run(run(jax_service))
    facade = SignalAnalyzer(height=H, width=W, device="cpu")
    for g, w, f in zip(got, want, frames):
        assert g == facade.analyze_frame(f)
        _assert_like_fav_tpu(g, w)


def test_service_freeze_state_per_stream():
    """Two interleaved streams, one frozen and one live, in shared batches:
    the slot carries do not bleed into each other."""
    service = _service()
    frozen_frame = _smooth(1)

    async def run():
        s1, s2 = service.acquire_slot(), service.acquire_slot()
        out = []
        for i in range(7):
            out.append(await asyncio.gather(service.analyze(frozen_frame, s1),
                                            service.analyze(_smooth(100 + i), s2)))
        await service.close()
        return out

    out = asyncio.run(run())
    assert [a["vision_status"] for a, _ in out] == ["VISION_OK"] * 5 + ["VISION_FROZEN"] * 2
    assert all(b["vision_status"] == "VISION_OK" for _, b in out)


def test_service_concurrent_batch_is_one_dispatch():
    """Eight streams at once resolve in one batch of bucket 8; the scratch
    slot's padding rows leak into none of them."""
    service = _service()

    async def run():
        slots = [service.acquire_slot() for _ in range(8)]
        frames = [_frame(10 + i) for i in range(8)]
        results = await asyncio.gather(*[service.analyze(f, s) for f, s in zip(frames, slots)])
        await service.close()
        return frames, results

    frames, got = asyncio.run(run())
    assert service.dispatches == len(BUCKETS) + 1  # the warm-up runs each bucket once
    for f, g in zip(frames, got):
        assert g == SignalAnalyzer(height=H, width=W, device="cpu").analyze_frame(f)
        assert g["metrics"]["raw"]["frame_diff"] == 10.0


def test_service_counts_buckets_and_settles():
    """``buckets`` counts batches by bucket (the warm-up's too) and
    ``frames_analyzed`` the frames that came back; a caller that stops
    waiting leaves its frame outstanding until its batch is back, and
    ``scripted_serve.settle`` waits for that."""
    from fav_tpu_torch.tools.scripted_serve import settle

    service = _service()

    async def run():
        slot = service.acquire_slot()
        await service.analyze(_frame(1), slot)
        task = asyncio.get_running_loop().create_task(service.analyze(_frame(2), slot))
        await asyncio.sleep(0)
        outstanding = service.outstanding
        task.cancel()
        await settle(service)
        await service.close()
        return outstanding

    assert asyncio.run(run()) == 1
    assert service.outstanding == 0 and service.frames_analyzed == 2
    assert service.buckets == {1: 3, 8: 1, 32: 1} and service.dispatches == len(BUCKETS) + 2


def test_slot_reuse_resets_temporal_state():
    """release then acquire hands the slot to a new stream: the old
    stream's previous frame does not leak into it."""
    service = _service()
    f = _smooth(3)

    async def run():
        slot = service.acquire_slot()
        for _ in range(6):
            old = await service.analyze(f, slot)
        service.release_slot(slot)
        slot2 = service.acquire_slot()
        new = await service.analyze(f, slot2)
        await service.close()
        return old, new, slot, slot2

    old, new, slot, slot2 = asyncio.run(run())
    assert slot2 == slot
    assert old["vision_status"] == "VISION_FROZEN"
    assert new["vision_status"] != "VISION_FROZEN"
    assert new["metrics"]["raw"]["frame_diff"] == 10.0


def test_reset_slot_restarts_freeze_tracking():
    service = _service()
    f = _smooth(4)

    async def run():
        slot = service.acquire_slot()
        for _ in range(6):
            frozen = await service.analyze(f, slot)
        service.reset_slot(slot)
        after = [await service.analyze(f, slot) for _ in range(6)]
        await service.close()
        return frozen, after

    frozen, after = asyncio.run(run())
    assert frozen["vision_status"] == "VISION_FROZEN"
    assert [a["vision_status"] for a in after] == ["VISION_OK"] * 5 + ["VISION_FROZEN"]


def test_capacity_exhaustion_returns_none():
    service = _service(capacity=2)
    a, b = service.acquire_slot(), service.acquire_slot()
    assert {a, b} == {0, 1}
    assert service.acquire_slot() is None
    service.release_slot(b)
    assert service.acquire_slot() == b


def test_maybe_analyze_waits_for_the_warm_up():
    service = _service()

    async def run():
        slot = service.acquire_slot()
        first = await service.maybe_analyze(_frame(5), slot)
        for _ in range(200):
            if service.ready:
                break
            await asyncio.sleep(0.01)
        second = await service.maybe_analyze(_frame(5), slot)
        await service.close()
        return first, second

    first, second = asyncio.run(run())
    assert first is None and service.ready
    assert second["vision_status"] in ("VISION_OK", "VISION_CORRUPTED")


def test_service_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AnalysisService()


# ── the monitor golden ─────────────────────────────────────────────────────

@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        g = json.load(f)
    assert (g["height"], g["width"], g["ticks"]) == (GOLDEN_H, GOLDEN_W, MONITOR_TICKS)
    assert g["streams"] == list(GOLDEN_STREAMS)
    return np.asarray(g["status"]), np.asarray(g["anomaly"], np.float32)


@pytest.fixture(scope="module")
def frames():
    return golden_frames()


def test_golden_equals_fav_tpu(golden, frames):
    status, anomaly = jax_monitor(frames)
    np.testing.assert_array_equal(golden[0], status)
    np.testing.assert_allclose(golden[1], anomaly, atol=GOLDEN_SELF_ATOL, rtol=0)
    # every kind shows its status: ok, frozen from its sixth frame, blank, corrupted
    kinds = [MONITOR_STREAMS[j][0] for j in GOLDEN_STREAMS]
    for row, kind in zip(golden[0], kinds):
        want = {"ok": [0] * MONITOR_TICKS, "frozen": [0] * 5 + [1] * (MONITOR_TICKS - 5),
                "blank": [2] * MONITOR_TICKS, "corrupted": [3] * MONITOR_TICKS}[kind]
        assert row.tolist() == want, kind


def test_port_service_reproduces_the_golden(golden, frames):
    """The golden streams through the port's service on the CPU, all of a
    tick's frames submitted together."""
    service = AnalysisService(AnalyzerParams(), height=GOLDEN_H, width=GOLDEN_W, device="cpu")

    async def run():
        slots = [service.acquire_slot() for _ in GOLDEN_STREAMS]
        out = []
        for tick in frames:
            out.append(await asyncio.gather(*[service.analyze(f, s) for f, s in zip(tick, slots)]))
        await service.close()
        return out

    out = asyncio.run(run())
    status = np.array([[STATUS[r["vision_status"]] for r in tick] for tick in out]).T
    anomaly = np.array([[r["anomaly_score"] for r in tick] for tick in out]).T
    np.testing.assert_array_equal(status, golden[0])
    # the dicts round the anomaly to 6 digits
    np.testing.assert_allclose(anomaly, golden[1], atol=MONITOR_ATOL + 5e-7, rtol=0)


STATUS = {"VISION_OK": 0, "VISION_FROZEN": 1, "VISION_BLANK": 2, "VISION_CORRUPTED": 3}
