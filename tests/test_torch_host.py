"""The port's host modules of the server against ``fav_tpu``'s, on the CPU.

Tolerance class: exact, everywhere. The port keeps copies of these modules
(it may import nothing of ``fav_tpu``), so the same inputs must give the
same outputs bit for bit:

* ``TrustEngine`` (the per-stream host engine) on random status runs,
  anomalies (some absent) and wall-clock dts: every state dict equal;
* ``FailureAttributor`` on those states: summaries, events and events CSV;
* ``SessionLogger``: the CSV bytes;
* ``AnomalySimulator`` on seeds 42 and 99 (``app.py:54-55``) and a third,
  after resets; ``VisionSimulator`` under every control;
* the config: every default of the new sections, the presets mapped onto
  the port's weights, ``config_from_env``;
* ``LatencyStats`` and ``StageTimer`` summaries;
* the native resize (built without libjpeg) and JPEG encoder, byte for
  byte against ``fav_tpu.native``, and the encoder order of ``io/jpeg.py``;
* ``VideoSource`` on a small clip (cv2, which this machine has).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest

from fav_tpu import config as jcfg
from fav_tpu.core.attribution import FailureAttributor as JAttributor
from fav_tpu.core.session_log import SessionLogger as JLogger
from fav_tpu.core.trust import TrustEngine as JEngine
from fav_tpu.sim.anomaly_sim import AnomalySimulator as JAnomaly
from fav_tpu.sim.vision_sim import VisionSimulator as JVision
from fav_tpu.utils.profiling import LatencyStats as JStats
from fav_tpu_torch import config as tcfg
from fav_tpu_torch.core.attribution import FailureAttributor
from fav_tpu_torch.core.session_log import SessionLogger
from fav_tpu_torch.core.trust import TrustEngine
from fav_tpu_torch.sim.anomaly_sim import AnomalySimulator
from fav_tpu_torch.sim.vision_sim import VisionSimulator
from fav_tpu_torch.utils.profiling import LatencyStats, StageTimer

STATUSES = jcfg.STATUS_NAMES


def _run(seed: int, ticks: int = 400):
    """(status, anomaly or None, dt, timestamp) per tick: runs of one status,
    20% of anomalies absent, dts as a wall clock gives them."""
    rng = np.random.default_rng(seed)
    out, t = [], 1_000.0
    while len(out) < ticks:
        status = STATUSES[int(rng.integers(0, 4))]
        for _ in range(int(rng.integers(1, 60))):
            dt = float(rng.uniform(0.005, 0.08))
            t += dt
            anomaly = None if rng.random() < 0.2 else float(rng.random() * rng.choice([0.05, 1.0]))
            out.append((status, anomaly, dt, t))
    return out[:ticks]


def _clock(ticks):
    it = iter([t for *_, t in ticks])
    return lambda: next(it)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_trust_engine_attributor_and_log_equal(seed):
    ticks = _run(seed)
    ours, theirs = TrustEngine(tcfg.TrustParams(), clock=_clock(ticks)), JEngine(jcfg.TrustParams(),
                                                                               clock=_clock(ticks))
    attr, jattr = FailureAttributor(), JAttributor()
    log, jlog = SessionLogger(), JLogger()
    for status, anomaly, dt, t in ticks:
        a, b = ours.update(status, anomaly, dt), theirs.update(status, anomaly, dt)
        assert a == b
        attr.update(a, t)
        jattr.update(b, t)
        assert attr.get_summary() == jattr.get_summary()
        log.log(a, anomaly or 0.0)
        jlog.log(b, anomaly or 0.0)
    assert dataclasses.asdict(ours.state) == dataclasses.asdict(theirs.state)
    assert (ours.reliability, ours.policy_state) == (theirs.reliability, theirs.policy_state)
    assert attr.get_events() == jattr.get_events() and attr.get_events_csv() == jattr.get_events_csv()
    assert log.get_csv().encode() == jlog.get_csv().encode() and log.entry_count == len(ticks)
    ours.reset()
    theirs.reset()
    assert dataclasses.asdict(ours.state) == dataclasses.asdict(theirs.state)


@pytest.mark.parametrize("seed", [42, 99, 7])
def test_anomaly_simulator_streams_equal(seed):
    rng = np.random.default_rng(seed)
    ours, theirs = AnomalySimulator(seed, tcfg.AnomalySimParams()), JAnomaly(seed, jcfg.AnomalySimParams())
    for i in range(600):
        if i == 300:
            ours.reset(seed)
            theirs.reset(seed)
        noise, brightness = float(rng.random()), float(rng.random())
        status = STATUSES[int(rng.integers(0, 4))]
        assert ours.compute_anomaly(noise, brightness, status) == theirs.compute_anomaly(noise, brightness, status)


def test_vision_simulator_equal():
    ours, theirs = VisionSimulator(), JVision()
    for mode, noise, bright in (("frozen", 0.3, 0.9), ("bogus", -1.0, 2.0), ("blank", 0.5, 0.5),
                                ("corrupted", 1.5, -0.2), ("normal", 0.0, 0.5)):
        for sim in (ours, theirs):
            sim.set_mode(mode)
            sim.set_noise(noise)
            sim.set_brightness(bright)
        assert ours.get_vision_status() == theirs.get_vision_status()
        assert ours.get_frame_descriptor() == theirs.get_frame_descriptor()
    ours.reset()
    theirs.reset()
    assert ours.get_frame_descriptor() == theirs.get_frame_descriptor()
    assert ours.VALID_MODES == theirs.VALID_MODES


@pytest.mark.parametrize("section", ["TrustParams", "AnalyzerParams", "AnomalySimParams", "VideoParams",
                                     "ModelParams", "ServerParams"])
def test_config_sections_equal(section):
    assert dataclasses.asdict(getattr(tcfg, section)()) == dataclasses.asdict(getattr(jcfg, section)())


def test_config_codes_names_and_tree():
    assert tcfg.STATUS_CODES == jcfg.STATUS_CODES and tcfg.POLICY_CODES == jcfg.POLICY_CODES
    for code in (-1, 0, 1, 2, 3):
        assert tcfg.status_name(code) == jcfg.status_name(code)
    for code in range(4):
        assert tcfg.policy_name(code) == jcfg.policy_name(code)
        assert tcfg.status_code(jcfg.STATUS_NAMES[code]) == code
    ours = {f.name for f in dataclasses.fields(tcfg.FrameworkConfig)}
    assert ours == {f.name for f in dataclasses.fields(jcfg.FrameworkConfig)} - {"mesh"}  # Queue 1 item 10
    assert tcfg.DEFAULT_CONFIG == tcfg.FrameworkConfig()


def test_gated_preset_names_the_ports_weights(monkeypatch):
    for k in list(os.environ):
        if k.startswith("FAV_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("FAV_PRESET", "gated")
    ours, theirs = tcfg.config_from_env(), jcfg.config_from_env()
    for field, name in (("checkpoint", "student_std"), ("monitor", "student_nano")):
        stem = getattr(ours.server, field)
        assert os.path.basename(stem) == os.path.basename(getattr(theirs.server, field)) == name
        assert os.path.isfile(stem + ".npz") and os.path.isfile(stem + ".metadata.json")
        assert os.sep + os.path.join("fav_tpu_torch", "weights") + os.sep in stem
    # a per-field variable wins over the preset, an empty one counts as unset
    monkeypatch.setenv("FAV_SERVER_MONITOR", "")
    monkeypatch.setenv("FAV_SERVER_PORT", "9123")
    monkeypatch.setenv("FAV_SERVER_USE_MODEL_ANOMALY", "yes")
    monkeypatch.setenv("FAV_VIDEO_UPLOAD_EXTENSIONS", ".mp4, .avi")
    ours, theirs = tcfg.config_from_env(), jcfg.config_from_env()
    assert ours.server.port == theirs.server.port == 9123
    assert ours.server.use_model_anomaly is theirs.server.use_model_anomaly is True
    assert ours.video == tcfg.VideoParams(upload_extensions=(".mp4", ".avi"))
    assert os.path.basename(ours.server.monitor) == "student_nano"
    monkeypatch.setenv("FAV_PRESET", "nope")
    with pytest.raises(ValueError, match="unknown"):
        tcfg.config_from_env()


def test_latency_stats_and_stage_timer_equal():
    rng = np.random.default_rng(5)
    ours, theirs = LatencyStats(), JStats()
    for v in np.concatenate([rng.lognormal(-6, 2, 500), [0.0, 1e-6, 50.0]]):
        ours.record(float(v))
        theirs.record(float(v))
    assert ours.summary() == theirs.summary()
    timer = StageTimer()
    with timer.stage("tick"):
        pass
    timer.record("analysis_device", 0.004)
    assert set(timer.summary()) == {"tick", "analysis_device"} and timer.summary()["tick"]["count"] == 1


def test_stage_timer_keeps_samples_when_asked():
    plain, kept = StageTimer(), StageTimer(keep_samples=True)
    for timer in (plain, kept):
        with timer.stage("tick"):
            pass
        timer.record("analysis_device", 0.004)
        timer.record("analysis_device", 0.002)
    assert plain.samples is None and kept.summary()["analysis_device"] == plain.summary()["analysis_device"]
    assert kept.samples["analysis_device"] == [0.004, 0.002] and len(kept.samples["tick"]) == 1


@pytest.fixture(scope="module")
def frame():
    return np.random.default_rng(11).integers(0, 256, (240, 320, 3), dtype=np.uint8)


@pytest.mark.parametrize("size", [(32, 32), (64, 48), (33, 17), (320, 240)])
def test_native_resize_equals_fav_tpu(frame, size):
    """Served geometry and others; the served one (240x320 -> 32x32) weighs
    pixels by halves and wholes, so it is exact under any FP contraction."""
    import fav_tpu.native as jn

    from fav_tpu_torch.native import resize_area

    np.testing.assert_array_equal(resize_area(frame, *size), jn.resize_area(frame, *size))


def test_frame_for_model_equals_fav_tpu(frame):
    from fav_tpu.serving.app import _frame_for_model as jfm
    from fav_tpu_torch.serving.app import _frame_for_model

    got = _frame_for_model(frame, 32)
    assert got.dtype == np.float32 and got.shape == (32, 32, 3)
    np.testing.assert_array_equal(got, jfm(frame, 32))


def test_native_jpeg_equals_fav_tpu_and_round_trips(frame):
    import fav_tpu.native as jn

    from fav_tpu_torch.native import jpeg_decode_bgr, jpeg_encode_bgr

    data = jpeg_encode_bgr(frame, 40)
    assert data == jn.jpeg_encode_bgr(frame, 40) and data[:2] == b"\xff\xd8"
    back = jpeg_decode_bgr(data)
    assert back.shape == frame.shape and np.array_equal(back, jn.jpeg_decode_bgr(data))
    assert jpeg_encode_bgr(np.zeros((4, 4), np.uint8)) is None
    assert jpeg_decode_bgr(b"not a jpeg") is None


def test_jpeg_encoder_order(frame, monkeypatch):
    """native, then cv2, then Pillow (``fav_tpu/io/jpeg.py:1-10``); the
    wire string is the base64 of the first encoder's bytes."""
    import base64

    from fav_tpu.io.jpeg import frame_to_base64_jpeg as jb64
    from fav_tpu_torch.io import jpeg

    assert jpeg.frame_to_base64_jpeg(frame) == jb64(frame) and jpeg.last_encoder() == "native"

    def broken(*_):
        raise RuntimeError("g++ could not build jpegio.cpp")

    monkeypatch.setattr("fav_tpu_torch.native.jpeg_encode_bgr", broken)
    b64 = jpeg.frame_to_base64_jpeg(frame, 40)
    assert jpeg.last_encoder() == "cv2" and base64.b64decode(b64)[:2] == b"\xff\xd8"
    monkeypatch.setattr(jpeg, "_HAS_CV2", False)
    assert jpeg.encode_jpeg(frame, 40)[:2] == b"\xff\xd8" and jpeg.last_encoder() == "pillow"


def test_video_source_reads_and_loops(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from fav_tpu_torch.io.video import VideoSource

    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 60, (160, 120))
    for i in range(6):
        writer.write(np.full((120, 160, 3), 40 * i, np.uint8))
    writer.release()
    src = VideoSource(tcfg.VideoParams())
    assert src.start(str(tmp_path / "missing.avi")) is False
    assert src.start(path) is True
    try:
        import time

        seen, deadline = set(), time.time() + 10
        while len(seen) < 8 and time.time() < deadline:  # more ids than frames: the file loops
            frame, fid = src.get_frame()
            if frame is not None:
                assert frame.shape == (240, 320, 3)  # resized to the processing size
                seen.add(fid)
            time.sleep(0.005)
        assert len(seen) >= 8 and min(seen) >= 1
    finally:
        src.stop()
    assert not src.running
