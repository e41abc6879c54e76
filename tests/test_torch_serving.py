"""The port's decision-support server (``fav_tpu_torch.serving.app``) on the
CPU, held to ``fav_tpu``'s.

* The HTTP/WS surface of ``tests/test_serving.py``: health, pages, static
  mount and traversal, the upload whitelist, streamed state keys, controls,
  malformed controls, the webcam fallback, get_log and reset, the
  playground round trip, the degraded wire field, the tick decoupled from
  slow analysis and its staleness, against ``create_app(device="cpu")``
  through the ``websockets`` client.
* The RFC 6455 and HTTP cases of ``tests/test_httpws_protocol.py`` against
  the port's ``HttpServer``, over raw sockets.
* The wire contract of ``tests/test_wire_contract.py`` applied to the
  port's emitted schema and ``fav_tpu/frontend/js``.
* The playground replay against ``fav_tpu``'s: exact (float64 on the host
  CPU on both sides), dict for dict.
* The live path in lockstep on the golden's scripted streams for both
  deployments: final statuses and policies exact, reliabilities within
  1e-6 of ``fav_tpu``'s app (``weights/serve.golden.json``; the analysis
  anomalies part by float32 reassociation, 1e-5, and reach the reliability
  only through the ML penalty).
* Entry points: ``create_app`` and ``python -m fav_tpu_torch.serving.app``
  raise without a card unless ``FAV_TORCH_DEVICE=cpu``; with it, two
  ``FAV_SERVER_WORKERS`` share one port and stop on SIGTERM.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import websockets

from test_httpws_protocol import _handshake, _mask_frame, _read_frame
from test_serving import _multipart
from test_wire_contract import _js_sources, _strip_strings_and_comments

from fav_tpu_torch.config import DEFAULT_CONFIG, FrameworkConfig, ModelParams, ServerParams
from fav_tpu_torch.serving import app as tapp
from fav_tpu_torch.serving.httpws import HttpServer, Response

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_APP = os.path.join(REPO, "fav_tpu_torch", "serving", "app.py")
PORT_INFERENCE = os.path.join(REPO, "fav_tpu_torch", "serving", "inference.py")
GOLDEN = os.path.join(REPO, "fav_tpu_torch", "weights", "serve.golden.json")
SMALL = ModelParams(widths=(8, 16), dense_width=16)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve_in_thread(make_server, port: int):
    """Run ``make_server()``'s HttpServer on ``port`` in its own loop and
    thread; yields, then stops it and cancels what is left."""
    loop = asyncio.new_event_loop()
    started, stop = threading.Event(), threading.Event()

    def run():
        asyncio.set_event_loop(loop)

        async def serve():
            server = await make_server().serve("127.0.0.1", port)
            started.set()
            while not stop.is_set():
                await asyncio.sleep(0.05)
            server.close()
            await server.wait_closed()
            for task in asyncio.all_tasks():
                if task is not asyncio.current_task():
                    task.cancel()
            await asyncio.sleep(0)

        loop.run_until_complete(serve())

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert started.wait(timeout=20)
    return stop, thread, loop


@pytest.fixture()
def app_server(tmp_path):
    """The port's app on the CPU with the real dashboard pages, the default
    deployment (nano scoring, batched analysis) and an upload dir in tmp."""
    port = _free_port()
    (tmp_path / "frontend" / "js").mkdir(parents=True)
    (tmp_path / "frontend" / "index.html").write_text("<html><body>fav_tpu dashboard</body></html>")
    (tmp_path / "frontend" / "js" / "app.js").write_text("// app")
    cfg = FrameworkConfig(server=ServerParams(host="127.0.0.1", port=port, upload_dir=str(tmp_path / "uploads")))
    stop, thread, loop = _serve_in_thread(
        lambda: tapp.create_app(cfg, frontend_dir=str(tmp_path / "frontend"), device="cpu"), port)
    yield f"127.0.0.1:{port}"
    stop.set()
    thread.join(timeout=10)
    loop.close()


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, b""


def _ws(uri, fn):
    async def session():
        async with websockets.connect(uri, open_timeout=10) as ws:
            return await fn(ws)

    return asyncio.run(session())


async def _recv(ws, timeout=10):
    return json.loads(await asyncio.wait_for(ws.recv(), timeout))


# ── HTTP ──────────────────────────────────────────────────────────────────


def test_health_pages_and_static(app_server):
    status, body = _get(f"http://{app_server}/health")
    assert status == 200 and json.loads(body) == {"status": "ok"}
    status, body = _get(f"http://{app_server}/")
    assert status == 200 and b"fav_tpu dashboard" in body
    assert _get(f"http://{app_server}/architecture")[0] == 404  # not in this frontend dir: a JSON 404
    status, body = _get(f"http://{app_server}/js/app.js")
    assert status == 200 and b"// app" in body
    assert _get(f"http://{app_server}/js/../index.html")[0] in (403, 404)  # traversal stays in the mount


@pytest.mark.parametrize("filename,expect", [("clip.mp4", 200), ("clip.WEBM", 200), ("evil.exe", 400),
                                             ("noext", 400)])
def test_upload_whitelist(app_server, tmp_path, filename, expect):
    body, ctype = _multipart(filename, b"fakevideo")
    req = urllib.request.Request(f"http://{app_server}/api/upload-video", data=body, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            code, out = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, out = e.code, None
    assert code == expect
    if expect == 200:
        assert out["filename"].endswith(os.path.splitext(filename)[1].lower()) and os.path.isfile(out["filepath"])
    assert _get(f"http://{app_server}/api/upload-video")[0] == 405


def test_real_pages_are_served(tmp_path):
    """Without ``frontend_dir`` the port serves ``fav_tpu/frontend`` by path."""
    port = _free_port()
    cfg = FrameworkConfig(server=ServerParams(model_scoring=False, batched_analysis=False))
    stop, thread, loop = _serve_in_thread(lambda: tapp.create_app(cfg, device="cpu"), port)
    try:
        css = sorted(os.listdir(os.path.join(REPO, "fav_tpu", "frontend", "css")))[0]
        for page in ("/", "/architecture", "/playground", "/js/app.js", f"/css/{css}"):
            status, body = _get(f"http://127.0.0.1:{port}{page}")
            assert status == 200 and body, page
        metrics = json.loads(_get(f"http://127.0.0.1:{port}/api/metrics")[1])
        assert metrics["inference"] is None  # model_scoring off
    finally:
        stop.set()
        thread.join(timeout=10)
        loop.close()


# ── /ws ───────────────────────────────────────────────────────────────────


def test_ws_streams_the_jax_apps_keys(app_server):
    with open(GOLDEN) as f:
        keys = json.load(f)["ws_state_keys"]
    state = _ws(f"ws://{app_server}/ws", _recv)
    assert set(keys) <= set(state) and state["source_mode"] == "simulation"


def test_ws_control_frozen_decay(app_server):
    async def fn(ws):
        await ws.send(json.dumps({"action": "set_tick_rate", "rate": 60}))
        await ws.send(json.dumps({"action": "set_vision", "mode": "frozen"}))
        return [await _recv(ws) for _ in range(40)]

    states = _ws(f"ws://{app_server}/ws", fn)
    frozen = [s["reliability"] for s in states if s["vision_status"] == "VISION_FROZEN"]
    assert states[-1]["vision_status"] == "VISION_FROZEN" and frozen[-1] < frozen[0] <= 1.0
    assert states[-1]["dt"] < 0.03  # 60 Hz


def test_ws_get_log_reset_and_tick_rate_clamp(app_server):
    async def fn(ws):
        for _ in range(3):
            await _recv(ws)
        await ws.send(json.dumps({"action": "get_log"}))
        log = None
        for _ in range(20):
            msg = await _recv(ws)
            if msg.get("type") == "log_data":
                log = msg
                break
        await ws.send(json.dumps({"action": "reset"}))
        await ws.send(json.dumps({"action": "set_tick_rate", "rate": 9999}))
        states = [await _recv(ws) for _ in range(12)]
        return log, states

    log, states = _ws(f"ws://{app_server}/ws", fn)
    assert log["csv"].startswith("timestamp,reliability,policy_state") and log["entry_count"] >= 3
    assert log["events_csv"].startswith("start_time,duration_s") and log["event_count"] == 0
    assert min(s["dt"] for s in states[-4:]) < 0.03  # clamped to 60 Hz, not 9999


def test_ws_malformed_controls_survive(app_server):
    async def fn(ws):
        await ws.send("not json at all")
        await ws.send(json.dumps({"action": "set_tick_rate", "rate": "fast"}))
        await ws.send(json.dumps({"action": "set_noise", "level": "loud"}))
        await ws.send(json.dumps({"action": "set_brightness", "level": None}))
        errors = states = 0
        for _ in range(20):
            msg = await _recv(ws)
            errors += msg.get("type") == "error"
            states += "reliability" in msg
        await ws.send(json.dumps({"action": "set_vision", "mode": "blank"}))
        for _ in range(10):
            if (await _recv(ws)).get("vision_status") == "VISION_BLANK":
                return errors, states, True
        return errors, states, False

    errors, states, controllable = _ws(f"ws://{app_server}/ws", fn)
    assert errors >= 3 and states > 0 and controllable


@pytest.mark.parametrize("control,needle", [
    ({"action": "set_source_mode", "mode": "video", "filepath": "/nope.mp4"}, "Could not open video"),
    ({"action": "set_source_mode", "mode": "webcam", "device": 99}, "webcam"),
    ({"action": "set_source_mode", "mode": "radio"}, "Unknown source mode"),
])
def test_ws_source_mode_errors_fall_back(app_server, control, needle):
    async def fn(ws):
        await ws.send(json.dumps(control))
        err = None
        for _ in range(40):
            msg = await _recv(ws)
            if msg.get("type") == "error":
                err = msg
            elif err is not None and msg.get("source_mode") == "simulation":
                return err, msg
        return err, None

    err, state = _ws(f"ws://{app_server}/ws", fn)
    assert err is not None and needle.lower() in err["message"].lower() and state is not None


# ── /ws/playground and the replay ─────────────────────────────────────────


def test_playground_ws_roundtrip_equals_golden(app_server):
    with open(GOLDEN) as f:
        golden = json.load(f)["playground"]

    async def fn(ws):
        await ws.send("garbage")  # skipped, the socket stays up
        await ws.send(json.dumps({"action": "nope"}))
        err = await _recv(ws)
        await ws.send(json.dumps({"action": "simulate_sequence", "events": golden["events"]}))
        return err, await _recv(ws, 30)

    err, out = _ws(f"ws://{app_server}/ws/playground", fn)
    assert err == {"type": "error", "message": "unknown action"}
    assert out["type"] == "simulation_result" and out["results"] == golden["results"]


@pytest.mark.parametrize("events", [
    [{"status": "VISION_OK", "noise": 0.1, "brightness": 0.5, "frames": 40},
     {"status": "VISION_CORRUPTED", "noise": 0.6, "brightness": 0.3, "frames": 25},
     {"status": "VISION_OK", "noise": 0.0, "brightness": 0.5, "frames": 60}],
    [{"status": "VISION_FROZEN", "frames": 50}, {"status": "VISION_BLANK", "frames": 30},
     {"status": "VISION_OK", "noise": 0.9, "brightness": 0.1, "frames": 200}],
    [{"status": "VISION_OK", "frames": 3}, {"status": "BOGUS", "frames": 4}, {"frames": -2}],
    [],
])
def test_playground_replay_equals_fav_tpu(events):
    """Exact: both replay in float64 on the host CPU (the port's torch scan,
    fav_tpu's lax.scan) and round to the same digits."""
    from fav_tpu.config import DEFAULT_CONFIG as JCFG
    from fav_tpu.serving.app import run_playground_sequence as jrun

    got = tapp.run_playground_sequence(events, DEFAULT_CONFIG)
    assert got == jrun(events, JCFG)
    assert len(got) == sum(max(0, e.get("frames", 0)) for e in events)


def test_playground_matches_host_engine():
    """The scan replay equals the port's host TrustEngine driven by the same
    seed-99 stream at dt = 1/30 (tests/test_serving.py's check, 1e-9)."""
    from fav_tpu_torch.core.trust import TrustEngine
    from fav_tpu_torch.sim.anomaly_sim import AnomalySimulator

    events = [{"status": "VISION_OK", "noise": 0.1, "brightness": 0.5, "frames": 40},
              {"status": "VISION_CORRUPTED", "noise": 0.6, "brightness": 0.3, "frames": 25},
              {"status": "VISION_OK", "noise": 0.0, "brightness": 0.5, "frames": 60}]
    got = tapp.run_playground_sequence(events)
    engine, sim = TrustEngine(DEFAULT_CONFIG.trust), AnomalySimulator(seed=99, params=DEFAULT_CONFIG.anomaly_sim)
    i = 0
    for e in events:
        for _ in range(e["frames"]):
            s = engine.update(e["status"], sim.compute_anomaly(e["noise"], e["brightness"], e["status"]), 1 / 30)
            assert got[i]["reliability"] == pytest.approx(s["reliability"], abs=1e-9)
            assert got[i]["policy_state"] == s["policy_state"]
            assert got[i]["anomaly_integral"] == pytest.approx(s["anomaly_integral"], abs=1e-9)
            i += 1


# ── the live path ─────────────────────────────────────────────────────────


class StubVideo:
    """tests/test_serving.py:577-588's source: a new random 48x64 frame a call."""

    frame_id = 0

    def get_frame(self):
        self.frame_id += 1
        rng = np.random.default_rng(self.frame_id)
        return rng.integers(0, 256, (48, 64, 3)).astype(np.uint8), self.frame_id

    def stop(self):
        pass


def _live_conn(**kw) -> tapp.ConnectionState:
    conn = tapp.ConnectionState(FrameworkConfig(model=SMALL), device="cpu")
    conn.inference = kw.get("inference")
    conn.analysis = None  # 48x64 frames: the per-connection analyzer
    conn.source_mode = "video"
    conn.video = StubVideo()
    return conn


def test_tick_live_degraded_wire_field(tmp_path):
    from fav_tpu_torch.serving.inference import InferenceService

    conn = _live_conn(inference=InferenceService(SMALL, checkpoint_dir=str(tmp_path / "none"), device="cpu"))

    async def run():
        deadline = asyncio.get_running_loop().time() + 60.0
        while asyncio.get_running_loop().time() < deadline:
            await tapp._tick_live(conn, 1 / 30)
            if conn.last_inference and conn.last_analysis:
                break
            await asyncio.sleep(0.02)
        assert conn.last_inference, "model never warmed"
        assert conn.inference.degraded is True
        conn.last_inference = dict(conn.last_inference, model_anomaly=1.0)
        conn.config = conn.config.replace(server=ServerParams(use_model_anomaly=True))
        state = await tapp._tick_live(conn, 1 / 30)
        analysis = conn.last_analysis
        await conn.inference.close()
        conn.stop_pipeline()
        return state, analysis

    state, analysis = asyncio.run(run())
    assert state["model_degraded"] is True and "ml_inference" in state
    assert state["anomaly_score"] == round(analysis["anomaly_score"], 6) < 1.0  # the degraded 1.0 stays out


def test_tick_live_decoupled_from_slow_analysis():
    conn = _live_conn()
    real = conn.analyzer.analyze_frame

    def slow(frame):
        time.sleep(0.15)
        return real(frame)

    conn.analyzer.analyze_frame = slow

    async def run():
        t0 = time.monotonic()
        state = await tapp._tick_live(conn, 1 / 30)
        assert (time.monotonic() - t0) * 1e3 < 100
        assert state.get("waiting_for_frame") or state.get("analysis_warming") or "staleness_ms" in state
        for _ in range(100):
            if conn.last_analysis:
                break
            await asyncio.sleep(0.02)
        assert conn.last_analysis
        t0 = time.monotonic()
        states = [await tapp._tick_live(conn, 1 / 30) for _ in range(10)]
        assert (time.monotonic() - t0) * 1e3 < 500
        assert all(s["frame_id"] == conn.analysis_frame_id and s["staleness_ms"] >= 0 for s in states)
        assert states[-1]["staleness_ms"] > states[0]["staleness_ms"]
        conn.stop_pipeline()

    asyncio.run(run())


def test_tick_live_staleness_resets_on_fresh_analysis():
    conn = _live_conn()

    async def run():
        await tapp._tick_live(conn, 1 / 30)
        for _ in range(300):
            if conn.last_analysis:
                break
            await asyncio.sleep(0.01)
        fid1 = (await tapp._tick_live(conn, 1 / 30))["frame_id"]
        for _ in range(300):
            if conn.analysis_frame_id > fid1:
                break
            await asyncio.sleep(0.01)
        s2 = await tapp._tick_live(conn, 1 / 30)
        assert s2["frame_id"] > fid1 and s2["staleness_ms"] < 1000.0
        conn.stop_pipeline()

    asyncio.run(run())


@pytest.mark.parametrize("name", ["msp", "gated"])
def test_live_lockstep_equals_fav_tpu_app(name):
    """The golden's eight scripted streams (two of each kind), 60 ticks,
    with the AnalysisService (240x320, capacity 64) and the deployment's
    InferenceService on the CPU, driven in lockstep as the golden was:
    final statuses and policies exact, reliabilities within 1e-6."""
    from test_torch_inference import port_service

    from fav_tpu_torch.serving.analysis import AnalysisService
    from fav_tpu_torch.sim.frames import GOLDEN_STREAMS, MONITOR_STREAMS, scripted_stream
    from fav_tpu_torch.tools.scripted_serve import SERVE_TICKS, drive_lockstep, final_states, warm_services

    with open(GOLDEN) as f:
        golden = json.load(f)["deployments"][name]["states"]
    clips = [scripted_stream(*MONITOR_STREAMS[j], SERVE_TICKS) for j in GOLDEN_STREAMS]

    async def run():
        inference = port_service(name)
        analysis = AnalysisService(DEFAULT_CONFIG.analyzer, 240, 320, capacity=64, device="cpu")
        await warm_services(inference, analysis)
        conns = []
        for _ in clips:
            c = tapp.ConnectionState(DEFAULT_CONFIG, device="cpu")
            c.inference, c.analysis = inference, analysis
            conns.append(c)
        analysis.dispatches = 0
        states = await drive_lockstep(tapp, conns, clips)
        dispatches = analysis.dispatches
        await inference.close()
        await analysis.close()
        return states, dispatches

    states, dispatches = asyncio.run(run())
    # the eight streams' frames of a tick in one batch, unless a loaded host
    # lets the 4 ms collection window close early and splits a wave
    assert SERVE_TICKS <= dispatches <= 2 * SERVE_TICKS
    for got, j in zip(final_states(states), GOLDEN_STREAMS):
        want = golden[j]
        assert (got["vision_status"], got["policy_state"]) == (want["vision_status"], want["policy_state"])
        assert got["reliability"] == pytest.approx(want["reliability"], abs=1e-6)
    last = states[-1]
    assert all("ml_inference" in s and "signal_metrics" in s and "model_degraded" not in s for s in last)
    assert all(("confidence_self" in s["ml_inference"]) == (name == "gated") for s in last)


# ── the wire contract (tests/test_wire_contract.py) on the port's schema ──


@pytest.fixture(scope="module")
def port_schema():
    from fav_tpu_torch.core.trust import TrustEngine

    engine_keys = set(TrustEngine(DEFAULT_CONFIG.trust).update("VISION_OK", 0.02, 1 / 30))
    with open(PORT_APP, encoding="utf-8") as f:
        app_src = f.read()
    attached = set(re.findall(r'state\["(\w+)"\]\s*=', app_src))
    reply_keys = {"type", "message", "mode", "csv", "entry_count", "events_csv", "event_count", "results"}
    for k in reply_keys - {"type"}:
        assert f'"{k}"' in app_src, k
    return {"state_keys": engine_keys | attached, "reply_types": set(re.findall(r'"type":\s*"(\w+)"', app_src)),
            "reply_keys": reply_keys, "app_src": app_src}


def test_every_js_msg_field_is_emitted(port_schema):
    read = set()
    for src in _js_sources().values():
        read |= set(re.findall(r"\bmsg\.([A-Za-z_]\w*)", _strip_strings_and_comments(src)))
    assert read and not read - (port_schema["state_keys"] | port_schema["reply_keys"])


def test_every_js_action_is_dispatched(port_schema):
    src = port_schema["app_src"]
    dispatched = set(re.findall(r'action == "(\w+)"', src)) | set(re.findall(r'msg\.get\("action"\) == "(\w+)"', src))
    sent = set()
    for js in _js_sources().values():
        sent |= set(re.findall(r"""action:\s*["']([a-z_]+)["']""", js))
    assert sent >= {"set_vision", "set_noise", "set_brightness", "reset", "set_tick_rate", "get_log",
                    "set_source_mode", "simulate_sequence"}
    assert not sent - dispatched


def test_every_js_message_type_is_emitted(port_schema):
    branched = set()
    for js in _js_sources().values():
        branched |= set(re.findall(r"""type\s*===?\s*["']([a-z_]+)["']""", js))
    assert branched and not branched - port_schema["reply_types"]


def test_nested_fields_match_the_ports_producers():
    from fav_tpu_torch.ops.signal import SignalAnalyzer
    from fav_tpu_torch.sim.vision_sim import VisionSimulator

    js = "".join(_strip_strings_and_comments(s) for s in _js_sources().values())
    metrics = set(SignalAnalyzer(DEFAULT_CONFIG.analyzer, device="cpu")
                  .analyze_frame(np.zeros((240, 320, 3), np.uint8))["metrics"])
    read = set(re.findall(r"signal_metrics\.(\w+)", js))
    assert read and read <= metrics
    frame_reads = {a or b for a, b in re.findall(r"\bmsg\.frame\.(\w+)|\bframe\.(\w+)", js)}
    frame_reads &= {"mode", "noise_level", "brightness", "vision_status"}
    assert frame_reads and frame_reads <= set(VisionSimulator().get_frame_descriptor())
    results = tapp.run_playground_sequence([{"status": "VISION_OK", "frames": 3}])
    pg = set(re.findall(r"\b(?:r|pt|row|res)\.(\w+)", _strip_strings_and_comments(_js_sources()["playground.js"])))
    pg &= set(results[0]) | {"sim_time", "reliability", "policy_state", "vision_status", "anomaly_score"}
    assert pg and pg <= set(results[0])


def test_ml_inference_fields_match_the_ports_service():
    """Every ``ml_inference`` field the JS reads is produced by the port's
    service, ``feature_distance`` included (served with a Mahalanobis
    fit), which the JS reads only behind an ``!== undefined`` guard."""
    with open(PORT_INFERENCE, encoding="utf-8") as f:
        src = f.read()
    produced = set(re.findall(r'"(\w+)":\s*(?:int|round|float)\(', src))
    produced |= set(re.findall(r'res\["(\w+)"\]\s*=\s*(?:int|round|float)\(', src))
    app_js = _js_sources()["app.js"]
    read = set(re.findall(r"ml_inference\.(\w+)", _strip_strings_and_comments(app_js)))
    assert "feature_distance" in read and read - produced == set()
    assert "msg.ml_inference.feature_distance !== undefined" in app_js


# ── the HTTP/WebSocket runtime (tests/test_httpws_protocol.py) ─────────────


@pytest.fixture(scope="module")
def echo_server():
    def make():
        server = HttpServer()

        async def echo(request, ws):
            while True:
                await ws.send_text("echo:" + await ws.receive_text())

        async def hello(request):
            return Response.json({"hi": True})

        server.ws("/echo", echo)
        server.route("GET", "/hello", hello)
        return server

    port = _free_port()
    stop, thread, loop = _serve_in_thread(make, port)
    yield port
    stop.set()
    thread.join(timeout=10)
    loop.close()


@pytest.mark.parametrize("frames,expect", [
    ([(0x1, b"hello", True)], [(0x1, b"echo:hello")]),
    ([(0x1, b"one-", False), (0x0, b"two-", False), (0x0, b"three", True)], [(0x1, b"echo:one-two-three")]),
    ([(0x9, b"beat", True)], [(0xA, b"beat")]),
    ([(0x1, b"a", False), (0x9, b"p", True), (0x0, b"b", True)], [(0xA, b"p"), (0x1, b"echo:ab")]),
    ([(0x1, b"x" * 40_000, True)], [(0x1, b"echo:" + b"x" * 40_000)]),
    ([(0x1, b"y" * 70_000, True)], [(0x1, b"echo:" + b"y" * 70_000)]),
    ([(0x8, struct.pack(">H", 1000), True)], [(0x8, struct.pack(">H", 1000))]),
], ids=["text", "fragments", "ping", "ping-between-fragments", "16-bit-length", "64-bit-length", "close"])
def test_websocket_frames(echo_server, frames, expect):
    s = _handshake(echo_server)
    try:
        for opcode, payload, fin in frames:
            s.sendall(_mask_frame(opcode, payload, fin=fin))
        got = [_read_frame(s)[1:] for _ in expect]
        if expect[-1][0] == 0x8:
            assert [(op, p[:2]) for op, p in got] == expect
        else:
            assert sorted(got) == sorted(expect)
    finally:
        s.close()


def _raw(port: int, data: bytes, timeout: float = 5.0) -> bytes:
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    try:
        s.sendall(data)
        s.settimeout(timeout)
        try:
            return s.recv(4096)
        except socket.timeout:
            return b"<timeout>"
    finally:
        s.close()


def test_http_404_keepalive_and_bad_framing(echo_server):
    head = _raw(echo_server, b"GET /nope HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                             b"Sec-WebSocket-Key: dGVzdA==\r\n\r\n")
    assert b"404" in head.split(b"\r\n")[0]
    assert _raw(echo_server, b"POST /hello HTTP/1.1\r\nHost: x\r\nContent-Length: banana\r\n\r\n") == b""
    s = socket.create_connection(("127.0.0.1", echo_server), timeout=5)
    for _ in range(2):  # two requests on one connection
        s.sendall(b"GET /hello HTTP/1.1\r\nHost: x\r\n\r\n")
        buf = b""
        while b"\r\n\r\n" not in buf:
            buf += s.recv(4096)
        head, _, body = buf.partition(b"\r\n\r\n")
        n = int([ln for ln in head.split(b"\r\n") if b"Content-Length" in ln][0].split(b":")[1])
        while len(body) < n:
            body += s.recv(4096)
        assert json.loads(body) == {"hi": True}
    s.close()


def test_slow_body_times_out(echo_server, monkeypatch):
    from fav_tpu_torch.serving import httpws

    monkeypatch.setattr(httpws, "_BODY_TIMEOUT_BASE", 0.3)
    t0 = time.time()
    assert _raw(echo_server, b"POST /hello HTTP/1.1\r\nHost: x\r\nContent-Length: 1000\r\n\r\npartial") == b""
    assert time.time() - t0 < 4.0


def test_garbage_and_churn_leave_the_listener_alive(echo_server):
    import random

    rnd = random.Random(0xFA5)
    for probe in (b"\x00\xff\xfe\xfd" * 64, b"GET\r\n\r\n", b"GET / HTTP/1.1\r\nContent-Length: -5\r\n\r\n",
                  b"GET /hello HTTP/1.1\r\nX-Pad: " + b"A" * 70000 + b"\r\n\r\n",
                  b"GET /echo HTTP/1.1\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n\r\n",
                  bytes(rnd.getrandbits(8) for _ in range(512))):
        _raw(echo_server, probe, timeout=1.0)
        assert b"200" in _raw(echo_server, b"GET /hello HTTP/1.1\r\nHost: x\r\n\r\n").split(b"\r\n")[0]
    for i in range(100):
        s = _handshake(echo_server)
        s.sendall(_mask_frame(0x1, b"m%d" % i))
        assert _read_frame(s)[2] == b"echo:m%d" % i
        s.close()


# ── entry points ──────────────────────────────────────────────────────────


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("FAV_")}
    env.update({"PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}, **extra)
    return env


def test_no_card_and_no_cpu_request_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapp.create_app()
    with pytest.raises(RuntimeError):
        tapp.ConnectionState(DEFAULT_CONFIG)
    out = subprocess.run([sys.executable, "-m", "fav_tpu_torch.serving.app"], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "device='cpu'" in out.stderr


def test_workers_share_a_port_on_the_cpu(tmp_path):
    """FAV_SERVER_WORKERS=2 with FAV_TORCH_DEVICE=cpu: two spawned workers
    answer on one port, and SIGTERM stops the whole tree."""
    port = _free_port()
    log = tmp_path / "workers.log"
    env = _env(FAV_TORCH_DEVICE="cpu", FAV_SERVER_WORKERS="2", FAV_SERVER_HOST="127.0.0.1",
               FAV_SERVER_PORT=str(port), FAV_SERVER_UPLOAD_DIR=str(tmp_path / "uploads"))
    with open(log, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", "fav_tpu_torch.serving.app"], cwd=REPO, env=env,
                                stdout=out, stderr=subprocess.STDOUT)
        try:
            deadline = time.time() + 120
            pids = set()
            while time.time() < deadline and len(pids) < 2:
                pids = set(re.findall(r"\(pid (\d+), device cpu\)", log.read_text()))
                time.sleep(0.2)
            assert len(pids) == 2, log.read_text()
            for _ in range(4):
                assert json.loads(_get(f"http://127.0.0.1:{port}/health")[1]) == {"status": "ok"}
        finally:
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=60)
    text = log.read_text()
    assert "2 workers" in text and "supervisor stopped" in text
