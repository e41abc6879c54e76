"""The decision-support application: routes, streaming loop, playground.

Behavioral parity target: ``platform/backend/main.py``. Same surface —

* pages ``/``, ``/architecture``, ``/playground`` (main.py:50-65),
* ``GET /health`` liveness (main.py:70-72),
* ``POST /api/upload-video`` with the extension whitelist
  .mp4/.avi/.mov/.mkv/.webm (main.py:77-94),
* ``WS /ws`` — per-connection component set and a tick loop at an adjustable
  1-60 Hz rate with simulation / webcam / video-file source modes
  (main.py:105-317),
* ``WS /ws/playground`` — batch event-sequence replay at fixed dt = 1/30
  with a fresh engine and seed-99 anomaly stream (main.py:322-366),

and the same control actions: ``set_source_mode, set_vision, set_noise,
set_brightness, reset, set_tick_rate, get_log`` (main.py:210-304).

The port of ``fav_tpu/serving/app.py`` to PyTorch on one NVIDIA card, with
the same routes, actions, wire schema and live pipeline. The card carries
the live path: every live frame goes through the batched analysis service
(``serving/analysis.py``, one K7 launch for each dispatched batch of
streams) or, where batched analysis is off or the frame is not
``process_height`` x ``process_width``, the stream's own
``SignalAnalyzer`` (K7 per frame), and through the micro-batched
``InferenceService`` (the bf16 student). The playground replay runs the
port's trust scan on the host CPU in float64, as ``fav_tpu`` does on
purpose (see :func:`run_playground_sequence`).

``create_app``, ``ConnectionState`` and the services take ``device=``: the
card unless ``"cpu"`` is asked for, and with no card they raise. ``python -m
fav_tpu_torch.serving.app`` reads it from ``FAV_TORCH_DEVICE`` (default
``cuda``). The static pages are ``fav_tpu/frontend/``'s files, read by path
(they are HTML, JS and CSS, not a module); ``frontend_dir`` overrides that.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import time
from dataclasses import dataclass, field

import numpy as np

import torch

from fav_tpu_torch.config import DEFAULT_CONFIG, STATUS_CODES, FrameworkConfig, policy_name, status_name
from fav_tpu_torch.core.attribution import FailureAttributor
from fav_tpu_torch.core.session_log import SessionLogger
from fav_tpu_torch.core.trust import TrustEngine
from fav_tpu_torch import native
from fav_tpu_torch.device import resolve_device
from fav_tpu_torch.io.jpeg import frame_to_base64_jpeg
from fav_tpu_torch.io.video import VideoSource
from fav_tpu_torch.ops.signal import SignalAnalyzer
from fav_tpu_torch.serving.analysis import AnalysisService
from fav_tpu_torch.serving.httpws import HttpServer, Request, Response, WebSocket, WebSocketClosed
from fav_tpu_torch.serving.inference import InferenceService
from fav_tpu_torch.sim.anomaly_sim import AnomalySimulator
from fav_tpu_torch.sim.vision_sim import VisionSimulator
from fav_tpu_torch.utils.profiling import StageTimer

__all__ = ["create_app", "ConnectionState", "run_playground_sequence", "main", "DEVICE_ENV"]

# the dashboard's pages, JS and CSS: fav_tpu's frontend files, read by path
_FRONTEND_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "fav_tpu", "frontend")

DEVICE_ENV = "FAV_TORCH_DEVICE"  # python -m fav_tpu_torch.serving.app's device, default cuda

STREAM_SEED = 42  # reference main.py:112
PLAYGROUND_SEED = 99  # reference main.py:327


@dataclass
class ConnectionState:
    """Per-connection component set (reference main.py:105-118)."""

    config: FrameworkConfig
    device: "str | torch.device | None" = None  # the stream analyzer's: the card unless "cpu"
    engine: TrustEngine = None
    vision: VisionSimulator = None
    anomaly: AnomalySimulator = None
    logger: SessionLogger = None
    attributor: FailureAttributor = None
    analyzer: SignalAnalyzer = None
    video: VideoSource = None
    source_mode: str = "simulation"
    tick_rate: float = 30.0
    last_time: float = 0.0
    last_frame_id: int = 0
    last_analysis: dict = field(default_factory=dict)
    last_inference: dict = field(default_factory=dict)
    inference: InferenceService | None = None  # shared, set by create_app
    analysis: "AnalysisService | None" = None  # shared, set by create_app
    analysis_slot: "int | None" = None  # this stream's device-resident carry slot
    timer: StageTimer | None = None  # shared, set by create_app
    # ── decoupled live pipeline (VERDICT r3 #2) ──
    # the wire tick never awaits a device round trip: a per-connection
    # pipeline task analyzes the newest frame continuously, the tick streams
    # the latest COMPLETED analysis (frame_id-tagged, staleness on the wire)
    pipeline_task: "asyncio.Task | None" = None
    pipe_frame_id: int = 0  # newest frame submitted to the pipeline
    analysis_frame_id: int = 0  # frame the current last_analysis describes
    analysis_done_t: float = 0.0  # monotonic completion time of last_analysis
    analysis_warming: bool = False  # analyzer still compiling (no result yet)
    seen_frame: bool = False  # the video source has produced at least 1 frame
    pending_encoded: "str | None" = None  # newest JPEG, attached by next tick
    encode_task: "asyncio.Task | None" = None  # in-flight JPEG encode (<=1)
    pipeline_error: "str | None" = None  # last transient pipeline failure

    def __post_init__(self):
        cfg = self.config
        self.engine = TrustEngine(cfg.trust)
        self.vision = VisionSimulator()
        self.anomaly = AnomalySimulator(seed=STREAM_SEED, params=cfg.anomaly_sim)
        self.logger = SessionLogger()
        self.attributor = FailureAttributor()
        self.analyzer = SignalAnalyzer(cfg.analyzer, cfg.video.process_height, cfg.video.process_width,
                                       device=self.device)
        self.video = VideoSource(cfg.video)
        self.tick_rate = float(cfg.video.default_tick_rate)

    def reset(self) -> None:
        """Full reset with reseeded RNG (reference main.py:284-291)."""
        self.engine.reset()
        self.vision.reset()
        self.anomaly.reset(STREAM_SEED)
        self.logger.reset()
        self.attributor.reset()
        self.analyzer.reset()
        if self.analysis is not None and self.analysis_slot is not None:
            self.analysis.reset_slot(self.analysis_slot)
        self.last_frame_id = 0
        self.last_analysis = {}
        self.last_inference = {}  # stale ML scores must not outlive a reset
        self.analysis_frame_id = 0
        self.pending_encoded = None
        self.pipeline_error = None

    def stop_pipeline(self) -> None:
        """Cancel the live pipeline task (mode switch / disconnect)."""
        if self.pipeline_task is not None:
            self.pipeline_task.cancel()
            self.pipeline_task = None
        if self.encode_task is not None:
            self.encode_task.cancel()
            self.encode_task = None
        self.pipe_frame_id = 0
        self.last_frame_id = 0
        self.analysis_frame_id = 0
        self.analysis_warming = False
        self.seen_frame = False
        self.pending_encoded = None
        self.pipeline_error = None


async def _tick_sim(conn: ConnectionState, dt: float) -> dict:
    """Simulation-mode tick (reference main.py:134-149)."""
    status = conn.vision.get_vision_status()
    score = conn.anomaly.compute_anomaly(
        conn.vision.noise_level, conn.vision.brightness, status
    )
    state = conn.engine.update(status, score, dt)
    state["anomaly_score"] = round(score, 6)
    state["dt"] = round(dt, 4)
    state["frame"] = conn.vision.get_frame_descriptor()
    return state


def _frame_for_model(frame_bgr, size: int):
    """BGR uint8 HxWx3 -> RGB float [size,size,3] in [0,1] for the CNN."""
    try:
        small = native.resize_area(frame_bgr, size, size)
    except RuntimeError:  # g++ missing: the resize library did not build
        import cv2

        small = cv2.resize(frame_bgr, (size, size), interpolation=cv2.INTER_AREA)
    return small[..., ::-1].astype(np.float32) / 255.0


async def _analyze_frame_once(conn: ConnectionState, frame, frame_id: int) -> None:
    """One frame through analysis + CNN scoring concurrently (mutually
    independent: serializing them would add one device round trip to every
    frame), with the JPEG encode detached entirely (see inline note). Results land on the connection for the wire tick to
    stream."""

    async def _analyze():
        with conn.timer.stage("analysis") if conn.timer else contextlib.nullcontext():
            use_service = conn.analysis is not None and frame.shape[:2] == (
                conn.analysis.height, conn.analysis.width
            )
            if use_service and conn.analysis_slot is None:
                # claim a device-resident carry slot; at capacity the
                # stream falls back to its per-connection analyzer below
                conn.analysis_slot = conn.analysis.acquire_slot()
            if use_service and conn.analysis_slot is not None:
                # micro-batched across connections: one K7 launch serves
                # every live stream's frame. While the service warms up
                # (the first launch builds K7) keep the heartbeat: stream
                # engine state + the raw frame, analysis attaches once
                # warm (returns None meanwhile).
                return await conn.analysis.maybe_analyze(frame, conn.analysis_slot)
            return await asyncio.to_thread(conn.analyzer.analyze_frame, frame)

    async def _infer():
        if conn.inference is None:
            return None
        with conn.timer.stage("inference") if conn.timer else contextlib.nullcontext():
            # the 32x32 INTER_AREA resize is a little C work: cheaper inline
            # than a thread-pool round trip, which queues under load
            small = _frame_for_model(frame, conn.config.model.image_size)
            # non-blocking while the model warms up: the 30 Hz heartbeat
            # must not stall behind the model's set-up
            return await conn.inference.maybe_score_frame(small)

    async def _encode():
        with conn.timer.stage("encode") if conn.timer else contextlib.nullcontext():
            encoded = await asyncio.to_thread(
                frame_to_base64_jpeg, frame, conn.config.video.jpeg_quality
            )
        conn.pending_encoded = encoded or conn.pending_encoded

    # JPEG encode is fire-and-forget, at most one in flight: under multi-
    # client load the host thread pool queues, and awaiting it in the
    # gather made the wire's *video* path gate the fresh-analysis rate. Now a lagging encode just drops that frame from
    # the wire video (the tick re-sends nothing; staleness stays visible)
    # while analysis/inference proceed at device rate.
    # FAV_SERVER_ENCODE_SYNC=1 restores the awaited arm for same-session A/Bs.
    if conn.config.server.encode_sync:
        result, scored, _ = await asyncio.gather(_analyze(), _infer(), _encode())
    else:
        if conn.encode_task is None or conn.encode_task.done():
            conn.encode_task = asyncio.get_running_loop().create_task(_encode())
        result, scored = await asyncio.gather(_analyze(), _infer())
    if scored is not None:
        conn.last_inference = scored
    conn.last_frame_id = frame_id
    if result is None:  # analyzer still warming
        conn.analysis_warming = True
        return
    conn.analysis_warming = False
    conn.last_analysis = result
    conn.analysis_frame_id = frame_id
    conn.analysis_done_t = time.monotonic()


async def _pipeline_live(conn: ConnectionState) -> None:
    """Per-connection live pipeline: continuously push the NEWEST frame
    through analysis/inference/encode, independent of the wire tick.

    This is what decouples the 30 Hz wire rate from the device round trip
    (VERDICT r3 #2): the reference streams at the configured tick rate
    unconditionally (reference main.py:122,205) and reuses cached analysis
    for duplicate frames — here the tick likewise streams the latest
    COMPLETED analysis, tagged with its frame_id and staleness, while this
    task keeps at most one frame in flight (per-stream temporal state —
    freeze detection — needs ordered frames)."""
    poll = 1.0 / 240.0  # frame-arrival poll; cheap host check, no device work
    while True:
        frame, frame_id = conn.video.get_frame()
        if frame is None or frame_id == conn.pipe_frame_id:
            await asyncio.sleep(poll)
            continue
        conn.seen_frame = True
        conn.pipe_frame_id = frame_id
        try:
            await _analyze_frame_once(conn, frame, frame_id)
            conn.pipeline_error = None
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # a transient device/analysis hiccup must not kill the pipeline;
            # the tick surfaces it and the next frame retries
            conn.pipeline_error = f"{type(e).__name__}: {e}"
            await asyncio.sleep(0.05)


async def _tick_live(conn: ConnectionState, dt: float) -> dict:
    """Live-mode tick: stream the latest completed analysis through the
    trust engine (reference main.py:151-188; the CNN path is the port's
    real-ML upgrade over the reference's absent autoencoder).

    Never blocks on the device: analysis/inference run in the connection's
    pipeline task (:func:`_pipeline_live`), so the wire holds the configured
    tick rate regardless of device RTT. States carry ``frame_id`` (the
    analyzed frame) and ``staleness_ms`` (age of that analysis) — bounded
    one-tick-ish lag, explicit on the wire."""
    if conn.pipeline_task is None or conn.pipeline_task.done():
        conn.pipeline_task = asyncio.get_running_loop().create_task(
            _pipeline_live(conn)
        )
    if not conn.last_analysis:
        state = conn.engine.get_state()
        if conn.seen_frame:
            state["analysis_warming"] = True  # frames flow, analyzer compiling
        else:
            state["waiting_for_frame"] = True
        state["dt"] = round(dt, 4)
        if conn.pipeline_error:
            state["tick_error"] = conn.pipeline_error
        if conn.pending_encoded:
            state["video_frame"] = conn.pending_encoded
            conn.pending_encoded = None
        return state
    analysis = conn.last_analysis
    anomaly = analysis["anomaly_score"]
    degraded = conn.inference is not None and conn.inference.degraded
    if conn.config.server.use_model_anomaly and conn.last_inference and not degraded:
        # a degraded predictor's anomaly is noise from random weights — the
        # trust engine runs analyzer-only until a real checkpoint serves
        # (VERDICT r3 missing #3; the monitor's loud-failure rule applied
        # symmetrically to the predictor)
        anomaly = max(anomaly, conn.last_inference.get("model_anomaly", 0.0))
    state = conn.engine.update(analysis["vision_status"], anomaly, dt)
    state["anomaly_score"] = round(anomaly, 6)
    state["signal_metrics"] = analysis["metrics"]
    if conn.last_inference:
        state["ml_inference"] = conn.last_inference
    if degraded:
        state["model_degraded"] = True  # dashboard badges this on every tick
    state["dt"] = round(dt, 4)
    state["frame_id"] = conn.analysis_frame_id
    # staleness contract: how old the analysis feeding this tick is. Under a
    # healthy pipeline this is ~1 frame period; it grows when the device path
    # falls behind the wire rate — explicitly, instead of slowing the wire.
    state["staleness_ms"] = round((time.monotonic() - conn.analysis_done_t) * 1e3, 1)
    if conn.pipeline_error:
        state["tick_error"] = conn.pipeline_error
    if conn.pending_encoded:
        state["video_frame"] = conn.pending_encoded
        conn.pending_encoded = None
    return state


async def _stream_loop(ws: WebSocket, conn: ConnectionState) -> None:
    """The 30 Hz state pump (reference main.py:128-205).

    Pacing is deadline-based: the reference sleeps 1/tick_rate AFTER the tick
    work, so its real rate is tick_rate minus the work share (~28.5 Hz
    measured here for a nominal 30). Scheduling against absolute deadlines
    delivers the configured rate exactly; a loop that falls behind re-anchors
    instead of bursting."""
    conn.last_time = time.monotonic()
    next_t = conn.last_time
    while not ws.closed:
        now = time.monotonic()
        dt = now - conn.last_time  # wall-clock dt (main.py:130-132)
        conn.last_time = now
        try:
            with conn.timer.stage("tick") if conn.timer else contextlib.nullcontext():
                if conn.source_mode == "simulation":
                    state = await _tick_sim(conn, dt)
                else:
                    state = await _tick_live(conn, dt)
                state["source_mode"] = conn.source_mode
                conn.attributor.update(state, state["timestamp"])
                state["failure_events"] = conn.attributor.get_summary()
                conn.logger.log(state, state.get("anomaly_score", 0.0))
        except (WebSocketClosed, asyncio.CancelledError):
            raise
        except Exception as e:
            # a transient tick failure (analysis/inference hiccup) must not
            # silently kill this connection's heartbeat
            state = conn.engine.get_state()
            state["source_mode"] = conn.source_mode
            state["tick_error"] = f"{type(e).__name__}: {e}"
        await ws.send_json(state)
        next_t += 1.0 / conn.tick_rate
        delay = next_t - time.monotonic()
        if delay <= 0:  # fell behind (host stall / rate change): re-anchor
            next_t = time.monotonic()
            delay = 0.0
        await asyncio.sleep(delay)


async def _handle_control(ws: WebSocket, conn: ConnectionState, msg: dict) -> None:
    """Control-message dispatch (reference main.py:210-304)."""
    action = msg.get("action")

    if action == "set_source_mode":
        mode = msg.get("mode", "simulation")
        conn.stop_pipeline()  # no stale in-flight analysis across sources
        conn.video.stop()
        if mode == "webcam":
            ok = False
            try:
                ok = await asyncio.to_thread(conn.video.start, int(msg.get("device", 0)))
            except Exception:
                ok = False
            if not ok:
                conn.source_mode = "simulation"  # fallback (main.py:230-236)
                await ws.send_json(
                    {"type": "error", "message": "Could not open webcam; falling back to simulation"}
                )
                return
        elif mode == "video":
            filepath = msg.get("filepath", "")
            ok = False
            if filepath and os.path.isfile(filepath):
                ok = await asyncio.to_thread(conn.video.start, filepath)
            if not ok:
                conn.source_mode = "simulation"
                await ws.send_json({"type": "error", "message": f"Could not open video: {filepath}"})
                return
        elif mode != "simulation":
            await ws.send_json({"type": "error", "message": f"Unknown source mode: {mode}"})
            return
        conn.source_mode = mode
        # mode switch resets analyzer + engine + attributor (main.py:258-261)
        conn.analyzer.reset()
        if conn.analysis is not None and conn.analysis_slot is not None:
            conn.analysis.reset_slot(conn.analysis_slot)  # fresh temporal state
        conn.engine.reset()
        conn.attributor.reset()
        conn.last_analysis = {}
        conn.last_inference = {}  # don't carry ML scores across sources
        await ws.send_json({"type": "mode_changed", "mode": mode})

    elif action == "set_vision" and conn.source_mode == "simulation":
        conn.vision.set_mode(msg.get("mode", "normal"))
    elif action == "set_noise" and conn.source_mode == "simulation":
        conn.vision.set_noise(float(msg.get("level", 0.0)))
    elif action == "set_brightness" and conn.source_mode == "simulation":
        conn.vision.set_brightness(float(msg.get("level", 0.5)))
    elif action == "reset":
        conn.reset()
    elif action == "set_tick_rate":
        rate = float(msg.get("rate", conn.config.video.default_tick_rate))
        lo, hi = conn.config.video.min_tick_rate, conn.config.video.max_tick_rate
        conn.tick_rate = min(float(hi), max(float(lo), rate))  # clamp (main.py:293-294)
    elif action == "get_log":
        await ws.send_json(
            {
                "type": "log_data",
                "csv": conn.logger.get_csv(),
                "entry_count": conn.logger.entry_count,
                "events_csv": conn.attributor.get_events_csv(),
                "event_count": len(conn.attributor.get_events()),
            }
        )


def run_playground_sequence(events: list[dict], config: FrameworkConfig | None = None) -> list[dict]:
    """Batch event replay — reference semantics (main.py:322-366).

    Each event is {status, noise, brightness, frames}; anomaly scores come
    from a fresh seed-99 simulator; dt is fixed at 1/30. Returns the full
    per-tick state list with ``sim_time``.

    The replay runs the port's trust scan on the host CPU in float64, on
    purpose, as ``fav_tpu`` pins its ``lax.scan`` to the CPU in float64
    (``fav_tpu/serving/app.py:462-467``): the trust recurrence is a few
    scalar operations a tick, which a card would spend on launches, and
    float64 keeps the replay equal to the host ``TrustEngine``.
    """
    from fav_tpu_torch.core.trust_scan import simulate_sequence

    cfg = config or DEFAULT_CONFIG
    dt = cfg.video.playground_dt
    anomaly_sim = AnomalySimulator(seed=PLAYGROUND_SEED, params=cfg.anomaly_sim)

    statuses, scores = [], []
    for event in events:
        status = event.get("status", "VISION_OK")
        noise = float(event.get("noise", 0.0))
        brightness = float(event.get("brightness", 0.5))
        frames = max(0, int(event.get("frames", 0)))
        for _ in range(frames):
            statuses.append(STATUS_CODES.get(status, 0))
            scores.append(anomaly_sim.compute_anomaly(noise, brightness, status))
    if not statuses:
        return []

    n = len(statuses)
    cpu, f64 = torch.device("cpu"), torch.float64
    _, outs = simulate_sequence(
        cfg.trust,
        torch.tensor(statuses, dtype=torch.int32, device=cpu),
        torch.tensor(scores, dtype=f64, device=cpu),
        torch.ones(n, dtype=torch.bool, device=cpu),
        torch.full((n,), dt, dtype=f64, device=cpu),
    )

    rel = outs.reliability.numpy()
    pol = outs.policy.numpy()
    integ = outs.anomaly_integral.numpy()
    vel = outs.trust_velocity.numpy()
    debt = outs.recovery_debt.numpy()
    coeff = outs.recovery_coeff.numpy()
    contra = outs.contradiction.numpy()
    ccount = outs.contradiction_count.numpy()
    stat = outs.status.numpy()

    results = []
    for i in range(n):
        results.append(
            {
                "sim_time": round((i + 1) * dt, 4),
                "reliability": round(float(rel[i]), 6),
                "policy_state": policy_name(int(pol[i])),
                "vision_status": status_name(int(stat[i])),
                "anomaly_score": round(scores[i], 6),
                "anomaly_integral": round(float(integ[i]), 6),
                "trust_velocity": round(float(vel[i]), 6),
                "recovery_debt": round(float(debt[i]), 4),
                "recovery_coeff": round(float(coeff[i]), 4),
                "contradiction_detected": bool(contra[i]),
                "contradiction_count": int(ccount[i]),
            }
        )
    return results


def create_app(config: FrameworkConfig | None = None, frontend_dir: str | None = None,
               device: str | torch.device | None = None) -> HttpServer:
    """The app on ``device`` (the card unless ``"cpu"`` is asked for; with
    no card this raises)."""
    cfg = config or DEFAULT_CONFIG
    dev = resolve_device(device)
    fdir = frontend_dir or _FRONTEND_DIR
    # the resize and JPEG libraries build now, not under the first live frames
    native.prebuild()
    upload_dir = os.path.abspath(cfg.server.upload_dir)
    server = HttpServer()
    timer = StageTimer()
    inference = (
        InferenceService(
            cfg.model,
            checkpoint_dir=cfg.server.checkpoint or None,
            max_wait_ms=cfg.server.inference_max_wait_ms,
            uncertainty=cfg.server.uncertainty,
            timer=timer,  # device-call latency shows up in /api/metrics
            monitor_dir=cfg.server.monitor or None,
            device=dev,
        )
        if cfg.server.model_scoring
        else None
    )
    analysis = (
        AnalysisService(
            cfg.analyzer,
            height=cfg.video.process_height,
            width=cfg.video.process_width,
            max_wait_ms=cfg.server.inference_max_wait_ms,
            timer=timer,  # device-call latency shows up in /api/metrics
            device=dev,
        )
        if cfg.server.batched_analysis
        else None
    )

    # ── pages + static (reference main.py:34-65) ──
    def page(name: str):
        async def handler(request: Request) -> Response:
            path = os.path.join(fdir, name)
            if os.path.isfile(path):
                with open(path, encoding="utf-8") as f:
                    return Response.html(f.read())
            return Response.json({"error": f"{name} not found"}, 404)

        return handler

    server.route("GET", "/", page("index.html"))
    server.route("GET", "/architecture", page("architecture.html"))
    server.route("GET", "/playground", page("playground.html"))
    for sub in ("css", "js", "assets"):
        server.mount_static(f"/{sub}", os.path.join(fdir, sub))

    async def health(request: Request) -> Response:
        return Response.json({"status": "ok"})  # liveness (main.py:70-72)

    server.route("GET", "/health", health)

    async def metrics(request: Request) -> Response:
        """Per-stage latency histograms + inference-service info
        (tracing/profiling subsystem, SURVEY.md §5.1)."""
        return Response.json(
            {
                "stages": timer.summary(),
                "inference": inference.info() if inference else None,
            }
        )

    server.route("GET", "/api/metrics", metrics)

    async def upload_video(request: Request) -> Response:
        """Multipart upload with extension whitelist (main.py:77-94)."""
        for part in request.multipart():
            if part["filename"]:
                ext = os.path.splitext(part["filename"])[1].lower()
                if ext not in cfg.video.upload_extensions:
                    return Response.json({"error": f"Unsupported file type: {ext}"}, 400)
                os.makedirs(upload_dir, exist_ok=True)
                filename = f"upload_{int(time.time() * 1000)}{ext}"
                filepath = os.path.join(upload_dir, filename)
                with open(filepath, "wb") as f:
                    f.write(part["data"])
                return Response.json({"filepath": filepath, "filename": filename})
        return Response.json({"error": "no file in request"}, 400)

    server.route("POST", "/api/upload-video", upload_video)

    # ── streaming WS (main.py:105-317) ──
    async def ws_stream(request: Request, ws: WebSocket) -> None:
        conn = ConnectionState(cfg, device=dev)
        conn.inference = inference
        conn.analysis = analysis
        conn.timer = timer
        loop_task = asyncio.create_task(_stream_loop(ws, conn))
        try:
            while True:
                text = await ws.receive_text()
                try:
                    msg = json.loads(text)
                except ValueError:
                    continue  # a garbage control frame must not kill the stream
                try:
                    await _handle_control(ws, conn, msg)
                except (WebSocketClosed, asyncio.CancelledError):
                    raise
                except Exception as e:
                    # malformed control values (e.g. {"action":"set_tick_rate",
                    # "rate":"fast"}) must not tear down the stream — the
                    # reference blankets its control loop (main.py:210-304)
                    await ws.send_json(
                        {"type": "error", "message": f"bad control message: {e}"}
                    )
        except WebSocketClosed:
            pass
        finally:  # cleanup (main.py:306-317)
            loop_task.cancel()
            try:
                await loop_task
            except (asyncio.CancelledError, WebSocketClosed):
                pass
            conn.stop_pipeline()
            conn.video.stop()
            if conn.analysis is not None and conn.analysis_slot is not None:
                conn.analysis.release_slot(conn.analysis_slot)
                conn.analysis_slot = None

    server.ws("/ws", ws_stream)

    # ── playground WS (main.py:322-366) ──
    async def ws_playground(request: Request, ws: WebSocket) -> None:
        while True:
            try:
                msg = json.loads(await ws.receive_text())
            except ValueError:
                continue
            if msg.get("action") == "simulate_sequence":
                events = msg.get("events", [])
                results = await asyncio.to_thread(run_playground_sequence, events, cfg)
                await ws.send_json({"type": "simulation_result", "results": results})
            else:
                await ws.send_json({"type": "error", "message": "unknown action"})

    server.ws("/ws/playground", ws_playground)
    return server


def serve_forever(reuse_port: bool = False) -> None:
    """One serving process: build the app from env config on the device
    ``FAV_TORCH_DEVICE`` names (default ``cuda``) and run until
    SIGINT/SIGTERM. ``reuse_port=True`` is the worker mode — N processes
    bind the same port with SO_REUSEPORT (spawned by :func:`main`)."""
    from fav_tpu_torch.config import config_from_env

    cfg = config_from_env()
    device = os.environ.get(DEVICE_ENV) or "cuda"

    async def _run():
        import signal

        app = create_app(cfg, device=device)
        srv = await app.serve(cfg.server.host, cfg.server.port, reuse_port=reuse_port)
        print(
            f"fav_tpu_torch serving on http://{cfg.server.host}:{cfg.server.port}"
            f" (pid {os.getpid()}, device {device})",
            flush=True,
        )
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except NotImplementedError:  # non-unix
                pass
        async with srv:
            await stop.wait()  # graceful: finish in-flight writes, then close
        print("fav_tpu_torch server stopped")

    asyncio.run(_run())


def _worker_entry() -> None:
    """Spawn target for one SO_REUSEPORT worker (must be module-level for
    the 'spawn' start method; env config is inherited by the child)."""
    serve_forever(reuse_port=True)


def main() -> None:  # pragma: no cover
    """Entry point: ``python -m fav_tpu_torch.serving.app`` (reference
    main.py:369-371).

    ``FAV_SERVER_WORKERS=N`` (N > 1) runs N serving processes sharing the
    port via SO_REUSEPORT: each worker owns its own asyncio loop, JPEG/JSON
    encoding and CUDA context while the card is shared. 'spawn' (not fork)
    so no worker inherits an initialized CUDA context, which a forked child
    cannot use."""
    from fav_tpu_torch.config import config_from_env

    workers = config_from_env().server.workers
    if workers <= 1:
        return serve_forever()

    import multiprocessing as mp
    import signal

    ctx = mp.get_context("spawn")

    def spawn(i: int):
        p = ctx.Process(target=_worker_entry, name=f"fav-worker-{i}")
        p.start()
        return p

    procs = [spawn(i) for i in range(workers)]
    print(f"fav_tpu_torch supervisor: {workers} workers on shared port", flush=True)

    stopping = False

    def _forward(signum, _frame):
        nonlocal stopping
        stopping = True
        for p in procs:
            if p.pid and p.is_alive():
                try:
                    os.kill(p.pid, signum)
                except ProcessLookupError:
                    pass

    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, _forward)
        except (ValueError, OSError):  # non-main thread / non-unix
            pass

    # supervise: a crashed worker (OOM, device client lost) must not
    # permanently shrink capacity — respawn it; a graceful stop must not
    # fight the respawner. SIGCHLD-free polling keeps this portable.
    import time as _time

    while not stopping and any(p.is_alive() for p in procs):
        for i, p in enumerate(procs):
            p.join(timeout=0.2)
            if stopping:
                break
            if p.exitcode is not None:
                print(
                    f"fav_tpu_torch supervisor: worker {i} exited "
                    f"(code {p.exitcode}), respawning", flush=True,
                )
                _time.sleep(0.5)  # crash-loop damper
                procs[i] = spawn(i)
    # a worker respawned in the stop-signal window never saw the forwarded
    # signal — sweep once more so the final join cannot hang
    for p in procs:
        if p.is_alive() and p.pid:
            try:
                os.kill(p.pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
    for p in procs:
        p.join()
    print("fav_tpu_torch supervisor stopped")


if __name__ == "__main__":  # pragma: no cover
    main()
