"""Drive the server's live path on the scripted camera streams.

The server's live path (``serving/app.py``: ``ConnectionState``,
``_analyze_frame_once``, ``_tick_live``) takes frames from a video source.
A machine with a card may have no camera and no cv2, so these functions
feed it the scripted streams of ``sim/frames.py`` instead, through a stand-in
source like the stub of ``tests/test_serving.py:577-588``. They take
the app module as an argument: ``chip_smoke.py`` runs the port's on the
card, and the CPU tests run the port's and ``fav_tpu``'s on the same
frames, which is how ``weights/serve.golden.json`` was written.

* :func:`drive_lockstep` analyzes and scores frame t of every stream, then
  ticks every stream once: the same ticks see the same analyses on any
  machine, so final states are reproducible to the bit.
* :func:`drive_paced` runs the server as it runs live: each stream's
  pipeline task takes the newest frame while the ticks stream at a fixed
  rate and never wait for the device.

:func:`serve_golden_inputs` gives the fixed frames whose inference rows the
golden holds, and :data:`PLAYGROUND_EVENTS` the playground sequence whose
replay it holds.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np

__all__ = ["SERVE_TICKS", "SERVE_RATE", "SERVE_SEED", "PLAYGROUND_EVENTS", "CONF_ATOL", "ANOMALY_ATOL", "ENTROPY_ATOL",
           "MI_ATOL", "ScriptedVideo", "serve_golden_inputs", "compare_rows", "warm_services", "settle", "drive_lockstep",
           "drive_paced", "final_states"]

SERVE_TICKS = 60
SERVE_RATE = 30.0  # ticks a second
SERVE_SEED = 20240623  # the golden's random images
PLAYGROUND_EVENTS = (
    {"status": "VISION_OK", "noise": 0.1, "brightness": 0.5, "frames": 40},
    {"status": "VISION_CORRUPTED", "noise": 0.6, "brightness": 0.3, "frames": 25},
    {"status": "VISION_FROZEN", "noise": 0.0, "brightness": 0.5, "frames": 30},
    {"status": "VISION_OK", "noise": 0.0, "brightness": 0.8, "frames": 60},
)

# The served rows against fav_tpu's (the bf16 forward class). fav_tpu's rows
# come from its jitted forward, where XLA fuses each conv with its bias and
# skips a bf16 rounding that the port keeps (as flax's eager forward does):
# on the CPU the two part by up to 0.0154 in a confidence and 0.027 in an
# entropy on the golden's frames (tests/test_torch_inference.py). The
# bounds leave about three times that for cuDNN's bf16 on the card. The
# anomaly is 2.5 / 0.6 times a confidence's change (anomaly_from_confidence);
# the mutual information of one member is 0 in exact arithmetic.
CONF_ATOL = 0.05
ANOMALY_ATOL = CONF_ATOL * 2.5 / 0.6
ENTROPY_ATOL = 0.1
MI_ATOL = 1e-6


class ScriptedVideo:
    """A live source over one scripted clip uint8 [T, H, W, 3]: ``get_frame``
    returns frame ``tick`` with id ``tick + 1``; the caller sets ``tick``."""

    def __init__(self, clip: np.ndarray):
        self.clip = clip
        self.tick = 0

    def get_frame(self):
        return self.clip[self.tick], self.tick + 1

    def stop(self) -> None:
        pass


def serve_golden_inputs(frame_for_model) -> np.ndarray:
    """The golden's CNN inputs, float32 RGB [16, 32, 32, 3] in [0, 1]: the
    last frame of each of the eight golden scripted streams (two of each
    kind, 240x320) through the live path's ``frame_for_model`` (the app's
    ``_frame_for_model``: INTER_AREA to 32x32, BGR to RGB), then eight
    uniform images from :data:`SERVE_SEED`."""
    from fav_tpu_torch.sim.frames import GOLDEN_STREAMS, MONITOR_STREAMS, MONITOR_TICKS, scripted_stream

    scripted = [frame_for_model(scripted_stream(*MONITOR_STREAMS[j], MONITOR_TICKS)[-1], 32) for j in GOLDEN_STREAMS]
    rand = np.random.default_rng(SERVE_SEED).random((8, 32, 32, 3), dtype=np.float32)
    return np.concatenate([np.stack(scripted).astype(np.float32), rand])


def compare_rows(got: np.ndarray, want: np.ndarray, aps_scores: np.ndarray, qhat: float | None) -> dict:
    """Hold served packed rows ``got`` [n, 6 or 7] to ``fav_tpu``'s ``want``:
    predictions equal; confidence (and the predictor's own, column 6),
    anomaly, entropy and mutual information within their bounds; set sizes
    equal, except that a row's size may differ by as many classes as have
    one of the port's APS scores ``aps_scores`` [n, C] within ``CONF_ATOL``
    of ``qhat``. Raises ``AssertionError`` on a miss; returns the largest
    differences and the number of rows held to equal sizes."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"rows of shape {got.shape}, expected {want.shape}")
    if not np.array_equal(got[:, 0], want[:, 0]):
        raise AssertionError(f"predictions {got[:, 0].tolist()} differ from {want[:, 0].tolist()}")
    diff = np.abs(got - want)
    bounds = {1: ("confidence", CONF_ATOL), 2: ("anomaly", ANOMALY_ATOL), 3: ("entropy", ENTROPY_ATOL),
              4: ("mutual_information", MI_ATOL)}
    if got.shape[1] > 6:
        bounds[6] = ("confidence_self", CONF_ATOL)
    out = {}
    for col, (name, tol) in bounds.items():
        out[name] = float(diff[:, col].max())
        if out[name] > tol:
            raise AssertionError(f"{name}: max difference {out[name]} > {tol}")
    # a class's membership can flip only where its APS score lies within
    # the bound of qhat: the sizes may differ by at most that many classes
    if qhat is None:
        band = np.zeros(len(got), int)
    else:
        band = (np.abs(np.asarray(aps_scores) - qhat) <= CONF_ATOL).sum(axis=1)
    bad = np.abs(got[:, 5] - want[:, 5]) > band
    if bad.any():
        raise AssertionError(f"set sizes differ in rows {np.where(bad)[0].tolist()}: {got[bad, 5]} vs "
                             f"{want[bad, 5]}, beyond the {band[bad]} classes near qhat")
    out["set_size_rows_exact"] = int((band == 0).sum())
    out["set_size_max_diff"] = float(np.abs(got[:, 5] - want[:, 5]).max())
    return out


async def warm_services(*services, timeout_s: float = 300.0) -> float:
    """Start each service's worker and wait until every one is ready (its
    model built, its buckets run once); returns the seconds it took."""
    t0 = time.perf_counter()
    for s in services:
        if s is None:
            continue
        if hasattr(s, "start"):
            s.start()
        else:  # fav_tpu's services, which the CPU tests drive, have no public start
            s._ensure_worker()
    while not all(s is None or s.ready for s in services):
        if time.perf_counter() - t0 > timeout_s:
            raise TimeoutError(f"services not ready after {timeout_s} s")
        await asyncio.sleep(0.01)
    return time.perf_counter() - t0


async def settle(*services, timeout_s: float = 60.0) -> None:
    """Wait until no frame submitted to the services awaits its batch (a
    stream's pipeline that was stopped leaves its last frames in flight),
    so that counts reset next see only the next run's batches."""
    t0 = time.perf_counter()
    while any(s is not None and s.outstanding for s in services):
        if time.perf_counter() - t0 > timeout_s:
            raise TimeoutError(f"frames still in flight after {timeout_s} s")
        await asyncio.sleep(0.001)


async def drive_lockstep(app, conns: list, clips: list, ticks: int = SERVE_TICKS) -> list[list[dict]]:
    """Per tick t: frame t of every stream through ``app._analyze_frame_once``
    (together, so the services batch them), then one ``app._tick_live`` of
    every stream at dt = 1 / SERVE_RATE. Returns the states [ticks][streams].
    A pending future stands in for each stream's pipeline task, so no
    pipeline races this loop."""
    parked = asyncio.get_running_loop().create_future()
    for c in conns:
        c.source_mode = "video"
        c.pipeline_task = parked
    states = []
    try:
        for t in range(ticks):
            await asyncio.gather(*[app._analyze_frame_once(c, clip[t], t + 1) for c, clip in zip(conns, clips)])
            states.append([await app._tick_live(c, 1.0 / SERVE_RATE) for c in conns])
    finally:
        for c in conns:
            c.stop_pipeline()
    return states


async def drive_paced(app, conns: list, clips: list, ticks: int = SERVE_TICKS,
                      rate: float = SERVE_RATE) -> tuple[list[list[dict]], list[float]]:
    """The live server's own schedule: every stream's ``video`` is a
    :class:`ScriptedVideo` showing frame t at tick t, its pipeline task
    analyzes and scores the newest frame, and the ticks run at ``rate``
    against absolute deadlines. Returns the states [ticks][streams] and
    each tick's wall seconds (all streams' ``_tick_live``)."""
    for c, clip in zip(conns, clips):
        c.source_mode = "video"
        c.video = ScriptedVideo(clip)
    loop = asyncio.get_running_loop()
    start = loop.time()
    states, tick_s = [], []
    try:
        for t in range(ticks):
            await asyncio.sleep(max(0.0, start + t / rate - loop.time()))
            for c in conns:
                c.video.tick = t
            t0 = time.perf_counter()
            states.append([await app._tick_live(c, 1.0 / rate) for c in conns])
            tick_s.append(time.perf_counter() - t0)
    finally:
        for c in conns:
            c.stop_pipeline()
    return states, tick_s


def final_states(states: list[list[dict]]) -> list[dict]:
    """Each stream's last state, cut to what the golden holds."""
    return [{"vision_status": s.get("vision_status"), "policy_state": s.get("policy_state"),
             "reliability": s.get("reliability")} for s in states[-1]]
