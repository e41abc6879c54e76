"""Micro-batched inference service for the streaming server.

Counterpart of ``fav_tpu/serving/inference.py``:

* every live connection submits its frame to one shared asyncio queue,
* a single worker task drains the queue, pads the pending frames to a batch
  bucket (1/8/32) and runs ONE forward for all concurrent connections,
* each batch's scores are packed on the device into one float32 row per
  frame and copied to the host once; results fan back out through futures,
* weights come from the port's copy of a checkpoint (``<stem>.npz`` and
  ``<stem>.metadata.json`` under ``fav_tpu_torch/weights/``) and fall back
  to random weights when none is there; the service says which through
  ``info()`` and ``degraded``, and the server keeps a degraded model's
  anomaly out of the trust engine.

The packed row's columns are prediction, operative confidence, anomaly,
entropy, mutual information and conformal set size (-1 without a
calibrated ``conformal_qhat``); with a monitor, a seventh holds the
predictor's own confidence. The monitor's confidence min-gates the
predictor's, and the monitor must restore: a bad ``monitor_dir`` fails the
service instead of gating with noise.

What is served: ``uncertainty="msp"``, with or without a monitor. The modes
``mc_dropout``, ``ensemble`` and ``autoencoder`` raise
``NotImplementedError`` (ROADMAP.md Queue 1 items 3-5: their checkpoints,
the autoencoder model and the MC-dropout and ensemble predictors are not
ported), and so does a checkpoint that ships a Mahalanobis fit
(``<stem>.maha_fit.npz``), whose feature-distance column needs the
Mahalanobis scores of item 5. None of them quietly serves something else.

The forward is the bf16 student on ``device`` through cuDNN and cuBLAS;
``fav_tpu`` computes it outside any Pallas kernel, so no hand-written
kernel stands behind it. Softmax, set sizes and the packed row are torch
ops on the same device. ``inference_device`` is recorded after the copy of
a batch's row to the host, which waits for the batch on the card.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from fav_tpu_torch.config import ModelParams, model_params_from_metadata
from fav_tpu_torch.device import resolve_device
from fav_tpu_torch.models.cnn import create_model, init_params
from fav_tpu_torch.models.conformal import prediction_sets, set_sizes
from fav_tpu_torch.models.uncertainty import anomaly_from_confidence, mutual_information, predictive_entropy
from fav_tpu_torch.utils.checkpoint import WEIGHTS_DIR, flax_to_torch, load_flax_npz

__all__ = ["InferenceService", "BUCKETS", "MAHA_FIT_SUFFIX"]

BUCKETS = (1, 8, 32)
MAHA_FIT_SUFFIX = ".maha_fit.npz"  # fav_tpu/models/mahalanobis.py:52 keeps it beside a checkpoint
_UNPORTED = {
    "mc_dropout": "ROADMAP.md Queue 1 items 3 and 5 (the dropout-trained classifier, mc_dropout_predict)",
    "ensemble": "ROADMAP.md Queue 1 items 3 and 5 (the ensemble checkpoints, ensemble_predict)",
    "autoencoder": "ROADMAP.md Queue 1 items 3 and 4 (the autoencoder checkpoint, ConvAutoencoder)",
}


class InferenceService:
    """Shared micro-batched classifier scoring for live frames.

    ``checkpoint_dir`` and ``monitor_dir`` are weight stems (``<stem>.npz``
    beside ``<stem>.metadata.json``); ``device`` is the card unless
    ``"cpu"`` is asked for. ``timer``, if given, is any object with
    ``record(name, seconds)``."""

    _MAX_INFLIGHT = 4  # batches whose scores are being copied at once

    def __init__(
        self,
        model_params: ModelParams | None = None,
        checkpoint_dir: str | None = None,
        max_wait_ms: float = 4.0,
        uncertainty: str = "msp",
        timer=None,
        monitor_dir: str | None = None,
        device: str | torch.device | None = None,
    ):
        if uncertainty not in ("msp", "mc_dropout", "ensemble", "autoencoder"):
            raise ValueError(f"unknown uncertainty mode: {uncertainty}")
        if monitor_dir and uncertainty == "autoencoder":
            raise ValueError("monitor_dir gates class confidence; the autoencoder mode has none")
        if uncertainty in _UNPORTED:
            raise NotImplementedError(f"uncertainty={uncertainty!r} is not ported yet: {_UNPORTED[uncertainty]}")
        self.cfg = model_params or ModelParams()
        self.max_wait = max_wait_ms / 1e3
        self.uncertainty = uncertainty
        self.timer = timer  # optional StageTimer: records inference_device
        self.device = resolve_device(device)
        self._queue: asyncio.Queue = asyncio.Queue()
        self._worker: asyncio.Task | None = None
        self._started = False
        self.ready = False  # True once the model is built and every bucket has run
        self.source = "uninitialized"
        self._checkpoint_dir = checkpoint_dir
        self._monitor_dir = monitor_dir
        self.monitor_source: str | None = None
        self._forward = None
        self._temperature = 1.0
        self._meta: dict = {}
        self.restore_error: str | None = None
        self._col_self_conf: int | None = None
        self.dispatches = 0  # batches dispatched, warm-up included
        self.frames_scored = 0  # frames whose scores reached their caller
        self.outstanding = 0  # frames submitted whose batch has not come back
        fit = self._resolve_ckpt_dir() + MAHA_FIT_SUFFIX
        if os.path.isfile(fit):
            raise NotImplementedError(
                f"{fit}: serving a Mahalanobis feature distance is not ported yet: ROADMAP.md Queue 1 item 5")

    # ── model set-up (first use, in the worker's thread) ──
    def _ensure_model(self) -> None:
        if self._forward is not None:
            return
        dev = self.device
        pre_meta = self._peek_metadata()
        cfg = model_params_from_metadata(self.cfg, pre_meta)
        model = init_params(create_model(cfg), torch.Generator().manual_seed(0))
        self.source = "random_init"
        ckpt = self._resolve_ckpt_dir()
        if os.path.isfile(ckpt + ".npz"):
            try:
                model.load_state_dict(flax_to_torch(load_flax_npz(ckpt + ".npz")), strict=True)
                self._meta = pre_meta
                self._temperature = float(pre_meta.get("temperature", 1.0))
                self.source = f"checkpoint:{ckpt}"
            except Exception as e:
                # weights exist but do not load: serving random weights is
                # then said out loud, never silent
                self.restore_error = f"{type(e).__name__}: {e}"
                print(f"[fav_tpu_torch] WARNING: weights at {ckpt} failed to load ({self.restore_error}); "
                      f"serving RANDOM weights", file=sys.stderr)
                traceback.print_exc()
                model = init_params(create_model(cfg), torch.Generator().manual_seed(0))
        model = model.to(dev).eval()
        temperature = self._temperature
        qhat = self._meta.get("conformal_qhat")
        self._col_self_conf = 6 if self._monitor_dir else None

        monitor = None
        mon_t = 1.0
        if self._monitor_dir:
            # the monitor must restore or the service fails loudly
            mon_meta_path = self._monitor_dir + ".metadata.json"
            if not os.path.isfile(mon_meta_path) or not os.path.isfile(self._monitor_dir + ".npz"):
                raise ValueError(f"monitor checkpoint missing: {self._monitor_dir}")
            with open(mon_meta_path) as f:
                mon_meta = json.load(f)
            monitor = create_model(model_params_from_metadata(ModelParams(), mon_meta))
            monitor.load_state_dict(flax_to_torch(load_flax_npz(self._monitor_dir + ".npz")), strict=True)
            monitor = monitor.to(dev).eval()
            mon_t = float(mon_meta.get("temperature", 1.0))
            self.monitor_source = f"checkpoint:{self._monitor_dir}"

        def summarize(member_probs: torch.Tensor, mon_conf: torch.Tensor | None) -> torch.Tensor:
            """Every score of a batch in ONE float32 [B, 6] tensor (+1 column
            with a monitor): one device-to-host copy per batch. With a
            monitor, column 1 is the min-gated confidence and drives the
            anomaly; column 6 keeps the predictor's own."""
            mean_probs = member_probs.mean(dim=0)
            self_conf = mean_probs.amax(dim=-1)
            conf = self_conf if mon_conf is None else torch.minimum(self_conf, mon_conf)
            if qhat is not None:
                sizes = set_sizes(prediction_sets(mean_probs, float(qhat)))
            else:
                sizes = torch.full(conf.shape, -1, dtype=torch.int32, device=conf.device)  # absent
            f32 = torch.float32
            cols = [
                mean_probs.argmax(dim=-1).to(f32),
                conf.to(f32),
                anomaly_from_confidence(conf).to(f32),
                predictive_entropy(mean_probs).to(f32),
                mutual_information(member_probs).to(f32),
                sizes.to(f32),
            ]
            if mon_conf is not None:
                cols.append(self_conf.to(f32))
            return torch.stack(cols, dim=-1)

        @torch.no_grad()
        def probabilities(images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
            """The predictor's tempered probabilities [1, B, C] (one member)
            and the monitor's confidence [B] (None without a monitor)."""
            mon_conf = None
            if monitor is not None:
                mon_conf = torch.softmax(monitor(images) / mon_t, dim=-1).amax(dim=-1)
            return torch.softmax(model(images) / temperature, dim=-1)[None], mon_conf

        def forward(images: torch.Tensor) -> torch.Tensor:
            return summarize(*probabilities(images))

        self._probabilities, self._summarize = probabilities, summarize
        self._forward = forward

    def _resolve_ckpt_dir(self) -> str:
        """The weight stem to serve: the one given, else ``student_nano`` for
        ``msp`` (falling back to ``student_compact``, then ``classifier``,
        under ``weights/``), as ``fav_tpu``'s choice (:355) maps onto the
        port's copies. Only ``student_nano`` and ``student_std`` are copied
        so far (ROADMAP.md Queue 1 item 3)."""
        if self._checkpoint_dir is not None:
            return str(self._checkpoint_dir)
        for name in ("student_nano", "student_compact", "classifier"):
            stem = os.path.join(str(WEIGHTS_DIR), name)
            if os.path.isfile(stem + ".npz"):
                return stem
        return os.path.join(str(WEIGHTS_DIR), "classifier")

    def _peek_metadata(self) -> dict:
        """The checkpoint's metadata, read before the model is built (the
        architecture comes from it)."""
        meta_path = self._resolve_ckpt_dir() + ".metadata.json"
        if os.path.isfile(meta_path):
            try:
                with open(meta_path) as f:
                    return json.load(f)
            except Exception:
                pass
        return {}

    @property
    def degraded(self) -> bool:
        """True when the built model serves anything other than the weights
        it was meant to: they failed to load, or there were none. False
        while the model is still unbuilt."""
        return self._forward is not None and not self.source.startswith("checkpoint:")

    def info(self) -> dict:
        info = {
            "source": self.source,
            "temperature": self._temperature,
            "uncertainty": self.uncertainty,
            "device": str(self.device),
        }
        if self.degraded:
            info["degraded"] = True
        if self._meta.get("conformal_qhat") is not None:
            info["conformal_alpha"] = self._meta.get("conformal_alpha")
            info["conformal_qhat"] = self._meta.get("conformal_qhat")
        if self._monitor_dir:
            info["monitor"] = self.monitor_source or f"pending:{self._monitor_dir}"
        if self.restore_error:
            info["error"] = f"checkpoint restore failed: {self.restore_error}"
        return info

    # ── public API ──
    def _ensure_worker(self) -> None:
        if not self._started:
            self._started = True
            self._worker = asyncio.get_running_loop().create_task(self._run())

    def start(self) -> None:
        """Start the worker (the model's build and the warm-up of every
        bucket) on the running loop; ``ready`` turns True when it is done."""
        self._ensure_worker()

    def score_batch(self, frames) -> tuple[np.ndarray, np.ndarray]:
        """Score ``frames`` [n, S, S, 3] (float, in [0, 1]) as one batch,
        outside the worker and its counts: returns the packed rows [n, 6 or
        7] that the worker serves for them and the predictor's tempered
        probabilities [n, C] that the rows derive from. Builds the model on
        first use. Blocking: call it off the event loop."""
        self._ensure_model()
        member_probs, mon_conf = self._probabilities(self._stack(frames))
        packed = self._summarize(member_probs, mon_conf)
        n = len(frames)
        return packed[:n].cpu().numpy(), member_probs.mean(dim=0)[:n].cpu().numpy()

    async def score_frame(self, frame_rgb01: np.ndarray) -> dict:
        """Submit one [S, S, 3] float frame in [0, 1]; await its scores."""
        self._ensure_worker()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self.outstanding += 1
        await self._queue.put((frame_rgb01, fut))
        return await fut

    async def maybe_score_frame(self, frame_rgb01: np.ndarray) -> dict | None:
        """The streaming tick's variant: None while the model is still being
        built, so the 30 Hz loop keeps its heartbeat; starts the build on
        its first call."""
        self._ensure_worker()
        if not self.ready:
            return None
        return await self.score_frame(frame_rgb01)

    async def close(self) -> None:
        if self._worker is not None:
            self._worker.cancel()
            try:
                await self._worker
            except asyncio.CancelledError:
                pass
            self._worker = None
            self._started = False

    # ── worker ──
    async def _run(self) -> None:
        try:
            await asyncio.to_thread(self._ensure_model)
            warm = np.zeros((self.cfg.image_size, self.cfg.image_size, self.cfg.channels), np.float32)
            for bucket in BUCKETS:  # every bucket once: the first real batch pays no set-up
                await asyncio.to_thread(self._infer, [warm] * bucket)
        except Exception as e:  # a dead scorer must be visible, not silent
            self.source = f"error:{type(e).__name__}: {e}"
            traceback.print_exc()
            # drain the queue forever, failing any blocking score_frame caller
            while True:
                _, fut = await self._queue.get()
                self.outstanding -= 1
                if not fut.done():
                    fut.set_exception(RuntimeError(self.source))
        self.ready = True
        # the worker dispatches a batch, hands the copy of its scores to a
        # thread and goes on collecting the next batch
        inflight = asyncio.Semaphore(self._MAX_INFLIGHT)
        fetch_tasks: set = set()  # strong references: the loop holds tasks weakly

        async def fetch_and_resolve(packed, batch, t0):
            try:
                host = await asyncio.to_thread(lambda: packed.cpu().numpy())
                if self.timer is not None:
                    self.timer.record("inference_device", time.perf_counter() - t0)
                for i, (_, f) in enumerate(batch):
                    if not f.done():
                        f.set_result(self._row_to_dict(host[i]))
                self.frames_scored += len(batch)
            except Exception as e:
                for _, f in batch:
                    if not f.done():
                        f.set_exception(RuntimeError(f"inference failed: {e}"))
            finally:
                self.outstanding -= len(batch)
                inflight.release()

        while True:
            frame, fut = await self._queue.get()
            batch = [(frame, fut)]
            # micro-batch: wait briefly for concurrent connections' frames
            deadline = asyncio.get_running_loop().time() + self.max_wait
            while len(batch) < BUCKETS[-1]:
                timeout = deadline - asyncio.get_running_loop().time()
                if timeout <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(self._queue.get(), timeout))
                except asyncio.TimeoutError:
                    break
            await inflight.acquire()
            t0 = time.perf_counter()
            try:
                packed = await asyncio.to_thread(self._dispatch, [f for f, _ in batch])
            except Exception as e:
                inflight.release()
                self.outstanding -= len(batch)
                for _, f in batch:
                    if not f.done():
                        f.set_exception(RuntimeError(f"inference failed: {e}"))
                continue
            task = asyncio.get_running_loop().create_task(fetch_and_resolve(packed, batch, t0))
            fetch_tasks.add(task)
            task.add_done_callback(fetch_tasks.discard)

    def _dispatch(self, frames: list[np.ndarray]) -> torch.Tensor:
        """Enqueue one batch on the device; returns its packed scores
        [bucket, 6 or 7] without copying them to the host."""
        self.dispatches += 1
        return self._forward(self._stack(frames))

    def _stack(self, frames) -> torch.Tensor:
        """``frames`` on the device, zero-padded to their batch bucket."""
        n = len(frames)
        bucket = next(b for b in BUCKETS if b >= n)
        stack = np.zeros((bucket,) + frames[0].shape, np.float32)
        for i, f in enumerate(frames):
            stack[i] = f
        return torch.from_numpy(stack).to(self.device)

    def _infer(self, frames: list[np.ndarray]) -> list[dict]:
        """Dispatch and copy back at once (the warm-up's path)."""
        packed = self._dispatch(frames).cpu().numpy()
        return [self._row_to_dict(packed[i]) for i in range(len(frames))]

    def _row_to_dict(self, row: np.ndarray) -> dict:
        res = {
            "prediction": int(row[0]),
            "confidence": round(float(row[1]), 4),
            "model_anomaly": round(float(row[2]), 4),
            "entropy": round(float(row[3]), 4),
        }
        if self.uncertainty != "msp":
            res["mutual_information"] = round(float(row[4]), 4)
        if row[5] >= 0:
            res["conformal_set_size"] = int(row[5])
        if self._col_self_conf is not None:
            # monitored serving: row[1] was the min-gated confidence
            res["confidence_self"] = round(float(row[self._col_self_conf]), 4)
        return res
