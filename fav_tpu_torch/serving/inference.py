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
predictor's own confidence; with a Mahalanobis fit, the last holds the
feature distance (column 6, or 7 under a monitor). The monitor's
confidence min-gates the predictor's, and the monitor must restore: a bad
``monitor_dir`` fails the service instead of gating with noise.

The four modes (``uncertainty=``), each with its default weights under
``weights/``:

* ``msp`` (``student_nano``): one forward, softmax at the temperature;
* ``mc_dropout`` (``classifier``): ``mc_samples`` dropout replicas folded
  into one forward, fresh masks every batch from a generator the service
  owns (``fav_tpu`` folds a per-call counter into its key for the same
  end: a spread that is not a constant); mutual information in column 4;
* ``ensemble`` (``ensemble``): the mean of the members' tempered softmaxes;
* ``autoencoder`` (``autoencoder``): the per-frame reconstruction error
  ``err`` is the anomaly, ``clip((err - b) / 9b, 0, 1)`` with ``b`` the
  metadata's ``err_baseline``; the row is ``[-1, 1 - anomaly, anomaly,
  err, 0, -1]`` (no label space, no certificate), and a monitor is
  refused.

Missing weights serve a random initialisation marked ``degraded``. In the
``mc_dropout``, ``ensemble`` and ``autoencoder`` modes weights that exist
but do not load raise, and so does an ensemble copy whose member count
differs from its metadata's (``utils/checkpoint.py:load_weights``): the
worker then fails every frame it is given.

The feature distance (``fav_tpu/serving/inference.py:203-251,317-334``):
in ``msp`` mode, weights that loaded and carry a Mahalanobis fit beside
them (``<stem>.maha_fit.npz``, written by ``fav_tpu_torch.tools.fit_maha``
or by ``fav_tpu``'s ``tools/fit_maha.py``) stream ``feature_distance``,
the normalized relative Mahalanobis distance of the frame's penultimate
features (0 near a typical training frame, 1 at the 99th percentile of
the held-out training data; ``models/mahalanobis.py``). The fit moves to
the device once, at the model's build. A fit whose feature size is not
the model's penultimate width is stale: the service says so on stderr
and serves without the column, never failing for it.

The forwards run on ``device`` through cuDNN and cuBLAS; ``fav_tpu``
computes them outside any Pallas kernel, so no hand-written kernel stands
behind them. Softmax, set sizes and the packed row are torch ops on the
same device. ``inference_device`` is recorded after the copy of a batch's
row to the host, which waits for the batch on the card.
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
from fav_tpu_torch.models.cnn import ConvAutoencoder, create_autoencoder, create_model, init_params
from fav_tpu_torch.models.conformal import prediction_sets, set_sizes
from fav_tpu_torch.models.mahalanobis import load_fit, mahalanobis_scores, normalized_rmd
from fav_tpu_torch.models.uncertainty import (
    anomaly_from_confidence,
    ensemble_probs,
    init_ensemble,
    mc_dropout_probs,
    mutual_information,
    predictive_entropy,
)
from fav_tpu_torch.utils.checkpoint import WEIGHTS_DIR, flax_to_torch, load_flax_npz, load_weights

__all__ = ["InferenceService", "BUCKETS", "MAHA_FIT_SUFFIX", "DEFAULT_WEIGHTS", "MC_DROPOUT_SEED"]

BUCKETS = (1, 8, 32)
MAHA_FIT_SUFFIX = ".maha_fit.npz"  # fav_tpu/models/mahalanobis.py:52 keeps it beside a checkpoint
# each mode's weights under weights/ (fav_tpu/serving/inference.py:355-381);
# msp's default falls back student_nano -> student_compact -> classifier
DEFAULT_WEIGHTS = {"mc_dropout": "classifier", "ensemble": "ensemble", "autoencoder": "autoencoder"}
MC_DROPOUT_SEED = 7  # fav_tpu's PRNGKey(7)
AE_BASELINE_DEFAULT = 0.002  # fav_tpu's err_baseline when the metadata has none


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
        self._col_rmd: int | None = None
        self.has_feature_distance = False  # resolved at the model's build
        self.dispatches = 0  # batches dispatched, warm-up included
        self.frames_scored = 0  # frames whose scores reached their caller
        self.outstanding = 0  # frames submitted whose batch has not come back

    # ── model set-up (first use, in the worker's thread) ──
    def _ensure_model(self) -> None:
        if self._forward is not None:
            return
        dev = self.device
        pre_meta = self._peek_metadata()
        cfg = model_params_from_metadata(self.cfg, pre_meta)
        ckpt = self._resolve_ckpt_dir()
        self.source = "random_init"
        if self.uncertainty == "msp":
            model = self._load_msp(cfg, pre_meta, ckpt)
        elif os.path.isfile(ckpt + ".npz"):
            # the multi-forward and autoencoder modes never serve random
            # weights in place of weights that exist: a failed load raises
            members = None
            if self.uncertainty == "ensemble":
                members = int(pre_meta.get("ensemble_size") or self.cfg.ensemble_size)
            model, _ = load_weights(os.path.basename(ckpt), device=dev, directory=os.path.dirname(ckpt),
                                    members=members)
            if (self.uncertainty == "autoencoder") != isinstance(model, ConvAutoencoder) \
                    or (self.uncertainty == "mc_dropout" and isinstance(model, list)):
                raise ValueError(f"{ckpt}: not weights for uncertainty={self.uncertainty!r} (metadata {pre_meta})")
            self._meta = pre_meta
            self._temperature = float(pre_meta.get("temperature", 1.0))
            self.source = f"checkpoint:{ckpt}"
        elif self.uncertainty == "autoencoder":
            widths = pre_meta.get("ae_widths")
            model = create_autoencoder(self.cfg) if widths is None else ConvAutoencoder(
                widths=tuple(widths), latent=int(pre_meta.get("ae_latent", widths[-1])))
            model = init_params(model, torch.Generator().manual_seed(0))
        elif self.uncertainty == "ensemble":
            size = int(pre_meta.get("ensemble_size") or self.cfg.ensemble_size)
            model = init_ensemble(create_model(cfg), torch.Generator().manual_seed(0), size)
        else:
            model = init_params(create_model(cfg), torch.Generator().manual_seed(0))
        model = [m.to(dev).eval() for m in model] if isinstance(model, list) else model.to(dev).eval()
        temperature = self._temperature
        qhat = self._meta.get("conformal_qhat")
        fit = self._load_maha_fit(model, ckpt) if self.uncertainty == "msp" else None
        self.has_feature_distance = fit is not None
        # the packed row's layout, fixed at build: 6 columns, the monitored
        # self-confidence, then the feature distance
        self._col_self_conf = 6 if self._monitor_dir else None
        self._col_rmd = (7 if self._monitor_dir else 6) if fit is not None else None

        if self.uncertainty == "autoencoder":
            baseline = float(self._meta.get("err_baseline", AE_BASELINE_DEFAULT)) or AE_BASELINE_DEFAULT

            @torch.no_grad()
            def ae_forward(images: torch.Tensor) -> torch.Tensor:
                """The packed [B, 6] row of the classifier modes: prediction -1
                (no label space), the raw reconstruction error in the entropy
                slot, set size -1 (no certificate)."""
                err = ConvAutoencoder.reconstruction_error(model(images), images)
                anomaly = torch.clamp((err - baseline) / (9.0 * baseline), 0.0, 1.0)
                minus = torch.full_like(err, -1.0)
                return torch.stack([minus, 1.0 - anomaly, anomaly, err, torch.zeros_like(err), minus], dim=-1)

            self._probabilities, self._summarize = None, None
            self._forward = ae_forward
            return

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

        def summarize(member_probs: torch.Tensor, mon_conf: torch.Tensor | None,
                      rmd: torch.Tensor | None = None) -> torch.Tensor:
            """Every score of a batch in ONE float32 [B, 6] tensor (+1 column
            with a monitor, +1 with a fit): one device-to-host copy per
            batch. With a monitor, column 1 is the min-gated confidence and
            drives the anomaly; column 6 keeps the predictor's own. The
            feature distance ``rmd`` comes last."""
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
            if rmd is not None:
                cols.append(rmd.to(f32))
            return torch.stack(cols, dim=-1)

        mode, mc_samples = self.uncertainty, self.cfg.mc_samples
        generator = torch.Generator(device=dev).manual_seed(MC_DROPOUT_SEED) if mode == "mc_dropout" else None

        @torch.no_grad()
        def probabilities(images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
            """The predictor's tempered member probabilities [M, B, C] (one
            member for msp), the monitor's confidence [B] and the feature
            distance [B] (each None without a monitor or a fit)."""
            mon_conf = None
            if monitor is not None:
                mon_conf = torch.softmax(monitor(images) / mon_t, dim=-1).amax(dim=-1)
            if mode == "mc_dropout":
                return mc_dropout_probs(model, images, generator, mc_samples, temperature), mon_conf, None
            if mode == "ensemble":
                return ensemble_probs(model, images, temperature), mon_conf, None
            if fit is None:
                return torch.softmax(model(images) / temperature, dim=-1)[None], mon_conf, None
            feats, logits = model.features_and_logits(images)
            rmd = normalized_rmd(mahalanobis_scores(feats, fit)["rmd"], fit)
            return torch.softmax(logits / temperature, dim=-1)[None], mon_conf, rmd

        def forward(images: torch.Tensor) -> torch.Tensor:
            return summarize(*probabilities(images))

        self._probabilities, self._summarize = probabilities, summarize
        self._forward = forward

    def _load_msp(self, cfg: ModelParams, pre_meta: dict, ckpt: str) -> torch.nn.Module:
        """The msp predictor: the weights at ``ckpt``, or a random
        initialisation said out loud (``restore_error``, ``degraded``) when
        they are missing or fail to load."""
        model = init_params(create_model(cfg), torch.Generator().manual_seed(0))
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
        return model

    def _load_maha_fit(self, model: torch.nn.Module, ckpt: str):
        """The Mahalanobis fit beside weights that loaded, on the device, or
        None: no fit, no loaded weights, or a stale fit (its feature size
        is not the model's penultimate width), which is said on stderr."""
        fit_path = ckpt + MAHA_FIT_SUFFIX
        if not self.source.startswith("checkpoint:") or not os.path.isfile(fit_path):
            return None
        fit = load_fit(fit_path)
        sample = torch.zeros((1, self.cfg.image_size, self.cfg.image_size, self.cfg.channels), device=self.device)
        with torch.no_grad():
            feat_dim = model.features_and_logits(sample)[0].shape[-1]
        fit_dim = fit.class_means.shape[1]
        if fit_dim != feat_dim:
            print(f"[fav_tpu_torch] WARNING: {fit_path} feature dim {fit_dim} != model penultimate width "
                  f"{feat_dim}; ignoring the stale fit (refit with fav_tpu_torch.tools.fit_maha)", file=sys.stderr)
            return None
        return fit.to(self.device)

    def _resolve_ckpt_dir(self) -> str:
        """The weight stem to serve: the one given, else the mode's default
        under ``weights/`` (:data:`DEFAULT_WEIGHTS`; for ``msp``
        ``student_nano``, falling back to ``student_compact``, then
        ``classifier``), as ``fav_tpu``'s choice (:355) maps onto the port's
        copies."""
        if self._checkpoint_dir is not None:
            return str(self._checkpoint_dir)
        if self.uncertainty in DEFAULT_WEIGHTS:
            return os.path.join(str(WEIGHTS_DIR), DEFAULT_WEIGHTS[self.uncertainty])
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
        if self.has_feature_distance:
            info["feature_distance"] = True  # the dashboard's badge: the column is served
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

    def score_batch(self, frames, members: bool = False) -> tuple[np.ndarray, np.ndarray | None]:
        """Score ``frames`` [n, S, S, 3] (float, in [0, 1]) as one batch,
        outside the worker and its counts: returns the packed rows [n, 6 to
        8] that the worker serves for them and the predictor's tempered
        probabilities [n, C] that the rows derive from (``members``: each
        member's or replica's, [M, n, C]; None for the autoencoder). Builds
        the model on first use; an MC-dropout batch draws its masks from
        the service's generator as the worker's do. Blocking: call it off
        the event loop."""
        self._ensure_model()
        n = len(frames)
        if self._probabilities is None:
            return self._forward(self._stack(frames))[:n].cpu().numpy(), None
        member_probs, mon_conf, rmd = self._probabilities(self._stack(frames))
        packed = self._summarize(member_probs, mon_conf, rmd)
        probs = member_probs[:, :n] if members else member_probs.mean(dim=0)[:n]
        return packed[:n].cpu().numpy(), probs.cpu().numpy()

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
        [bucket, 6 to 8] without copying them to the host."""
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
        if self._col_rmd is not None:
            # normalized relative Mahalanobis: 0 near a typical training
            # frame, 1 at the 99th percentile of the training data
            res["feature_distance"] = round(float(row[self._col_rmd]), 4)
        return res
