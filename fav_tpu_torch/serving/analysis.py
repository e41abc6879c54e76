"""Micro-batched, device-resident frame-analysis service.

Counterpart of ``fav_tpu/serving/analysis.py``. The per-stream
``SignalAnalyzer`` facade makes one device call per frame; this service
gathers the frames of all live streams into one call of the batched
analyzer (``ops/signal.py:analyze_frame``, K7 on the card), so N streams
cost one K7 launch and one device-to-host copy.

* Each live stream owns a SLOT in one device-resident batched
  ``AnalyzerCarry`` of ``capacity + 1`` rows; the last row is scratch for
  bucket padding. A batch gathers its slots' rows, analyzes them and
  writes them back in place (``index_copy_``), so carries never leave the
  device and are never re-stacked.
* A freshly acquired or reset slot restarts its temporal state through the
  ``reset`` mask on its next analyzed frame: no extra call.
* Every metric of a batch is packed on the device into one [B, 10]
  float32 tensor (``ops/signal.py:pack_metrics``): one device-to-host copy
  per batch, read back into dicts by ``row_to_dict``.
* Frame uploads follow the active batch, padded to a bucket of 1, 8 or 32
  rows with the scratch slot.

The worker dispatches a batch, then hands the copy of its packed results
to a thread and goes on collecting the next batch. Every device call and
every in-place update of the carry is enqueued on PyTorch's current stream
of the device, so they run in the order they were dispatched, and a batch
never holds two frames of one stream.
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional

import numpy as np
import torch

from fav_tpu_torch.config import AnalyzerParams
from fav_tpu_torch.device import resolve_device
from fav_tpu_torch.ops.signal import AnalyzerCarry, analyze_frame, init_analyzer_carry, pack_metrics, row_to_dict

__all__ = ["AnalysisService", "BUCKETS"]

BUCKETS = (1, 8, 32)


class AnalysisService:
    """Shared micro-batched frame-quality analysis across streams.

    ``device`` is the card unless ``"cpu"`` is asked for; ``plain`` runs
    the plain versions on the card in place of K7. ``timer``, if given, is
    any object with ``record(name, seconds)``: it receives each batch's
    dispatch-to-result latency as ``analysis_device``."""

    _MAX_INFLIGHT = 4  # batches whose results are being copied at once

    def __init__(
        self,
        params: AnalyzerParams | None = None,
        height: int = 240,
        width: int = 320,
        max_wait_ms: float = 4.0,
        capacity: int = 64,
        timer=None,
        device: str | torch.device | None = None,
        plain: bool = False,
    ):
        self.params = params or AnalyzerParams()
        self.height = height
        self.width = width
        self.max_wait = max_wait_ms / 1e3
        self.capacity = capacity
        self.timer = timer
        self.device = resolve_device(device)
        self.plain = plain
        self._queue: asyncio.Queue = asyncio.Queue()
        self._worker: Optional[asyncio.Task] = None
        self._started = False
        self.ready = False  # True once every bucket has run once
        self.dispatches = 0  # batches analyzed, warm-up included
        self.buckets: dict[int, int] = {}  # batches analyzed by bucket, warm-up included
        self.frames_analyzed = 0  # frames whose results reached their caller
        self.outstanding = 0  # frames submitted whose batch has not come back
        self._free = list(range(capacity))
        self._pending_reset: set[int] = set()
        self._carry: AnalyzerCarry | None = None  # device-resident, capacity + 1 rows

    # ── stream lifecycle ──
    def acquire_slot(self) -> Optional[int]:
        """Claim a carry slot for a new stream; None at capacity (the caller
        falls back to a per-stream analyzer)."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._pending_reset.add(slot)
        return slot

    def release_slot(self, slot: int) -> None:
        if 0 <= slot < self.capacity and slot not in self._free:
            self._free.append(slot)

    def reset_slot(self, slot: int) -> None:
        """Restart a stream's temporal state (a source switch, an engine
        reset) and keep its slot; applied on its next frame."""
        self._pending_reset.add(slot)

    def _ensure_worker(self) -> None:
        if not self._started:
            self._started = True
            self._worker = asyncio.get_running_loop().create_task(self._run())

    def start(self) -> None:
        """Start the worker (the carry's set-up and one launch of every
        bucket) on the running loop; ``ready`` turns True when it is done."""
        self._ensure_worker()

    async def analyze(self, frame_bgr: np.ndarray, slot: int) -> dict:
        """Submit one HxWx3 uint8 BGR frame of a claimed slot; returns the
        analysis dict."""
        self._ensure_worker()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self.outstanding += 1
        await self._queue.put((frame_bgr, slot, fut))
        return await fut

    async def maybe_analyze(self, frame_bgr: np.ndarray, slot: int) -> Optional[dict]:
        """The streaming tick's variant: None until every bucket has run once
        (the first launch builds K7), so a heartbeat keeps flowing; starts
        the warm-up on its first call."""
        self._ensure_worker()
        if not self.ready:
            return None
        return await self.analyze(frame_bgr, slot)

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
    def _init_device_state(self) -> None:
        # + 1 scratch row: bucket padding writes there harmlessly
        self._carry = init_analyzer_carry(self.height, self.width, (self.capacity + 1,), device=self.device)

    async def _run(self) -> None:
        # run every bucket once before declaring ready: the first launch
        # builds and loads K7
        try:
            await asyncio.to_thread(self._init_device_state)
            warm = np.zeros((self.height, self.width, 3), np.uint8)
            for bucket in BUCKETS:
                # the scratch slot for every row: warm-up touches no real slot
                await asyncio.to_thread(self._analyze_batch, [warm] * bucket, [self.capacity] * bucket, set())
            self.ready = True
        except Exception:
            import traceback

            traceback.print_exc()
            # ready stays False: maybe_analyze keeps returning None
        inflight = asyncio.Semaphore(self._MAX_INFLIGHT)
        pending: list = []
        inflight_slots: set[int] = set()
        fetch_tasks: set = set()  # strong references: the loop holds tasks weakly

        async def fetch_and_resolve(packed, batch, t0):
            try:
                host = await asyncio.to_thread(lambda: packed.cpu().numpy())
                if self.timer is not None:
                    # dispatch-to-results latency of this batch (copies
                    # overlap, so this is not the worker's serial cost)
                    self.timer.record("analysis_device", time.perf_counter() - t0)
                for i, (_, _, fut) in enumerate(batch):
                    if not fut.done():
                        fut.set_result(row_to_dict(host[i]))
                self.frames_analyzed += len(batch)
            except Exception as e:
                for _, _, fut in batch:
                    if not fut.done():
                        fut.set_exception(RuntimeError(f"analysis failed: {e}"))
            finally:
                inflight_slots.difference_update(s for _, s, _ in batch)
                self.outstanding -= len(batch)
                inflight.release()

        while True:
            item = pending.pop(0) if pending else await self._queue.get()
            batch = [item]
            slots_in = {item[1]}
            deadline = asyncio.get_running_loop().time() + self.max_wait
            while len(batch) < BUCKETS[-1]:
                timeout = deadline - asyncio.get_running_loop().time()
                if timeout <= 0:
                    break
                try:
                    nxt = await asyncio.wait_for(self._queue.get(), timeout)
                except asyncio.TimeoutError:
                    break
                if nxt[1] in slots_in or nxt[1] in inflight_slots:
                    # the same stream again: a whole wave is collected; flush
                    # now and keep the newcomer for the next batch (two
                    # frames of one stream in flight would race on the
                    # carry's order and on which result is whose)
                    pending.append(nxt)
                    break
                batch.append(nxt)
                slots_in.add(nxt[1])
            await inflight.acquire()
            resets = {s for _, s, _ in batch if s in self._pending_reset}
            t0 = time.perf_counter()
            try:
                packed = await asyncio.to_thread(
                    self._dispatch_batch, [b[0] for b in batch], [b[1] for b in batch], resets)
                self._pending_reset -= resets
                inflight_slots.update(slots_in)
                task = asyncio.get_running_loop().create_task(fetch_and_resolve(packed, batch, t0))
                fetch_tasks.add(task)
                task.add_done_callback(fetch_tasks.discard)
            except Exception as e:
                inflight.release()
                self.outstanding -= len(batch)
                for _, _, fut in batch:
                    if not fut.done():
                        fut.set_exception(RuntimeError(f"analysis failed: {e}"))
                # a failed in-place update may leave the carry half written:
                # rebuild it (streams lose their temporal context and recover
                # it in two frames) rather than serve from it
                try:
                    await asyncio.to_thread(self._init_device_state)
                    self._pending_reset.update(range(self.capacity))
                except Exception:
                    self.ready = False

    def _dispatch_batch(self, frames: list, slots: list, resets: set) -> torch.Tensor:
        """Enqueue one batch on the device; returns its packed metrics
        [bucket, 10] without copying them to the host."""
        n = len(frames)
        bucket = next(b for b in BUCKETS if b >= n)
        stack = np.zeros((bucket, self.height, self.width, 3), np.uint8)
        for i, f in enumerate(frames):
            stack[i] = f
        slot_arr = np.full((bucket,), self.capacity, np.int64)  # pads -> scratch
        slot_arr[:n] = slots
        reset_arr = np.zeros((bucket,), bool)
        reset_arr[n:] = True
        for i, s in enumerate(slots):
            reset_arr[i] = s in resets
        dev = self.device
        frames_t = torch.from_numpy(stack).to(dev)
        idx = torch.from_numpy(slot_arr).to(dev)
        reset = torch.from_numpy(reset_arr).to(dev)
        carry = self._carry
        sub = AnalyzerCarry(
            prev_gray=torch.where(reset[:, None, None], 0, carry.prev_gray.index_select(0, idx)),
            has_prev=torch.where(reset, False, carry.has_prev.index_select(0, idx)),
            consecutive_frozen=torch.where(reset, 0, carry.consecutive_frozen.index_select(0, idx)),
        )
        new_sub, m = analyze_frame(self.params, sub, frames_t, plain=self.plain)
        carry.prev_gray.index_copy_(0, idx, new_sub.prev_gray)
        carry.has_prev.index_copy_(0, idx, new_sub.has_prev)
        carry.consecutive_frozen.index_copy_(0, idx, new_sub.consecutive_frozen)
        self.dispatches += 1
        self.buckets[bucket] = self.buckets.get(bucket, 0) + 1
        return pack_metrics(m)

    def _analyze_batch(self, frames: list, slots: list, resets: set) -> list:
        """Dispatch and copy back at once (the warm-up's path)."""
        host = self._dispatch_batch(frames, slots, resets).cpu().numpy()
        return [row_to_dict(host[i]) for i in range(len(frames))]
