"""The process world of the parallel paths: one rank a process, NCCL on
the card and gloo on the CPU (the counterpart of the device runtime JAX
sets up by itself).

* :func:`init_world` joins the world ``torchrun`` describes (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``; a lone process is rank 0 of 1): NCCL on
  ``cuda:LOCAL_RANK`` unless the caller asks for ``"cpu"``, which takes
  gloo. With no card and no CPU asked for it raises, as
  ``device.resolve_device`` does; it never falls back from NCCL to gloo.
  Every collective of the world times out after ``timeout`` seconds, so a
  rank that hangs fails its caller instead of holding it.
* :class:`CpuWorld` spawns ``n`` gloo ranks on the CPU (the tests' worlds
  and the dry run's), keeps them for as many :meth:`CpuWorld.run` calls as
  the caller makes, and ends them on :meth:`CpuWorld.close`. A target
  runs in every rank as ``fn(world, *args)``; it is pickled by import path,
  so it lives in a module that imports no JAX (``parallel/dryrun.py``, the
  tests' ``torch_parallel_targets.py``). Every wait has a deadline; when a
  rank fails or a deadline passes, every rank is killed and the failure is
  raised with the rank's traceback.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import torch
import torch.distributed as dist

from fav_tpu_torch.device import resolve_device

__all__ = ["DEFAULT_TIMEOUT_S", "World", "CpuWorld", "current_world", "destroy_world", "init_world"]

DEFAULT_TIMEOUT_S = 60.0


@dataclass(frozen=True)
class World:
    """This process's place in the world."""
    rank: int
    size: int
    local_rank: int
    device: torch.device
    backend: str


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    return int(raw) if raw else default


def current_world() -> World | None:
    """The world this process joined, or None."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    backend = dist.get_backend()
    local = _env_int("LOCAL_RANK", 0)
    device = torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" else torch.device("cpu")
    return World(dist.get_rank(), dist.get_world_size(), local, device, backend)


def init_world(device: str | torch.device | None = None, init_method: str | None = None,
               timeout: float = DEFAULT_TIMEOUT_S, rank: int | None = None,
               world_size: int | None = None) -> World:
    """Join the world: ``rank`` and ``world_size`` default to ``torchrun``'s
    ``RANK`` and ``WORLD_SIZE`` (0 and 1 when unset), the device to
    ``cuda:LOCAL_RANK`` with NCCL; ``device="cpu"`` takes gloo.
    ``init_method`` defaults to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``, as ``torchrun`` sets them); a ``file://`` path needs no
    port. Returns the current world if this process already joined one."""
    world = current_world()
    if world is not None:
        return world
    dev = resolve_device(device)
    rank = _env_int("RANK", 0) if rank is None else int(rank)
    size = _env_int("WORLD_SIZE", 1) if world_size is None else int(world_size)
    local = _env_int("LOCAL_RANK", 0)
    if dev.type == "cuda":
        dev = torch.device("cuda", local if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=timeout))
    return World(rank, size, local, dev, backend)


def destroy_world() -> None:
    """Leave the world, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


# ── CPU worlds for the tests and the dry run ────────────────────────────


def _rank_main(rank: int, size: int, store: str, timeout: float, tasks, results) -> None:
    """A spawned rank: join the gloo world, then run each task sent to it
    until told to stop, reporting its result or its traceback."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    try:
        world = init_world("cpu", init_method=f"file://{store}", timeout=timeout, rank=rank, world_size=size)
    except Exception:  # noqa: BLE001 - reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        while True:
            task = tasks.get()
            if task is None:
                return
            fn, args = task
            try:
                results.put((rank, True, fn(world, *args)))
            except Exception:  # noqa: BLE001 - reported to the parent, which raises it
                results.put((rank, False, traceback.format_exc()))
                return
    finally:
        destroy_world()


class CpuWorld:
    """``n`` gloo ranks on the CPU, each a spawned process with one thread
    for its ops, kept across :meth:`run` calls. Use as a context manager."""

    def __init__(self, n: int, timeout: float = DEFAULT_TIMEOUT_S):
        if n < 1:
            raise ValueError(f"a world of {n} ranks")
        self.size = n
        self.timeout = timeout
        ctx = torch.multiprocessing.get_context("spawn")
        self._dir = tempfile.TemporaryDirectory(prefix="fav_world_")
        store = str(Path(self._dir.name) / "store")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(n)]
        self._procs = [ctx.Process(target=_rank_main, args=(r, n, store, timeout, self._tasks[r], self._results),
                                   daemon=True) for r in range(n)]
        for p in self._procs:
            p.start()
        self._dead: str | None = None

    def run(self, fn: Callable, *args, timeout: float | None = None) -> list[Any]:
        """``fn(world, *args)`` in every rank; returns the results by rank.
        Raises, after killing every rank, if one fails or the deadline
        (``timeout``, else the world's) passes."""
        if self._dead:
            raise RuntimeError(f"the CPU world is closed: {self._dead}")
        for q in self._tasks:
            q.put((fn, args))
        deadline = time.monotonic() + (timeout or self.timeout)
        out: dict[int, Any] = {}
        while len(out) < self.size:
            try:
                rank, ok, value = self._results.get(timeout=max(0.1, min(1.0, deadline - time.monotonic())))
            except queue.Empty:
                gone = [r for r, p in enumerate(self._procs) if not p.is_alive() and r not in out]
                if gone or time.monotonic() > deadline:
                    why = f"rank(s) {gone} exited without a result" if gone else "deadline passed"
                    self._kill(why)
                    raise RuntimeError(f"{getattr(fn, '__name__', fn)} on {self.size} CPU ranks: {why}")
                continue
            if not ok:
                self._kill(f"rank {rank} failed")
                raise RuntimeError(f"{getattr(fn, '__name__', fn)} failed on rank {rank} of {self.size}:\n{value}")
            out[rank] = value
        return [out[r] for r in range(self.size)]

    def _kill(self, why: str) -> None:
        self._dead = why
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(timeout=10)
        self._dir.cleanup()

    def close(self) -> None:
        """Stop every rank (each leaves the world), killing any that does not
        end within the world's timeout."""
        if self._dead:
            return
        for q in self._tasks:
            q.put(None)
        deadline = time.monotonic() + self.timeout
        for p in self._procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
        self._kill("closed")

    def __enter__(self) -> "CpuWorld":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

