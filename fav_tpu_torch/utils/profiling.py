"""Tracing / profiling (SURVEY.md §5.1).

The port's copy of ``fav_tpu/utils/profiling.py``. The reference has no
backend tracing — only a frontend FPS counter (reference
app.js:54-57,715-723). The port provides:

* :class:`LatencyStats` — lock-free-ish streaming latency histogram with
  log-spaced bins (10 us .. 10 s) giving count / mean / p50 / p95 / p99 per
  pipeline stage,
* :class:`StageTimer` — context manager feeding a stats registry; the
  streaming server wraps analysis / inference / encode / tick with it and
  exposes the registry at ``/api/metrics``.

A stage times the host's wall clock. Work on the card is asynchronous, so a
stage that times device work must end on that work's result: the services
record ``analysis_device`` and ``inference_device`` only after the copy of
a batch's packed results to the host, which waits for the batch, and the
server's ``analysis`` and ``inference`` stages await those results. None
times a bare launch. Device-level traces come from ``torch.profiler``
(``chip_smoke.py --profile``), in place of ``fav_tpu``'s ``profiler_trace``.
"""

from __future__ import annotations

import contextlib
import math
import time

__all__ = ["LatencyStats", "StageTimer"]

_BIN_LO = 1e-5  # 10 us
_BIN_HI = 10.0  # 10 s
_NUM_BINS = 96
_LOG_LO = math.log(_BIN_LO)
_LOG_RATIO = (math.log(_BIN_HI) - _LOG_LO) / _NUM_BINS


class LatencyStats:
    """Streaming latency histogram with log-spaced bins."""

    def __init__(self) -> None:
        self.counts = [0] * (_NUM_BINS + 2)  # + underflow/overflow
        self.total = 0
        self.sum = 0.0
        self.max = 0.0

    def record(self, seconds: float) -> None:
        self.total += 1
        self.sum += seconds
        if seconds > self.max:
            self.max = seconds
        if seconds < _BIN_LO:
            idx = 0
        elif seconds >= _BIN_HI:
            idx = _NUM_BINS + 1
        else:
            idx = 1 + int((math.log(seconds) - _LOG_LO) / _LOG_RATIO)
        self.counts[idx] += 1

    def _quantile(self, q: float) -> float:
        if self.total == 0:
            return 0.0
        target = q * self.total
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                if i == 0:
                    return _BIN_LO
                if i == _NUM_BINS + 1:
                    return self.max
                return math.exp(_LOG_LO + (i - 0.5) * _LOG_RATIO)
        return self.max

    def summary(self) -> dict:
        return {
            "count": self.total,
            "mean_ms": round(1e3 * self.sum / self.total, 3) if self.total else 0.0,
            "p50_ms": round(1e3 * self._quantile(0.50), 3),
            "p95_ms": round(1e3 * self._quantile(0.95), 3),
            "p99_ms": round(1e3 * self._quantile(0.99), 3),
            "max_ms": round(1e3 * self.max, 3),
        }


class StageTimer:
    """Registry of named LatencyStats + a context manager to feed them.

    >>> timer = StageTimer()
    >>> with timer.stage("analysis"):
    ...     do_work()
    >>> timer.summary()["analysis"]["p95_ms"]

    With ``keep_samples`` it also keeps every recorded duration in
    ``samples`` (seconds by stage), for exact percentiles over a short run.
    """

    def __init__(self, keep_samples: bool = False) -> None:
        self._stats: dict[str, LatencyStats] = {}
        self.samples: dict[str, list[float]] | None = {} if keep_samples else None

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        stats = self._stats.get(name)
        if stats is None:
            stats = self._stats[name] = LatencyStats()
        stats.record(seconds)
        if self.samples is not None:
            self.samples.setdefault(name, []).append(seconds)

    def summary(self) -> dict:
        return {name: s.summary() for name, s in self._stats.items()}
