"""Failure attribution — excursion tracking with cause dominance.

The port's copy of ``fav_tpu/core/attribution.py``, held to it exactly by
``tests/test_torch_host.py``.

Parity target: ``platform/backend/failure_attributor.py`` in the reference.
An *excursion* is a contiguous period with reliability < 0.7; each completed
excursion records start time, duration, minimum reliability, dominant cause
(priority CORRUPTED > BLANK > FROZEN > ML_ANOMALY, failure_attributor.py:15-21)
and recovery time. Per-tick cause is the vision status, or ML_ANOMALY when
the rules say OK but the anomaly integral exceeds 0.5
(failure_attributor.py:43-53).
"""

from __future__ import annotations

import csv
import io

_CAUSE_PRIORITY = {"CORRUPTED": 4, "BLANK": 3, "FROZEN": 2, "ML_ANOMALY": 1, "NONE": 0}
_STATUS_TO_CAUSE = {
    "VISION_FROZEN": "FROZEN",
    "VISION_BLANK": "BLANK",
    "VISION_CORRUPTED": "CORRUPTED",
}

EVENTS_CSV_HEADER = ["start_time", "duration_s", "min_reliability", "cause", "recovery_time_s"]


def tick_cause(vision_status: str, ml_active: bool, anomaly_integral: float) -> str:
    """Primary degradation cause for one tick (failure_attributor.py:43-53)."""
    cause = _STATUS_TO_CAUSE.get(vision_status)
    if cause is not None:
        return cause
    if ml_active and anomaly_integral > 0.5:
        return "ML_ANOMALY"
    return "NONE"


class FailureAttributor:
    """Tracks reliability excursions below the 0.7 gate and attributes causes."""

    THRESHOLD = 0.7

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._events: list[dict] = []
        self._active: dict | None = None  # open excursion, if any

    def update(self, state: dict, timestamp: float) -> None:
        reliability = state["reliability"]
        cause = tick_cause(
            state["vision_status"],
            state.get("ml_influence_active", False),
            state.get("anomaly_integral", 0.0),
        )

        below = reliability < self.THRESHOLD
        if below and self._active is None:
            self._active = {"start": timestamp, "min": reliability, "cause": cause}
        elif below:
            self._active["min"] = min(self._active["min"], reliability)
            if _CAUSE_PRIORITY.get(cause, 0) > _CAUSE_PRIORITY.get(self._active["cause"], 0):
                self._active["cause"] = cause
        elif self._active is not None:
            elapsed = timestamp - self._active["start"]
            self._events.append(
                {
                    "start_time": round(self._active["start"], 3),
                    "duration_s": round(elapsed, 3),
                    "min_reliability": round(self._active["min"], 4),
                    "cause": self._active["cause"],
                    "recovery_time_s": round(elapsed, 3),
                }
            )
            self._active = None

    def get_events(self) -> list[dict]:
        return list(self._events)

    def get_summary(self) -> dict:
        """Compact streaming summary (failure_attributor.py:93-108)."""
        if not self._events:
            return {"total_excursions": 0}
        causes = [e["cause"] for e in self._events]
        return {
            "total_excursions": len(self._events),
            "by_cause": {c: causes.count(c) for c in set(causes)},
            "mean_recovery_s": round(
                sum(e["recovery_time_s"] for e in self._events) / len(self._events), 3
            ),
            "worst_reliability": round(min(e["min_reliability"] for e in self._events), 4),
        }

    def get_events_csv(self) -> str:
        buf = io.StringIO()
        writer = csv.writer(buf)
        writer.writerow(EVENTS_CSV_HEADER)
        for e in self._events:
            writer.writerow([e[k] for k in EVENTS_CSV_HEADER])
        return buf.getvalue()
