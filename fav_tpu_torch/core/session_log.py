"""Session logging — per-tick CSV evidence trail.

The port's copy of ``fav_tpu/core/session_log.py``; ``tests/test_torch_host.py``
holds its CSV to ``fav_tpu``'s byte for byte.

Parity target: the 11-column wire schema of
``platform/backend/session_logger.py:15-20`` (column order and per-column
precision are the CSV contract; the format mirrors the ROS 2 system's
``vision_reliability_log.csv``, docs/system_notes.md:230-249).

Internals are deliberately different from the reference's write-as-you-go
``csv.writer``: ticks are accumulated as raw value tuples and the CSV text is
rendered only when requested (``get_log`` is rare; ``log`` runs 30×/s), so the
hot path does no string formatting at all.
"""

from __future__ import annotations

import io
import time

# (column name, value extractor, render format) — the wire contract.
# Extractors pull raw python values from the engine state dict; rendering
# happens once, in get_csv.
_SCHEMA = (
    ("timestamp", lambda s, a: s.get("timestamp", time.time()), "{:.6f}"),
    ("reliability", lambda s, a: s.get("reliability", 0), "{:.6f}"),
    ("policy_state", lambda s, a: s.get("policy_state", ""), "{}"),
    ("anomaly", lambda s, a: a, "{:.6f}"),
    ("anomaly_integral", lambda s, a: s.get("anomaly_integral", 0), "{:.6f}"),
    ("vision_status", lambda s, a: s.get("vision_status", ""), "{}"),
    ("trust_velocity", lambda s, a: s.get("trust_velocity", 0), "{:.6f}"),
    ("recovery_debt", lambda s, a: s.get("recovery_debt", 0), "{:.4f}"),
    ("recovery_coeff", lambda s, a: s.get("recovery_coeff", 0.10), "{:.4f}"),
    ("contradiction_detected", lambda s, a: s.get("contradiction_detected", False), "{}"),
    ("contradiction_count", lambda s, a: s.get("contradiction_count", 0), "{}"),
)

HEADER = [name for name, _, _ in _SCHEMA]
_EXTRACTORS = tuple(fn for _, fn, _ in _SCHEMA)
_FORMATS = tuple(fmt for _, _, fmt in _SCHEMA)


class SessionLogger:
    """In-memory per-tick log, rendered to CSV on demand."""

    HEADER = HEADER

    def __init__(self):
        self._rows: list[tuple] = []

    def reset(self) -> None:
        self._rows = []

    def log(self, state: dict, anomaly_score: float) -> None:
        self._rows.append(tuple(fn(state, anomaly_score) for fn in _EXTRACTORS))

    def get_csv(self) -> str:
        out = io.StringIO()
        out.write(",".join(HEADER))
        out.write("\r\n")  # csv-module line convention, kept for byte parity
        for row in self._rows:
            out.write(",".join(fmt.format(v) for fmt, v in zip(_FORMATS, row)))
            out.write("\r\n")
        return out.getvalue()

    @property
    def entry_count(self) -> int:
        return len(self._rows)
