"""Evidence replay: re-run a logged session through the trust engine.

Counterpart of ``fav_tpu/tools/replay.py``. Given an 11-column session CSV
(the ``get_log`` download, :class:`fav_tpu_torch.core.session_log.SessionLogger`'s
schema), it re-executes the trust recurrence on the logged inputs
(vision_status, anomaly, each row's dt from the timestamps) and reports the
largest deviation of each tracked field from the logged trajectory. A clean
replay certifies that the evidence agrees with the engine's dynamics; a
divergence points at tampering, version drift or a serving fault, and the
first gross one (over 0.05) is named with its row.

    python -m fav_tpu_torch.tools.replay session.csv [--tolerance 5e-4]

Prints one JSON line; exits 0 when every field reproduces within the
tolerance, 1 otherwise. The default tolerance covers the log's rounding
(reliability, integral and velocity print with six decimals, debt and
coefficient with four) carried through the state's feedback, and is far
below what a real divergence (a wrong decay constant, a skipped tick)
gives.
"""

from __future__ import annotations

import argparse
import csv
import io
import json
import sys

from fav_tpu_torch.config import TrustParams
from fav_tpu_torch.core.session_log import HEADER
from fav_tpu_torch.core.trust import TrustEngine

__all__ = ["TRACKED", "GROSS", "replay_csv", "main"]

TRACKED = ("reliability", "anomaly_integral", "recovery_debt", "recovery_coeff")
GROSS = 0.05  # a deviation beyond this marks the first gross divergence


def replay_csv(text: str, params: TrustParams | None = None) -> dict:
    """Replay a session CSV; returns ``{"rows", "max_dev", "first_gross_divergence"}``
    (``{"rows": 0, "ok": True, "max_dev": {}}`` for an empty log). Raises
    ``ValueError`` when a column of the schema is missing."""
    rows = list(csv.DictReader(io.StringIO(text)))
    if not rows:
        return {"rows": 0, "ok": True, "max_dev": {}}
    missing = set(HEADER) - set(rows[0].keys())
    if missing:
        raise ValueError(f"not a session CSV; missing columns {sorted(missing)}")

    engine = TrustEngine(params or TrustParams())
    # each row's dt from the timestamps; the first row's ran from the
    # connection's start, which the log does not hold: the median gap
    ts = [float(r["timestamp"]) for r in rows]
    gaps = [b - a for a, b in zip(ts, ts[1:])] or [1.0 / 30.0]
    first_dt = sorted(gaps)[len(gaps) // 2]

    max_dev = {k: 0.0 for k in TRACKED}
    first_bad: dict | None = None
    for i, row in enumerate(rows):
        dt = first_dt if i == 0 else ts[i] - ts[i - 1]
        state = engine.update(row["vision_status"], float(row["anomaly"]), dt)
        for k in TRACKED:
            dev = abs(state[k] - float(row[k]))
            if dev > max_dev[k]:
                max_dev[k] = dev
                if first_bad is None and dev > GROSS:
                    first_bad = {"row": i + 1, "field": k, "logged": float(row[k]), "replayed": state[k]}
    return {
        "rows": len(rows),
        "max_dev": {k: round(v, 8) for k, v in max_dev.items()},
        "first_gross_divergence": first_bad,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("csv_path")
    parser.add_argument("--tolerance", type=float, default=5e-4,
                        help="max allowed per-field deviation (default 5e-4; "
                             "the first-row dt is estimated, so exact zero is "
                             "only achievable for fixed-dt playground logs)")
    args = parser.parse_args(argv)
    with open(args.csv_path, encoding="utf-8") as f:
        result = replay_csv(f.read())
    result["tolerance"] = args.tolerance
    result["ok"] = all(v <= args.tolerance for v in result["max_dev"].values())
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
