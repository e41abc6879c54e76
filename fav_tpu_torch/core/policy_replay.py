"""Policy-space replay: observation streams, and grid cells, as trust
trajectories.

Counterpart of ``fav_tpu/core/policy_replay.py``. Each stream's L1 statuses
and composed anomalies become a 30 Hz observation stream replayed through
the trust scan (``core/trust_scan.py``: all streams at once, tick by tick,
on the device the caller names), and each stream is scored in policy space:
the share of ticks in each policy state, the time to BLOCKED, the final and
lowest reliability, the contradictions.

The stream composition is serving's: the tick anomaly is
``max(L1 analyzer anomaly, model anomaly)``, the model anomaly derived from
the operative confidence (``min(conf, mon_conf)`` when a monitor ran). The
composition is host numpy in float32, as in ``fav_tpu``, so the two agree
bit for bit before the replay.
"""

from __future__ import annotations

import numpy as np
import torch

from fav_tpu_torch.config import POLICY_NAMES, TrustParams
from fav_tpu_torch.core.trust_scan import TrustOutputs, simulate_batch
from fav_tpu_torch.device import resolve_device

__all__ = [
    "POLICY_TICKS_DEFAULT",
    "anomaly_from_confidence_np",
    "grid_policy",
    "replay_outputs",
    "replay_policy",
    "summarize_policy",
]

# 30 s at the serving tick rate: long enough for the slow ML-integral path
# to show, not only the fast explicit-status decays.
POLICY_TICKS_DEFAULT = 900
_DT = 1.0 / 30.0


def anomaly_from_confidence_np(confidence, allowed_floor: float = 0.6, scale: float = 2.5) -> np.ndarray:
    """Host float32 mirror of ``models/uncertainty.py:anomaly_from_confidence``:
    ``clip(max(0, floor - c) / floor * scale, 0, 1)``."""
    c = np.asarray(confidence, np.float32)
    deficit = np.maximum(np.float32(0.0), np.float32(allowed_floor) - c) / np.float32(allowed_floor)
    return np.clip(deficit * np.float32(scale), 0.0, 1.0)


def replay_outputs(statuses, anomalies, params: TrustParams | None = None, dt: float = _DT,
                   device: str | torch.device | None = None) -> TrustOutputs:
    """The trust scan's outputs [n, T] of ``n`` streams: int statuses and
    float anomalies [n, T] (numpy or tensors), every tick observed with its
    anomaly, ``dt`` apart, replayed on ``device`` (the card unless ``"cpu"``
    is asked for)."""
    dev = resolve_device(device)
    p = params or TrustParams()
    st = torch.as_tensor(statuses).to(dev, torch.int32)
    an = torch.as_tensor(anomalies).to(dev)
    if st.ndim != 2 or st.shape != an.shape:
        raise ValueError(f"expected matching [n, T], got {tuple(st.shape)} vs {tuple(an.shape)}")
    has = torch.ones(st.shape, dtype=torch.bool, device=dev)
    dts = torch.full(st.shape, dt, dtype=an.dtype, device=dev)
    return simulate_batch(p, st, an, has, dts)


def summarize_policy(outs: TrustOutputs, dt: float = _DT, wrong=None) -> list[dict]:
    """One dict per stream of replayed outputs [n, T]:
    ``policy_share_<state>``, ``time_to_blocked_s`` (-1.0 if never),
    ``final_reliability``, ``min_reliability``, ``contradictions`` and, given
    ``wrong`` [n, T] (1 where the model's prediction at that tick is
    wrong), ``allowed_wrong_share``."""
    policy = outs.policy.cpu().numpy()
    rel = outs.reliability.cpu().numpy().astype(np.float64)
    contra = outs.contradiction_count.cpu().numpy()
    n = policy.shape[0]
    rows = []
    for i in range(n):
        row: dict = {}
        for code, name in enumerate(POLICY_NAMES):
            row[f"policy_share_{name.lower()}"] = float(np.mean(policy[i] == code))
        blocked = np.nonzero(policy[i] == len(POLICY_NAMES) - 1)[0]
        # tick k is the state after (k + 1) dt of stream time
        row["time_to_blocked_s"] = float((blocked[0] + 1) * dt) if blocked.size else -1.0
        row["final_reliability"] = float(rel[i, -1])
        row["min_reliability"] = float(np.min(rel[i]))
        row["contradictions"] = int(contra[i, -1])
        if wrong is not None:
            # the policy at tick k is the gate in force while prediction k is served
            w = np.asarray(wrong)[i].astype(np.float64)
            row["allowed_wrong_share"] = float(np.mean((policy[i] == 0) * w))
        rows.append(row)
    return rows


def replay_policy(statuses, anomalies, params: TrustParams | None = None, dt: float = _DT, wrong=None,
                  device: str | torch.device | None = None) -> list[dict]:
    """Replay ``n`` observation streams through the trust scan and score each
    in policy space (``summarize_policy``)."""
    return summarize_policy(replay_outputs(statuses, anomalies, params, dt, device), dt, wrong)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def grid_policy(cells, rows: dict, params: TrustParams | None = None, ticks: int = POLICY_TICKS_DEFAULT,
                dt: float = _DT, device: str | torch.device | None = None) -> list[dict]:
    """Per-cell policy outcomes from a grid's per-sample rows.

    ``rows`` holds [n_cells, B] ``l1_status``, ``l1_anomaly``, ``conf``,
    ``correct`` and, for a monitored grid, ``mon_conf`` (numpy or tensors).
    Samples are consumed in batch order, tiled if the batch is shorter than
    ``ticks``. Returns one ``replay_policy`` dict per cell."""
    status = _host(rows["l1_status"])
    l1_anom = _host(rows["l1_anomaly"]).astype(np.float32)
    conf = _host(rows["conf"]).astype(np.float32)
    if "mon_conf" in rows:
        conf = np.minimum(conf, _host(rows["mon_conf"]).astype(np.float32))
    composed = np.maximum(l1_anom, anomaly_from_confidence_np(conf))
    wrong = 1.0 - _host(rows["correct"]).astype(np.float32)
    if status.shape[0] != len(cells):
        raise ValueError(f"rows carry {status.shape[0]} cells, expected {len(cells)}")
    idx = np.arange(ticks) % status.shape[1]
    return replay_policy(status[:, idx], composed[:, idx].astype(np.float64), params, dt,
                         wrong=wrong[:, idx], device=device)
