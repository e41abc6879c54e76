"""The branchless trust scan over many streams at once.

Counterpart of ``fav_tpu/core/trust_jax.py``. One tick (``trust_step``)
advances every stream of a carry with a leading stream axis [S], where
``fav_tpu`` writes one stream and ``vmap``s it; a replay
(``simulate_batch``) loops over time where ``fav_tpu`` runs ``lax.scan``.

* Every branch of the engine (first tick, status change, OK dynamics,
  failure dynamics) is a ``torch.where`` over disjoint masks, so one
  sequence of tensor ops serves every tick of every stream.
* The contradiction detector's rolling window is a fixed-shape ring buffer
  [S, window]: an append is a masked write at each stream's ``buf_pos``,
  and the cursor advances only on an append. Mean and deviation are
  order-invariant, so the ring stands for the reference's FIFO.
* Time is an explicit ``dt`` per tick, so replays are deterministic.

The carry's float type is the anomalies' type promoted with float32, as
``init_carry(dtype=result_type(anomalies, float32))`` sets it in
``fav_tpu``: float64 anomalies replay in float64. It is a sequence of torch
ops on whatever device the inputs are on; ``fav_tpu`` runs it as an XLA
scan, not a Pallas kernel, so no hand-written kernel stands behind it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fav_tpu_torch.config import STATUS_OK, STATUS_UNSET, TrustParams

__all__ = ["TrustCarry", "TrustOutputs", "init_carry", "trust_step", "simulate_sequence", "simulate_batch"]


class TrustCarry(NamedTuple):
    """Trust state of S streams; every field has the leading stream axis."""

    reliability: torch.Tensor
    anomaly_integral: torch.Tensor
    status: torch.Tensor  # int32, STATUS_UNSET before the first observation
    trust_velocity: torch.Tensor
    prev_reliability: torch.Tensor
    recovery_debt: torch.Tensor
    recovery_coeff: torch.Tensor
    contradiction: torch.Tensor  # bool
    contradiction_count: torch.Tensor  # int32
    tick_count: torch.Tensor  # int32
    buf_status: torch.Tensor  # int32 [S, window]
    buf_score: torch.Tensor  # float [S, window]
    buf_count: torch.Tensor  # int32, filled entries
    buf_pos: torch.Tensor  # int32, ring write cursor


class TrustOutputs(NamedTuple):
    """Observable state after each tick: [S] per tick, [S, T] from a replay."""

    reliability: torch.Tensor
    policy: torch.Tensor  # int32 policy code
    anomaly_integral: torch.Tensor
    trust_velocity: torch.Tensor
    recovery_debt: torch.Tensor
    recovery_coeff: torch.Tensor
    contradiction: torch.Tensor
    contradiction_count: torch.Tensor
    status: torch.Tensor
    tick_count: torch.Tensor


def init_carry(params: TrustParams | None = None, streams: int = 1, dtype=torch.float64,
               device=None) -> TrustCarry:
    p = params or TrustParams()
    s, w = int(streams), p.contra_window

    def full(value, dt=dtype, shape=(s,)):
        return torch.full(shape, value, dtype=dt, device=device)

    return TrustCarry(
        reliability=full(1.0),
        anomaly_integral=full(0.0),
        status=full(STATUS_UNSET, torch.int32),
        trust_velocity=full(0.0),
        prev_reliability=full(1.0),
        recovery_debt=full(0.0),
        recovery_coeff=full(p.recovery_rate),
        contradiction=full(False, torch.bool),
        contradiction_count=full(0, torch.int32),
        tick_count=full(0, torch.int32),
        buf_status=full(STATUS_UNSET, torch.int32, (s, w)),
        buf_score=full(0.0, dtype, (s, w)),
        buf_count=full(0, torch.int32),
        buf_pos=full(0, torch.int32),
    )


def _gate_policy(p: TrustParams, reliability: torch.Tensor, velocity: torch.Tensor) -> torch.Tensor:
    """Policy code from thresholds: ALLOWED 0, DECLINING 1, DEGRADED 2, BLOCKED 3."""
    declining = (reliability >= p.allowed_threshold) & (velocity < p.declining_velocity)
    allowed = reliability >= p.allowed_threshold
    degraded = reliability >= p.degraded_threshold
    code = torch.where(declining, 1, torch.where(allowed, 0, torch.where(degraded, 2, 3)))
    return code.to(torch.int32)


def trust_step(params: TrustParams, carry: TrustCarry, status: torch.Tensor, anomaly: torch.Tensor,
               has_anomaly: torch.Tensor, dt: torch.Tensor) -> tuple[TrustCarry, TrustOutputs]:
    """One branchless tick of every stream; each input is [S]."""
    p = params
    c = carry
    dtype = c.reliability.dtype
    status = status.to(torch.int32)
    anomaly = anomaly.to(dtype)
    has_anomaly = has_anomaly.to(torch.bool)
    dt = dt.to(dtype)
    zero = torch.zeros_like(c.reliability)

    tick = c.tick_count + 1
    is_first = c.status == STATUS_UNSET
    is_change = ~is_first & (status != c.status)
    dyn = ~is_first & ~is_change

    # the integral is zeroed on an OK -> failure transition
    integral0 = torch.where(is_change & (status != STATUS_OK) & (c.status == STATUS_OK), zero,
                            c.anomaly_integral)

    is_ok = status == STATUS_OK

    # OK branch
    debt_ok = torch.clamp(c.recovery_debt - p.debt_drain * dt, min=0.0)
    coeff_ok = torch.clamp(p.recovery_rate - p.debt_gain * debt_ok, min=p.recovery_min_coeff)
    integral_ok = torch.where(has_anomaly,
                              torch.clamp((integral0 + anomaly * dt) * (1.0 - p.ml_leak * dt), min=0.0),
                              integral0)
    penalty = torch.where(has_anomaly, p.ml_gain * integral_ok * dt, zero)
    rel_ok = c.reliability + coeff_ok * dt - penalty

    # failure branch
    rates = torch.tensor([0.0, p.decay_frozen, p.decay_blank, p.decay_corrupted], dtype=dtype,
                         device=c.reliability.device)
    decay = rates[torch.clamp(status, 0, 3).long()]
    debt_fail = torch.clamp(c.recovery_debt + torch.clamp(p.allowed_threshold - c.reliability, min=0.0) * dt,
                            max=p.debt_max)
    rel_fail = c.reliability - decay * dt

    rel_new = torch.clamp(torch.where(is_ok, rel_ok, rel_fail), 0.0, 1.0)
    debt_new = torch.where(is_ok, debt_ok, debt_fail)
    coeff_new = torch.where(is_ok, coeff_ok, c.recovery_coeff)
    integral_new = torch.where(is_ok, integral_ok, zero)

    raw_velocity = (rel_new - c.prev_reliability) / torch.clamp(dt, min=p.velocity_dt_floor)
    vel_new = p.velocity_alpha * raw_velocity + (1.0 - p.velocity_alpha) * c.trust_velocity

    # merge the dynamics under the dyn mask
    reliability = torch.where(dyn, rel_new, c.reliability)
    anomaly_integral = torch.where(dyn, integral_new, integral0)
    recovery_debt = torch.where(dyn, debt_new, c.recovery_debt)
    recovery_coeff = torch.where(dyn, coeff_new, c.recovery_coeff)
    trust_velocity = torch.where(dyn, vel_new, c.trust_velocity)
    prev_reliability = torch.where(dyn, reliability, c.prev_reliability)

    # contradiction detector: a masked write at each stream's cursor
    window = p.contra_window
    idx = torch.arange(window, device=c.buf_pos.device)
    do_append = dyn & has_anomaly
    pos = c.buf_pos
    write = (idx == pos.unsqueeze(1)) & do_append.unsqueeze(1)
    buf_status = torch.where(write, status.unsqueeze(1), c.buf_status)
    buf_score = torch.where(write, anomaly.unsqueeze(1), c.buf_score)
    buf_count = torch.clamp(c.buf_count + do_append.to(torch.int32), max=window)
    buf_pos = torch.where(do_append, (pos + 1) % window, pos)

    valid = idx < buf_count.unsqueeze(1)
    same = valid & (buf_status == status.unsqueeze(1))
    n_same = same.sum(-1)
    n_safe = torch.clamp(n_same, min=1)
    mean = torch.where(same, buf_score, torch.zeros_like(buf_score)).sum(-1) / n_safe
    dev2 = (buf_score - mean.unsqueeze(1)) ** 2
    var = torch.where(same, dev2, torch.zeros_like(dev2)).sum(-1) / torch.clamp(n_safe - 1, min=1)
    std = torch.clamp(torch.sqrt(var), min=p.contra_std_floor)
    z = (anomaly - mean) / std

    eligible = (buf_count >= p.contra_min_total) & (n_same >= p.contra_min_status)
    hit = do_append & eligible & (status == STATUS_OK) & (z > p.contra_z)
    contradiction = torch.where(dyn, hit, c.contradiction)
    contradiction_count = c.contradiction_count + (hit & ~c.contradiction).to(torch.int32)

    policy = _gate_policy(p, reliability, trust_velocity)

    new_carry = TrustCarry(
        reliability=reliability,
        anomaly_integral=anomaly_integral,
        status=status,
        trust_velocity=trust_velocity,
        prev_reliability=prev_reliability,
        recovery_debt=recovery_debt,
        recovery_coeff=recovery_coeff,
        contradiction=contradiction,
        contradiction_count=contradiction_count,
        tick_count=tick,
        buf_status=buf_status,
        buf_score=buf_score,
        buf_count=buf_count,
        buf_pos=buf_pos,
    )
    outputs = TrustOutputs(
        reliability=reliability,
        policy=policy,
        anomaly_integral=anomaly_integral,
        trust_velocity=trust_velocity,
        recovery_debt=recovery_debt,
        recovery_coeff=recovery_coeff,
        contradiction=contradiction,
        contradiction_count=contradiction_count,
        status=status,
        tick_count=tick,
    )
    return new_carry, outputs


def _replay(params: TrustParams, carry: TrustCarry, statuses: torch.Tensor, anomalies: torch.Tensor,
            has_anomaly: torch.Tensor, dts: torch.Tensor) -> tuple[TrustCarry, TrustOutputs]:
    """Tick by tick over the time axis of [S, T] inputs; outputs [S, T]."""
    steps = []
    for t in range(statuses.shape[1]):
        carry, out = trust_step(params, carry, statuses[:, t], anomalies[:, t], has_anomaly[:, t], dts[:, t])
        steps.append(out)
    return carry, TrustOutputs(*(torch.stack(f, dim=1) for f in zip(*steps)))


def _carry_dtype(anomalies: torch.Tensor) -> torch.dtype:
    return torch.promote_types(anomalies.dtype, torch.float32)


def simulate_sequence(params: TrustParams, statuses: torch.Tensor, anomalies: torch.Tensor,
                      has_anomaly: torch.Tensor, dts: torch.Tensor,
                      carry: TrustCarry | None = None) -> tuple[TrustCarry, TrustOutputs]:
    """Replay one stream's observations [T]; ``carry`` (one stream) resumes
    an earlier replay. Returns the final carry and outputs [T]."""
    if statuses.ndim != 1:
        raise ValueError(f"simulate_sequence takes one stream [T], got {tuple(statuses.shape)}")
    if carry is None:
        carry = init_carry(params, 1, _carry_dtype(anomalies), statuses.device)
    carry, outs = _replay(params, carry, statuses[None], anomalies[None], has_anomaly[None], dts[None])
    return carry, TrustOutputs(*(f[0] for f in outs))


def simulate_batch(params: TrustParams, statuses: torch.Tensor, anomalies: torch.Tensor,
                   has_anomaly: torch.Tensor, dts: torch.Tensor) -> TrustOutputs:
    """Many independent streams [S, T] from a fresh carry each; outputs [S, T]."""
    if statuses.ndim != 2:
        raise ValueError(f"simulate_batch takes streams [S, T], got {tuple(statuses.shape)}")
    carry = init_carry(params, statuses.shape[0], _carry_dtype(anomalies), statuses.device)
    return _replay(params, carry, statuses, anomalies, has_anomaly, dts)[1]
