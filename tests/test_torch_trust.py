"""The port's trust scan (``fav_tpu_torch.core.trust_scan``) and policy
replay (``core/policy_replay.py``) against ``fav_tpu.core.trust_jax`` and
``fav_tpu.core.policy_replay`` on the same numpy streams, on the CPU.

Tolerance classes:

* float64 streams: every float output within 1e-12 of ``fav_tpu``'s
  (the same float64 operations; only the window sums may be ordered
  differently); policy codes, statuses, tick and contradiction counts and
  flags exact; the golden scenario of ``tests/test_trust_jax.py:81`` (from
  ``docs/parity.md:37``) to its stated digits;
* float32 streams: the carry follows the anomalies' type, as in
  ``fav_tpu``; floats within 1e-6, codes exact;
* policy summaries: shares, times to BLOCKED, contradiction counts and
  ``allowed_wrong_share`` exact; reliabilities within 1e-12;
* ``anomaly_from_confidence_np``: exact (the same float32 numpy).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fav_tpu import config as jcfg
from fav_tpu.core import policy_replay as jpr
from fav_tpu.core import trust_jax as jt
from fav_tpu_torch import config as tcfg
from fav_tpu_torch.core import policy_replay as tpr
from fav_tpu_torch.core import trust_scan as tt

PT, PJ = tcfg.TrustParams(), jcfg.TrustParams()
DT = 1.0 / 30.0
F64_ATOL = 1e-12
F32_ATOL = 1e-6
EXACT_OUTPUTS = ("policy", "contradiction", "contradiction_count", "status", "tick_count")
FLOAT_OUTPUTS = ("reliability", "anomaly_integral", "trust_velocity", "recovery_debt", "recovery_coeff")


def scenario(seed: int, runs: int, dtype=np.float64):
    """Runs of one status each (1-40 ticks, so dynamics ticks occur),
    anomalies in [0, 0.08) on 90% of ticks, dt in [0.01, 0.1)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 41, runs)
    statuses = np.repeat(rng.integers(0, 4, runs), lengths).astype(np.int32)
    t = statuses.size
    has = rng.random(t) < 0.9
    anomalies = np.where(has, rng.random(t) * 0.08, 0.0).astype(dtype)
    dts = rng.uniform(0.01, 0.1, t).astype(dtype)
    return statuses, anomalies, has, dts


def _assert_outputs(got: tt.TrustOutputs, want: jt.TrustOutputs, atol: float) -> None:
    for f in EXACT_OUTPUTS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    for f in FLOAT_OUTPUTS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=0, atol=atol,
                                   err_msg=f)


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sequence_matches_fav_tpu(seed):
    arrays = scenario(seed, 20)
    _, got = tt.simulate_sequence(PT, *_torch(*arrays))
    _, want = jt.simulate_sequence(PJ, *_jax(*arrays))
    assert got.reliability.dtype == torch.float64
    _assert_outputs(got, want, F64_ATOL)


def test_batch_matches_fav_tpu():
    """Six streams of 240 ticks, replayed together."""
    streams = [scenario(10 + s, 40) for s in range(6)]
    arrays = [np.stack([s[i][:240] for s in streams]) for i in range(4)]
    got = tt.simulate_batch(PT, *_torch(*arrays))
    want = jt.simulate_batch(PJ, *_jax(*arrays))
    assert got.policy.shape == (6, 240)
    _assert_outputs(got, want, F64_ATOL)


def test_float32_anomalies_replay_in_float32():
    arrays = scenario(5, 15, dtype=np.float32)
    _, got = tt.simulate_sequence(PT, *_torch(*arrays))
    _, want = jt.simulate_sequence(PJ, *_jax(*arrays))
    assert got.reliability.dtype == torch.float32
    _assert_outputs(got, want, F32_ATOL)


def test_contradictions_fire_as_in_fav_tpu():
    """A long OK run with a steady anomaly and two spikes: the ring buffer
    fills past its window, and the spikes are contradictions."""
    t = 150
    rng = np.random.default_rng(7)
    statuses = np.zeros(t, np.int32)
    anomalies = 0.02 + rng.normal(0.0, 0.001, t)
    anomalies[[70, 120]] = 0.5
    has = np.ones(t, bool)
    has[[30, 31]] = False
    dts = np.full(t, DT)
    _, got = tt.simulate_sequence(PT, *_torch(statuses, anomalies, has, dts))
    _, want = jt.simulate_sequence(PJ, *_jax(statuses, anomalies, has, dts))
    _assert_outputs(got, want, F64_ATOL)
    assert int(got.contradiction_count[-1]) == 2


def test_carry_resume_equals_one_replay():
    arrays = scenario(9, 30)
    j = arrays[0].size // 2
    _, full = tt.simulate_sequence(PT, *_torch(*arrays))
    carry, first = tt.simulate_sequence(PT, *_torch(*(a[:j] for a in arrays)))
    _, second = tt.simulate_sequence(PT, *_torch(*(a[j:] for a in arrays)), carry=carry)
    for f in tt.TrustOutputs._fields:
        assert torch.equal(torch.cat([getattr(first, f), getattr(second, f)]), getattr(full, f)), f


def test_golden_scenario():
    """``tests/test_trust_jax.py:81``'s scenario: FROZEN x50 -> 0.510000,
    BLANK x30 -> 0, CORRUPTED x100 -> 0, OK x200 -> 0.504917 with the
    integral at 0.036049; and equal to ``fav_tpu``'s replay."""
    seq = ([(0, 0.019, True)] + [(1, 0.019, True)] * 50 + [(2, 0.0, False)] * 30
           + [(3, 0.0, False)] * 100 + [(0, 0.019, True)] * 200)
    statuses = np.array([s for s, _, _ in seq], np.int32)
    anomalies = np.array([a for _, a, _ in seq], np.float64)
    has = np.array([h for _, _, h in seq])
    dts = np.full(len(seq), DT)
    _, got = tt.simulate_sequence(PT, *_torch(statuses, anomalies, has, dts))
    rel = got.reliability.numpy()
    assert rel[50] == pytest.approx(0.510000, abs=1e-6)
    assert rel[80] == pytest.approx(0.0, abs=1e-9)
    assert rel[180] == pytest.approx(0.0, abs=1e-9)
    assert rel[380] == pytest.approx(0.504917, abs=1e-6)
    assert got.anomaly_integral.numpy()[380] == pytest.approx(0.036049, abs=1e-6)
    _, want = jt.simulate_sequence(PJ, *_jax(statuses, anomalies, has, dts))
    _assert_outputs(got, want, F64_ATOL)


def test_init_carry_has_a_stream_axis():
    c = tt.init_carry(PT, streams=3)
    assert c.reliability.shape == (3,) and c.buf_status.shape == (3, PT.contra_window)
    assert c.status.dtype == torch.int32 and c.reliability.dtype == torch.float64
    j = jt.init_carry(PJ)
    for f in tt.TrustCarry._fields:
        np.testing.assert_array_equal(getattr(c, f).numpy()[0], np.asarray(getattr(j, f)), err_msg=f)


# ── policy replay ──────────────────────────────────────────────────────────

def _assert_rows(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k, v in w.items():
            if k in ("final_reliability", "min_reliability"):
                assert g[k] == pytest.approx(v, abs=F64_ATOL, rel=0), k
            else:
                assert g[k] == v, k


def test_policy_constants_equal_fav_tpu():
    assert tpr.POLICY_TICKS_DEFAULT == jpr.POLICY_TICKS_DEFAULT == 900


def test_anomaly_mirror_equals_fav_tpu():
    conf = np.linspace(0.0, 1.0, 257, dtype=np.float32)
    np.testing.assert_array_equal(tpr.anomaly_from_confidence_np(conf), jpr.anomaly_from_confidence_np(conf))


def test_replay_policy_matches_fav_tpu():
    rng = np.random.default_rng(3)
    n, t = 5, 200
    statuses = np.repeat(rng.integers(0, 4, (n, t // 10)), 10, axis=1).astype(np.int32)
    statuses[0] = 0  # one stream never fails
    anomalies = rng.random((n, t)) * 0.8
    wrong = rng.random((n, t)) < 0.3
    got = tpr.replay_policy(statuses, anomalies, wrong=wrong, device="cpu")
    want = jpr.replay_policy(statuses, anomalies, wrong=wrong)
    _assert_rows(got, want)
    assert any(r["time_to_blocked_s"] > 0 for r in got) and got[0]["time_to_blocked_s"] == -1.0


@pytest.mark.parametrize("monitored", [False, True])
def test_grid_policy_matches_fav_tpu(monitored):
    """Three cells of 40 samples, tiled to 120 ticks."""
    rng = np.random.default_rng(11)
    rows = {
        "l1_status": rng.choice(4, (3, 40), p=[0.7, 0.0, 0.1, 0.2]).astype(np.int32),
        "l1_anomaly": rng.random((3, 40)).astype(np.float32) * 0.5,
        "conf": rng.random((3, 40)).astype(np.float32),
        "correct": rng.random((3, 40)) < 0.6,
    }
    if monitored:
        rows["mon_conf"] = rng.random((3, 40)).astype(np.float32)
    cells = (("gaussian_noise", 3), ("fog", 3), ("contrast", 3))
    got = tpr.grid_policy(cells, {k: torch.from_numpy(np.asarray(v)) for k, v in rows.items()}, ticks=120,
                          device="cpu")
    want = jpr.grid_policy(cells, rows, ticks=120)
    _assert_rows(got, want)
    with pytest.raises(ValueError):
        tpr.grid_policy(cells[:2], rows, ticks=120, device="cpu")


def test_replay_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpr.replay_policy(np.zeros((1, 3), np.int32), np.zeros((1, 3)))
