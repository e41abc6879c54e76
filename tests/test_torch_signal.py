"""The port's L1 frame analyzer (``fav_tpu_torch.ops.signal`` and the K7
wrapper ``ops/signal_cuda.py``) against ``fav_tpu.ops.signal`` and
``fav_tpu.ops.signal_pallas`` on the same numpy frames.

K7 runs only on the card (``chip_smoke.py`` holds it to its plain version
bit for bit); on the CPU its wrapper takes the plain version, which is what
these tests drive. Tolerance classes:

* exact: gray levels, the histogram, statuses, ``consecutive_frozen``,
  ``prev_gray``; and the port's Laplacian variance against ``fav_tpu``'s
  float64 form within float64 rounding (1e-12 relative), since the port's
  statistics are exact sums divided once;
* against ``fav_tpu``'s float32 paths (``analyze_frame_jax``,
  ``frame_stats_pallas`` and ``analyze_frames_pallas`` in interpret mode),
  which sum in float32: rtol 1e-6 for the mean and the diff; atol 1e-5 for
  entropy and the scores; rtol 1e-5 for the Laplacian variance, the bar
  ``tests/test_pallas.py:47`` holds the Pallas kernel to against the jnp
  path. ``fav_tpu``'s float32 two-pass variance lies up to 6.2e-6 (relative)
  off the exact value on the smooth 48x64 frames here (3.6e-6 and 6.1e-6 on
  the structured and colour frames), and within 1e-6 at 240x320; the port's
  is the exact value rounded once, so the gap is ``fav_tpu``'s.

Entropy is compared as its own field: ``tests/test_pallas.py:83`` reads
``stats[:, 3]`` of a [B, 3] array, which JAX clamps to column 2, so it is
not copied here.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fav_tpu import config as jcfg
from fav_tpu.ops import signal as js
from fav_tpu.ops.signal_pallas import analyze_frames_pallas, frame_stats_pallas
from fav_tpu_torch import config as tcfg
from fav_tpu_torch.ops import signal as ts
from fav_tpu_torch.ops import signal_cuda
from fav_tpu_torch.sim.frames import SCRIPTED_KINDS, scripted_stream

H, W = 48, 64
STAT_RTOL = 1e-6
LAP_VAR_RTOL = 1e-5
SCORE_ATOL = 1e-5
FLOAT_FIELDS = ("mean_brightness", "mean_diff")
SCORE_FIELDS = ("anomaly_score", "blur_score", "brightness_score", "freeze_score", "entropy_score", "entropy")
EXACT_FIELDS = ("status", "consecutive_frozen")


def _gallery(seed: int = 0, h: int = H, w: int = W) -> np.ndarray:
    """Eight BGR frames spanning the analyzer's regimes, uint8 [8, h, w, 3]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = (80 + 60 * np.sin(xx / 7.0) + 50 * np.cos(yy / 9.0) + 30 * ((xx // 8 + yy // 8) % 2))
    smooth = ((np.clip(smooth, 0, 255) // 4) * 4).astype(np.uint8)
    frames = [
        rng.integers(0, 256, (h, w, 3), dtype=np.uint8),  # noise: CORRUPTED
        np.zeros((h, w, 3), np.uint8),  # black: BLANK
        np.full((h, w, 3), 255, np.uint8),  # white: BLANK
        np.full((h, w, 3), 128, np.uint8),  # flat gray: entropy 0, CORRUPTED
        np.stack([smooth, smooth, smooth], -1),  # structured: OK
        (np.stack([smooth, smooth, smooth], -1) * 0.04).astype(np.uint8),  # dark
        rng.integers(0, 12, (h, w, 3), dtype=np.uint8),  # dark noise
        np.stack([smooth, (smooth // 2) + 60, 255 - smooth], -1).astype(np.uint8),  # colour
    ]
    return np.stack(frames)


def _np32(a) -> np.ndarray:
    # conftest turns on jax_enable_x64: cast before comparing
    return np.asarray(a, dtype=np.float32)


def _assert_metrics(got: ts.FrameMetrics, want: js.FrameMetrics) -> None:
    for f in EXACT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), _np32(getattr(want, f)), rtol=STAT_RTOL, atol=0,
                                   err_msg=f)
    np.testing.assert_allclose(got.laplacian_var.numpy(), _np32(want.laplacian_var), rtol=LAP_VAR_RTOL, atol=0)
    for f in SCORE_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), _np32(getattr(want, f)), rtol=0, atol=SCORE_ATOL,
                                   err_msg=f)


def _assert_carry(got: ts.AnalyzerCarry, want: js.AnalyzerCarry) -> None:
    np.testing.assert_array_equal(got.prev_gray.numpy(), np.asarray(want.prev_gray))
    np.testing.assert_array_equal(got.has_prev.numpy(), np.asarray(want.has_prev))
    np.testing.assert_array_equal(got.consecutive_frozen.numpy(), np.asarray(want.consecutive_frozen))


# ── configuration copies ───────────────────────────────────────────────────

@pytest.mark.parametrize("cls", ["AnalyzerParams", "TrustParams"])
def test_params_defaults_equal_fav_tpu(cls):
    assert dataclasses.asdict(getattr(tcfg, cls)()) == dataclasses.asdict(getattr(jcfg, cls)())


@pytest.mark.parametrize("name", ["STATUS_OK", "STATUS_FROZEN", "STATUS_BLANK", "STATUS_CORRUPTED", "STATUS_UNSET",
                                  "STATUS_NAMES", "POLICY_ALLOWED", "POLICY_DECLINING", "POLICY_DEGRADED",
                                  "POLICY_BLOCKED", "POLICY_NAMES"])
def test_codes_equal_fav_tpu(name):
    assert getattr(tcfg, name) == getattr(jcfg, name)


# ── the pieces, exact ──────────────────────────────────────────────────────

def test_gray_is_exact():
    frames = _gallery(1)
    got = ts.bgr_to_gray_cv2(torch.from_numpy(frames))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(js.bgr_to_gray_cv2(jnp.asarray(frames))))


def test_histogram_is_exact():
    gray = ts.bgr_to_gray_cv2(torch.from_numpy(_gallery(2)))
    got = ts.histogram_256(gray)
    assert got.dtype == torch.int32 and got.shape == (8, 256)
    want = np.asarray(js.histogram_256(jnp.asarray(gray.numpy()), dtype=jnp.float64))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert (got.sum(-1) == H * W).all()


def test_laplacian_variance_is_the_exact_one():
    """The port divides exact integer sums once; ``fav_tpu``'s float64 form
    agrees to float64 rounding."""
    gray = ts.bgr_to_gray_cv2(torch.from_numpy(_gallery(3)))
    got = ts.laplacian_variance(gray, dtype=torch.float64).numpy()
    want = np.asarray(js.laplacian_variance(jnp.asarray(gray.numpy()), dtype=jnp.float64))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("shape", [(2, 2), (2, 5), (3, 2), (7, 3)])
def test_reflect101_borders_on_small_frames(shape):
    """The smallest frames, where every pixel is a border pixel."""
    gray = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (3,) + shape).astype(np.int32))
    got = ts.laplacian_variance(gray, dtype=torch.float64).numpy()
    want = np.asarray(js.laplacian_variance(jnp.asarray(gray.numpy()), dtype=jnp.float64))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


def test_entropy_matches_fav_tpu():
    gray = ts.bgr_to_gray_cv2(torch.from_numpy(_gallery(5)))
    got = ts.histogram_entropy(gray).numpy()
    np.testing.assert_allclose(got, _np32(js.histogram_entropy(jnp.asarray(gray.numpy()))), atol=SCORE_ATOL)


# ── K7's wrapper (the plain version here) against the Pallas kernel ────────

def test_frame_stats_matches_pallas_interpret():
    rng = np.random.default_rng(6)
    gray = ts.bgr_to_gray_cv2(torch.from_numpy(_gallery(6)))
    prev = torch.from_numpy(rng.integers(0, 256, gray.shape).astype(np.int32))
    has_prev = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1], dtype=torch.int32)
    got = signal_cuda.frame_stats(gray, prev, has_prev)
    want = frame_stats_pallas(jnp.asarray(gray.numpy()), jnp.asarray(prev.numpy()),
                              jnp.asarray(has_prev.numpy()), interpret=True)
    assert got.shape == (8, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got[:, 0].numpy(), _np32(want)[:, 0], rtol=LAP_VAR_RTOL, atol=0)
    np.testing.assert_allclose(got[:, 1:].numpy(), _np32(want)[:, 1:], rtol=STAT_RTOL, atol=0)
    assert (got[has_prev == 0, 2] == 10.0).all()


def test_frame_statistics_histogram_and_integer_sums():
    """The wrapper's histogram is the exact one, and the mean and diff are
    the integer sums divided once."""
    gray = ts.bgr_to_gray_cv2(torch.from_numpy(_gallery(7)))
    prev = torch.flip(gray, dims=(0,)).contiguous()
    stats, hist = signal_cuda.frame_statistics(gray, prev, torch.ones(8, dtype=torch.bool))
    np.testing.assert_array_equal(hist.numpy(), ts.histogram_256(gray).numpy())
    g = gray.numpy().astype(np.int64)
    np.testing.assert_array_equal(stats[:, 1].numpy(), (g.sum((1, 2)) / (H * W)).astype(np.float32))
    diff = np.abs(g - prev.numpy()).sum((1, 2)) / (H * W)
    np.testing.assert_array_equal(stats[:, 2].numpy(), diff.astype(np.float32))


def test_frame_stats_checks_its_input():
    gray = torch.zeros((2, H, W), dtype=torch.int32)
    ok = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        signal_cuda.frame_stats(gray.to(torch.int64), gray, ok)
    with pytest.raises(ValueError):
        signal_cuda.frame_stats(gray, gray[:1], ok)
    with pytest.raises(ValueError):
        signal_cuda.frame_stats(gray, gray, ok[:1])
    with pytest.raises(ValueError):
        signal_cuda.frame_stats(gray[:, :1], gray[:, :1], ok)
    with pytest.raises(ValueError):
        signal_cuda.frame_stats(gray[:, :, :1].contiguous(), gray[:, :, :1].contiguous(), ok)
    with pytest.raises(ValueError):
        ts.check_frame_size(1449, 1449)  # 2,099,601 pixels > 2**21
    ts.check_frame_size(1024, 2048)


# ── the analyzer against fav_tpu ───────────────────────────────────────────

def test_analyze_frame_matches_jax_over_time():
    """Seven ticks of eight streams, each frame repeated every other tick so
    the freeze counter and the diff sentinel are exercised."""
    params_t, params_j = tcfg.AnalyzerParams(), jcfg.AnalyzerParams()
    carry_t = ts.init_analyzer_carry(H, W, (8,))
    carry_j = js.init_analyzer_carry(H, W, (8,))
    for tick in range(7):
        frames = _gallery(10 + tick // 2)
        carry_t, m_t = ts.analyze_frame(params_t, carry_t, torch.from_numpy(frames))
        carry_j, m_j = js.analyze_frame_jax(params_j, carry_j, jnp.asarray(frames))
        _assert_metrics(m_t, m_j)
        _assert_carry(carry_t, carry_j)


def test_analyze_frames_matches_pallas_interpret_freeze_run():
    """The K7 composite against ``analyze_frames_pallas``: six identical
    ticks build the frozen run to 5."""
    frames = _gallery(20)
    params_t, params_j = tcfg.AnalyzerParams(), jcfg.AnalyzerParams()
    carry_t = ts.init_analyzer_carry(H, W, (8,))
    carry_j = js.init_analyzer_carry(H, W, (8,))
    for _ in range(6):
        carry_t, m_t = signal_cuda.analyze_frames(params_t, carry_t, torch.from_numpy(frames))
        carry_j, m_j = analyze_frames_pallas(params_j, carry_j, jnp.asarray(frames), interpret=True)
        _assert_metrics(m_t, m_j)
        _assert_carry(carry_t, carry_j)
    assert int(m_t.consecutive_frozen[0]) == 5


def test_scripted_streams_at_serving_size_match_jax():
    """The serving size, 240x320: two ticks of one stream of each scripted
    kind against ``analyze_frame_jax``, and the statuses each kind is built
    for."""
    frames = np.stack([scripted_stream(k, 0, 2) for k in SCRIPTED_KINDS], axis=1)  # [2, 4, 240, 320, 3]
    params_t, params_j = tcfg.AnalyzerParams(), jcfg.AnalyzerParams()
    carry_t = ts.init_analyzer_carry(240, 320, (4,))
    carry_j = js.init_analyzer_carry(240, 320, (4,))
    for tick in range(2):
        carry_t, m_t = ts.analyze_frame(params_t, carry_t, torch.from_numpy(frames[tick]))
        carry_j, m_j = js.analyze_frame_jax(params_j, carry_j, jnp.asarray(frames[tick]))
        _assert_metrics(m_t, m_j)
    # ok, frozen (not yet: 1 of 5), blank, corrupted
    assert m_t.status.tolist() == [tcfg.STATUS_OK, tcfg.STATUS_OK, tcfg.STATUS_BLANK, tcfg.STATUS_CORRUPTED]


def test_analyze_clip_matches_jax():
    clip = np.stack([_gallery(30)[:3]] * 3 + [_gallery(31)[:3]] * 3)  # [6, 3, H, W, 3]
    carry_t, m_t = ts.analyze_clip(tcfg.AnalyzerParams(), torch.from_numpy(clip))
    carry_j, m_j = js.analyze_clip(jcfg.AnalyzerParams(), jnp.asarray(clip))
    assert m_t.status.shape == (6, 3)
    _assert_metrics(m_t, m_j)
    _assert_carry(carry_t, carry_j)


def test_unbatched_frame_equals_batch_row():
    frames = torch.from_numpy(_gallery(40))
    p = tcfg.AnalyzerParams()
    _, batch = ts.analyze_frame(p, ts.init_analyzer_carry(H, W, (8,)), frames)
    for i in (0, 4):
        carry, one = ts.analyze_frame(p, ts.init_analyzer_carry(H, W), frames[i])
        assert one.status.shape == () and carry.prev_gray.shape == (H, W)
        for f in ts.FrameMetrics._fields:
            assert torch.equal(getattr(one, f), getattr(batch, f)[i]), f


def test_analyze_frame_rejects_a_carry_that_does_not_fit():
    frames = torch.from_numpy(_gallery(41))
    with pytest.raises(ValueError):
        ts.analyze_frame(tcfg.AnalyzerParams(), ts.init_analyzer_carry(H, W, (4,)), frames)
    with pytest.raises(ValueError):
        ts.analyze_frame(tcfg.AnalyzerParams(), ts.init_analyzer_carry(H, W + 1, (8,)), frames)


def _close(got: float, want: float, digits: int, tol: float) -> bool:
    """Equal after rounding to ``digits``, up to one rounding step where the
    unrounded values lie within ``tol`` of a rounding boundary."""
    return abs(got - want) <= 10.0 ** -digits + tol


def test_signal_analyzer_facade_matches_fav_tpu():
    """The facade's dicts over a frozen run and a change of scene."""
    direct_t = ts.SignalAnalyzer(height=H, width=W, device="cpu")
    direct_j = js.SignalAnalyzer(height=H, width=W)
    frames = [_gallery(50)[4]] * 7 + [_gallery(51)[0], _gallery(51)[6]]
    statuses = []
    for f in frames:
        got, want = direct_t.analyze_frame(f), direct_j.analyze_frame(f)
        assert got["vision_status"] == want["vision_status"]
        statuses.append(got["vision_status"])
        assert _close(got["anomaly_score"], want["anomaly_score"], 6, SCORE_ATOL)
        for k in ("blur", "brightness", "freeze", "entropy"):
            assert _close(got["metrics"][k], want["metrics"][k], 4, SCORE_ATOL), k
        raw_t, raw_j = got["metrics"]["raw"], want["metrics"]["raw"]
        for k, digits in (("laplacian_var", 2), ("mean_brightness", 1), ("frame_diff", 2), ("entropy", 3)):
            assert _close(raw_t[k], raw_j[k], digits, abs(raw_j[k]) * LAP_VAR_RTOL + SCORE_ATOL), k
    assert statuses == ["VISION_OK"] * 5 + ["VISION_FROZEN"] * 2 + ["VISION_CORRUPTED", "VISION_BLANK"]


def test_signal_analyzer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.SignalAnalyzer()
