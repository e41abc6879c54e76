"""Frame-quality signal analysis: the plain PyTorch versions, and the
analyzer that routes its heavy statistics to CUDA kernel K7 on the card.

Counterpart of ``fav_tpu/ops/signal.py``. Per frame it computes:

* **blur**: the variance of the 4-neighbour Laplacian (REFLECT_101
  borders) against a sharp baseline of 500;
* **brightness**: the mean gray level's distance from 128;
* **freeze**: mean |frame - prev| below 1.0 for 5 consecutive frames
  (10.0 when there is no previous frame);
* **entropy**: of the 256-bin gray histogram, healthy within 4.0-7.0;

fused 0.35/0.25/0.15/0.25 into an anomaly score in [0, 1], and a vision
status with priority BLANK > FROZEN > CORRUPTED > OK.

Gray levels, the Laplacian and |g - prev| are integers, so the port forms
exact integer sums per frame (Σg, Σlap, Σlap², Σ|g - prev|, the histogram)
and derives the variance, the mean and the diff once from them, in float64,
rounded to float32. K7 (``ops/signal_cuda.py``, ``csrc/frame_stats.cu``)
forms the same sums and the same derivation, so on the card it equals the
plain version here bit for bit. ``fav_tpu`` sums in float32: at 240x320 its
statistics lie within 1e-6 (relative) of these exact ones, its Laplacian
variance up to 6.2e-6 off on smooth 48x64 frames.

Gray conversion stays a torch int32 elementwise op on both routes (K7 takes
gray frames, as the TPU kernel does). The scores and statuses are derived
from the statistics and the histogram by one torch function that both
routes share (``metrics_from_statistics``).

Temporal state (previous gray frame, frozen-run counter) is an explicit
``AnalyzerCarry`` with any leading batch shape: one row per stream.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fav_tpu_torch.config import STATUS_NAMES, AnalyzerParams
from fav_tpu_torch.device import resolve_device

__all__ = [
    "AnalyzerCarry",
    "FrameMetrics",
    "MAX_FRAME_PIXELS",
    "PACKED_FIELDS",
    "SignalAnalyzer",
    "analyze_clip",
    "analyze_frame",
    "bgr_to_gray_cv2",
    "check_frame_size",
    "entropy_from_histogram",
    "frame_statistics_plain",
    "histogram_256",
    "histogram_entropy",
    "init_analyzer_carry",
    "laplacian",
    "laplacian_variance",
    "metrics_from_statistics",
    "pack_metrics",
    "row_to_dict",
]

# n Σlap² must fit int64: |lap| <= 4 * 255, so n <= 2**21 keeps
# n² 1020² below 2**63 (and Σlap within int32's range).
MAX_FRAME_PIXELS = 1 << 21


class AnalyzerCarry(NamedTuple):
    prev_gray: torch.Tensor  # int32 [..., H, W]
    has_prev: torch.Tensor  # bool [...]
    consecutive_frozen: torch.Tensor  # int32 [...]


class FrameMetrics(NamedTuple):
    anomaly_score: torch.Tensor
    status: torch.Tensor  # int32 status code
    blur_score: torch.Tensor
    brightness_score: torch.Tensor
    freeze_score: torch.Tensor
    entropy_score: torch.Tensor
    laplacian_var: torch.Tensor
    mean_brightness: torch.Tensor
    mean_diff: torch.Tensor
    entropy: torch.Tensor
    consecutive_frozen: torch.Tensor


def init_analyzer_carry(height: int, width: int, batch_shape: tuple = (), device=None) -> AnalyzerCarry:
    batch_shape = tuple(batch_shape)
    return AnalyzerCarry(
        prev_gray=torch.zeros(batch_shape + (height, width), dtype=torch.int32, device=device),
        has_prev=torch.zeros(batch_shape, dtype=torch.bool, device=device),
        consecutive_frozen=torch.zeros(batch_shape, dtype=torch.int32, device=device),
    )


def check_frame_size(height: int, width: int) -> None:
    """REFLECT_101 needs two rows and two columns; the exact sums need at
    most ``MAX_FRAME_PIXELS`` pixels."""
    if height < 2 or width < 2:
        raise ValueError(f"frames must be at least 2x2 for REFLECT_101 borders, got {height}x{width}")
    if height * width > MAX_FRAME_PIXELS:
        raise ValueError(f"frames of {height}x{width} exceed {MAX_FRAME_PIXELS} pixels, "
                         f"beyond which the int64 sums of the statistics may overflow")


def bgr_to_gray_cv2(frame_bgr: torch.Tensor) -> torch.Tensor:
    """OpenCV-exact BGR -> gray, int32 [..., H, W]: fixed-point BT.601,
    ``(b 3735 + g 19235 + r 9798 + 2**14) >> 15``. The input is cast to
    int32 first; in uint8 the products would wrap."""
    f = frame_bgr.to(torch.int32)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    return (b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15


def _reflect101(n: int, offset: int, device) -> torch.Tensor:
    """Indices ``i + offset`` mirrored into [0, n) without repeating the edge."""
    i = torch.arange(n, device=device) + offset
    return torch.where(i < 0, -i, torch.where(i >= n, 2 * n - 2 - i, i))


def laplacian(gray: torch.Tensor) -> torch.Tensor:
    """The 4-neighbour Laplacian of int32 gray [..., H, W] under REFLECT_101
    borders (``cv2.Laplacian`` with ksize 1), int32."""
    h, w = gray.shape[-2:]
    check_frame_size(h, w)
    dev = gray.device
    up = gray.index_select(-2, _reflect101(h, -1, dev))
    down = gray.index_select(-2, _reflect101(h, 1, dev))
    left = gray.index_select(-1, _reflect101(w, -1, dev))
    right = gray.index_select(-1, _reflect101(w, 1, dev))
    return up + down + left + right - 4 * gray


def _true_div(num: torch.Tensor, den: int) -> torch.Tensor:
    """float64 ``num / den``, dividing by a 0-dim tensor on ``num``'s device:
    PyTorch on CUDA divides by a host scalar as a product with its rounded
    reciprocal, which K7's division does not."""
    return num.to(torch.float64) / torch.tensor(float(den), dtype=torch.float64, device=num.device)


def _variance_from_sums(n: int, s_lap: torch.Tensor, s_lap2: torch.Tensor) -> torch.Tensor:
    """``(n Σlap² - (Σlap)²) / n²``: exact int64 numerator, one float64 division."""
    return _true_div(n * s_lap2 - s_lap * s_lap, n * n)


def laplacian_variance(gray: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Variance of the Laplacian of int32 gray [..., H, W], from exact sums."""
    h, w = gray.shape[-2:]
    lap = laplacian(gray).to(torch.int64)
    var = _variance_from_sums(h * w, lap.sum((-2, -1)), (lap * lap).sum((-2, -1)))
    return var.to(dtype)


def histogram_256(gray: torch.Tensor) -> torch.Tensor:
    """Exact 256-bin histogram of gray levels, int32 [..., 256]. Values
    outside [0, 255] are not counted (K7 skips them too)."""
    lead = gray.shape[:-2]
    flat = gray.reshape(-1, gray.shape[-2] * gray.shape[-1]).to(torch.int64)
    b = flat.shape[0]
    valid = (flat >= 0) & (flat <= 255)
    frame = torch.arange(b, device=gray.device).unsqueeze(1)
    keys = torch.where(valid, flat + 256 * frame, b * 256)  # the spare bin b*256 takes the rest
    counts = torch.bincount(keys.reshape(-1), minlength=b * 256 + 1)[: b * 256]
    return counts.to(torch.int32).reshape(lead + (256,))


def entropy_from_histogram(hist: torch.Tensor) -> torch.Tensor:
    """Entropy in bits of 256-bin counts, float32, normalised as
    ``h / (h.sum() + 1e-10)``. Both routes compute it here from exact counts."""
    h = hist.to(torch.float32)
    p = h / (h.sum(-1, keepdim=True) + 1e-10)
    plogp = torch.where(p > 0, p * torch.log2(torch.where(p > 0, p, torch.ones_like(p))), torch.zeros_like(p))
    return -plogp.sum(-1)


def histogram_entropy(gray: torch.Tensor) -> torch.Tensor:
    """256-bin histogram entropy of int32 gray [..., H, W], float32 bits."""
    return entropy_from_histogram(histogram_256(gray))


def frame_statistics_plain(gray: torch.Tensor, prev_gray: torch.Tensor,
                           has_prev: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K7. For int32 gray and prev [B, H, W] and
    ``has_prev`` [B]: ``(stats, hist)``, stats float32 [B, 3] =
    (Laplacian variance, mean brightness, mean |g - prev| or 10.0 without a
    previous frame), hist int32 [B, 256]."""
    _, h, w = gray.shape
    n = h * w
    lap = laplacian(gray)
    s_g = gray.sum((1, 2), dtype=torch.int64)
    s_lap = lap.sum((1, 2), dtype=torch.int64)
    s_lap2 = (lap * lap).sum((1, 2), dtype=torch.int64)
    s_diff = (gray - prev_gray).abs().sum((1, 2), dtype=torch.int64)
    lap_var = _variance_from_sums(n, s_lap, s_lap2).to(torch.float32)
    mean = _true_div(s_g, n).to(torch.float32)
    diff = _true_div(s_diff, n).to(torch.float32)
    diff = torch.where(has_prev.to(torch.bool), diff, torch.full_like(diff, 10.0))
    return torch.stack([lap_var, mean, diff], dim=-1), histogram_256(gray)


def _clip01(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)


def metrics_from_statistics(params: AnalyzerParams, carry: AnalyzerCarry, gray: torch.Tensor,
                            stats: torch.Tensor, hist: torch.Tensor) -> tuple[AnalyzerCarry, FrameMetrics]:
    """Scores, status and the next carry from the raw statistics [B, 3] and
    histogram [B, 256] of gray [B, H, W] under ``carry`` (rows [B]); the
    derivation of ``analyze_frame_jax``, in float32."""
    p = params
    lap_var, mean_brightness, mean_diff = stats.unbind(-1)
    entropy = entropy_from_histogram(hist)
    zero = torch.zeros_like(lap_var)

    blur_score = _clip01(1.0 - lap_var / p.blur_baseline)
    brightness_score = _clip01(torch.abs(mean_brightness - 128.0) / 128.0)

    frozen_now = carry.has_prev & (mean_diff < p.freeze_diff_threshold)
    consec = torch.where(frozen_now, carry.consecutive_frozen + 1, torch.zeros_like(carry.consecutive_frozen))
    freeze_score = torch.where(
        consec >= p.freeze_consec_needed,
        torch.ones_like(lap_var),
        torch.where(consec > 0, 0.3 * consec.to(torch.float32) / p.freeze_consec_needed, zero),
    )

    entropy_score = torch.where(
        entropy < p.entropy_healthy_lo,
        _clip01((p.entropy_healthy_lo - entropy) / p.entropy_healthy_lo),
        torch.where(entropy > p.entropy_healthy_hi,
                    _clip01((entropy - p.entropy_healthy_hi) / p.entropy_hi_scale), zero),
    )

    anomaly = _clip01(
        p.w_blur * blur_score
        + p.w_brightness * brightness_score
        + p.w_freeze * freeze_score
        + p.w_entropy * entropy_score
    )

    # status priority BLANK > FROZEN > CORRUPTED > OK
    blank = (mean_brightness < p.blank_brightness_lo) | (mean_brightness > p.blank_brightness_hi)
    frozen = consec >= p.freeze_consec_needed
    corrupted = (entropy < p.corrupt_entropy_lo) | (entropy > p.corrupt_entropy_hi)
    status = torch.where(blank, 2, torch.where(frozen, 1, torch.where(corrupted, 3, 0))).to(torch.int32)

    new_carry = AnalyzerCarry(
        prev_gray=gray,
        has_prev=torch.ones_like(carry.has_prev),
        consecutive_frozen=consec,
    )
    metrics = FrameMetrics(
        anomaly_score=anomaly,
        status=status,
        blur_score=blur_score,
        brightness_score=brightness_score,
        freeze_score=freeze_score,
        entropy_score=entropy_score,
        laplacian_var=lap_var,
        mean_brightness=mean_brightness,
        mean_diff=mean_diff,
        entropy=entropy,
        consecutive_frozen=consec,
    )
    return new_carry, metrics


def analyze_frame(params: AnalyzerParams, carry: AnalyzerCarry, frame_bgr: torch.Tensor,
                  plain: bool = False) -> tuple[AnalyzerCarry, FrameMetrics]:
    """Analyze one frame, or a batch with one carry row per stream: uint8
    BGR [..., H, W, 3] under a carry of batch shape ``[...]``.

    On a CUDA tensor the statistics and histogram come from K7 (one launch
    for the whole batch), unless ``plain`` asks for the plain versions; on
    a CPU tensor the plain versions run."""
    lead = frame_bgr.shape[:-3]
    h, w = frame_bgr.shape[-3], frame_bgr.shape[-2]
    check_frame_size(h, w)
    if tuple(carry.has_prev.shape) != tuple(lead) or tuple(carry.prev_gray.shape) != tuple(lead) + (h, w):
        raise ValueError(f"carry of batch shape {tuple(carry.has_prev.shape)} and frames "
                         f"{tuple(carry.prev_gray.shape[-2:])} does not fit frames {tuple(frame_bgr.shape)}")
    gray = bgr_to_gray_cv2(frame_bgr).reshape(-1, h, w)
    flat = AnalyzerCarry(carry.prev_gray.reshape(-1, h, w), carry.has_prev.reshape(-1),
                         carry.consecutive_frozen.reshape(-1))
    if plain or gray.device.type == "cpu":
        stats, hist = frame_statistics_plain(gray, flat.prev_gray, flat.has_prev)
    else:
        from fav_tpu_torch.ops.signal_cuda import frame_statistics

        stats, hist = frame_statistics(gray, flat.prev_gray, flat.has_prev)
    new, m = metrics_from_statistics(params, flat, gray, stats, hist)
    new = AnalyzerCarry(new.prev_gray.reshape(lead + (h, w)), new.has_prev.reshape(lead),
                        new.consecutive_frozen.reshape(lead))
    return new, FrameMetrics(*(f.reshape(lead) for f in m))


def analyze_clip(params: AnalyzerParams, frames_bgr: torch.Tensor,
                 carry: AnalyzerCarry | None = None) -> tuple[AnalyzerCarry, FrameMetrics]:
    """Analyze a time-major clip uint8 [T, ..., H, W, 3], threading the
    carry through the frames in order; each metric is stacked to [T, ...]."""
    if carry is None:
        carry = init_analyzer_carry(frames_bgr.shape[-3], frames_bgr.shape[-2], frames_bgr.shape[1:-3],
                                    device=frames_bgr.device)
    steps = []
    for frame in frames_bgr:
        carry, m = analyze_frame(params, carry, frame)
        steps.append(m)
    return carry, FrameMetrics(*(torch.stack(f) for f in zip(*steps)))


# The packed row of one frame: one float32 per field, in this order.
PACKED_FIELDS = ("anomaly_score", "status", "blur_score", "brightness_score", "freeze_score",
                 "entropy_score", "laplacian_var", "mean_brightness", "mean_diff", "entropy")


def pack_metrics(m: FrameMetrics) -> torch.Tensor:
    """Every reported field of a batch as one float32 [..., 10] tensor, so
    the host reads a batch with one device-to-host copy."""
    return torch.stack([getattr(m, f).to(torch.float32) for f in PACKED_FIELDS], dim=-1)


def row_to_dict(row: np.ndarray) -> dict:
    """One packed row as the analyzer's dict, with the reference's
    rounding per field."""
    return {
        "anomaly_score": round(float(row[0]), 6),
        "vision_status": STATUS_NAMES[int(row[1])],
        "metrics": {
            "blur": round(float(row[2]), 4),
            "brightness": round(float(row[3]), 4),
            "freeze": round(float(row[4]), 4),
            "entropy": round(float(row[5]), 4),
            "raw": {
                "laplacian_var": round(float(row[6]), 2),
                "mean_brightness": round(float(row[7]), 1),
                "frame_diff": round(float(row[8]), 2),
                "entropy": round(float(row[9]), 3),
            },
        },
    }


class SignalAnalyzer:
    """Stateful facade of one stream: ``analyze_frame(bgr ndarray) -> dict``.

    It keeps the temporal carry on ``device`` (the card unless ``"cpu"`` is
    asked for), sized for ``height`` x ``width`` frames and made anew when a
    frame of another size arrives, and reads each frame's fields with one
    copy to the host."""

    def __init__(self, params: AnalyzerParams | None = None, height: int = 240, width: int = 320,
                 device: str | torch.device | None = None):
        self.params = params or AnalyzerParams()
        self.device = resolve_device(device)
        self._shape = (height, width)
        self.reset()

    def reset(self) -> None:
        self._carry = init_analyzer_carry(*self._shape, device=self.device)

    def analyze_frame(self, frame: np.ndarray) -> dict:
        h, w = frame.shape[0], frame.shape[1]
        if tuple(self._carry.prev_gray.shape) != (h, w):
            self._carry = init_analyzer_carry(h, w, device=self.device)
        x = torch.from_numpy(np.ascontiguousarray(frame)).to(self.device)
        self._carry, m = analyze_frame(self.params, self._carry, x)
        return row_to_dict(pack_metrics(m).cpu().numpy())
