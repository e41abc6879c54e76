"""Configuration, copied from ``fav_tpu/config.py`` so the port needs
nothing of the JAX package: the vision-status and policy codes (:26-41),
``TrustParams`` (:55-92), ``AnalyzerParams`` (:94-115), ``ModelParams`` and
``model_params_from_metadata``. ``tests/test_torch_models.py`` and
``tests/test_torch_signal.py`` pin every default equal to ``fav_tpu``'s."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

__all__ = [
    "STATUS_OK",
    "STATUS_FROZEN",
    "STATUS_BLANK",
    "STATUS_CORRUPTED",
    "STATUS_UNSET",
    "STATUS_NAMES",
    "POLICY_ALLOWED",
    "POLICY_DECLINING",
    "POLICY_DEGRADED",
    "POLICY_BLOCKED",
    "POLICY_NAMES",
    "TrustParams",
    "AnalyzerParams",
    "ModelParams",
    "model_params_from_metadata",
]

# Vision-status codes; the order encodes failure severity.
STATUS_OK = 0
STATUS_FROZEN = 1
STATUS_BLANK = 2
STATUS_CORRUPTED = 3
STATUS_UNSET = -1
STATUS_NAMES = ("VISION_OK", "VISION_FROZEN", "VISION_BLANK", "VISION_CORRUPTED")

POLICY_ALLOWED = 0
POLICY_DECLINING = 1
POLICY_DEGRADED = 2
POLICY_BLOCKED = 3
POLICY_NAMES = ("VISION_ALLOWED", "VISION_DECLINING", "VISION_DEGRADED", "VISION_BLOCKED")


@dataclass(frozen=True)
class TrustParams:
    """Trust-engine constants."""

    # per-second reliability rates: OK recovers, failures decay
    recovery_rate: float = 0.10
    decay_frozen: float = 0.30
    decay_blank: float = 0.60
    decay_corrupted: float = 1.00

    # bounded ML influence: penalty only, active only while VISION_OK
    ml_gain: float = 0.15
    ml_leak: float = 0.5

    # asymmetric recovery debt
    debt_max: float = 10.0
    debt_gain: float = 0.008
    recovery_min_coeff: float = 0.03
    debt_drain: float = 0.10

    # trust velocity EMA
    velocity_alpha: float = 0.12
    velocity_dt_floor: float = 0.001

    # policy gating
    allowed_threshold: float = 0.7
    degraded_threshold: float = 0.3
    declining_velocity: float = -0.15

    # contradiction detector
    contra_window: int = 60
    contra_min_total: int = 30
    contra_min_status: int = 10
    contra_z: float = 3.0
    contra_std_floor: float = 0.001


@dataclass(frozen=True)
class AnalyzerParams:
    """Signal-analyzer constants."""

    w_blur: float = 0.35
    w_brightness: float = 0.25
    w_freeze: float = 0.15
    w_entropy: float = 0.25

    freeze_diff_threshold: float = 1.0
    freeze_consec_needed: int = 5
    blank_brightness_lo: float = 15.0
    blank_brightness_hi: float = 245.0
    corrupt_entropy_lo: float = 2.0
    corrupt_entropy_hi: float = 7.5
    blur_baseline: float = 500.0

    # entropy scoring bands
    entropy_healthy_lo: float = 4.0
    entropy_healthy_hi: float = 7.0
    entropy_hi_scale: float = 1.5


@dataclass(frozen=True)
class ModelParams:
    """CNN classifier / uncertainty configuration."""

    num_classes: int = 10
    image_size: int = 32
    channels: int = 3
    arch: str = "vgg"  # 'vgg' (FailureAwareCNN) | 'resnet' | 'vit'; only vgg is ported
    widths: tuple = (64, 128, 256)
    dense_width: int = 256
    vit_dim: int = 128
    vit_depth: int = 4
    vit_heads: int = 4
    dropout_rate: float = 0.1
    ensemble_size: int = 5
    mc_samples: int = 20
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # per-image standardization at the forward's front door (models/cnn.py)
    standardize_input: bool = False


def model_params_from_metadata(base: ModelParams, meta: dict) -> ModelParams:
    """Rebuild the architecture a checkpoint was trained with: metadata wins
    over config defaults, so weights are never restored into the wrong
    template."""
    overrides: dict[str, Any] = {
        k: meta[k]
        for k in ("arch", "dense_width", "vit_dim", "vit_depth", "vit_heads",
                  "standardize_input")
        if meta.get(k) is not None
    }
    if meta.get("widths"):
        overrides["widths"] = tuple(meta["widths"])
    return dataclasses.replace(base, **overrides) if overrides else base
