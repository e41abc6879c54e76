"""Configuration, copied from ``fav_tpu/config.py`` so the port needs
nothing of the JAX package: the vision-status and policy codes and their
names (:26-52), ``TrustParams`` (:55-92), ``AnalyzerParams`` (:94-115),
``AnomalySimParams``, ``VideoParams``, ``ModelParams``,
``model_params_from_metadata``, ``ServerParams``, ``FrameworkConfig``,
``PRESETS`` and ``config_from_env`` (:300-343).
``tests/test_torch_models.py``, ``tests/test_torch_signal.py`` and
``tests/test_torch_host.py`` pin every default equal to ``fav_tpu``'s.

Two differences, both about where things live: ``FrameworkConfig`` has no
``mesh`` section (the device mesh is ROADMAP.md Queue 1 item 10), and a
checkpoint is a path stem under ``fav_tpu_torch/weights/`` (``<stem>.npz``
beside ``<stem>.metadata.json``), so the ``gated`` preset names the port's
copies of ``student_std`` and ``student_nano``."""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any

__all__ = [
    "STATUS_OK",
    "STATUS_FROZEN",
    "STATUS_BLANK",
    "STATUS_CORRUPTED",
    "STATUS_UNSET",
    "STATUS_NAMES",
    "STATUS_CODES",
    "POLICY_ALLOWED",
    "POLICY_DECLINING",
    "POLICY_DEGRADED",
    "POLICY_BLOCKED",
    "POLICY_NAMES",
    "POLICY_CODES",
    "status_code",
    "status_name",
    "policy_name",
    "TrustParams",
    "AnalyzerParams",
    "AnomalySimParams",
    "VideoParams",
    "ModelParams",
    "model_params_from_metadata",
    "ServerParams",
    "FrameworkConfig",
    "PRESETS",
    "DEFAULT_CONFIG",
    "config_from_env",
]

# Vision-status codes; the order encodes failure severity.
STATUS_OK = 0
STATUS_FROZEN = 1
STATUS_BLANK = 2
STATUS_CORRUPTED = 3
STATUS_UNSET = -1
STATUS_NAMES = ("VISION_OK", "VISION_FROZEN", "VISION_BLANK", "VISION_CORRUPTED")
STATUS_CODES = {name: i for i, name in enumerate(STATUS_NAMES)}

POLICY_ALLOWED = 0
POLICY_DECLINING = 1
POLICY_DEGRADED = 2
POLICY_BLOCKED = 3
POLICY_NAMES = ("VISION_ALLOWED", "VISION_DECLINING", "VISION_DEGRADED", "VISION_BLOCKED")
POLICY_CODES = {name: i for i, name in enumerate(POLICY_NAMES)}


def status_code(name: str) -> int:
    return STATUS_CODES[name]


def status_name(code: int) -> str:
    return "UNKNOWN" if code < 0 else STATUS_NAMES[code]


def policy_name(code: int) -> str:
    return POLICY_NAMES[code]


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
class AnomalySimParams:
    """Anomaly-simulator constants."""

    baseline_normal: float = 0.019
    baseline_jitter: float = 0.0005
    noise_gain: float = 0.015
    noise_exponent: float = 1.5
    brightness_gain: float = 0.008
    drift_gain: float = 0.001
    drift_freq: float = 0.05
    frozen_factor: float = 0.5
    blank_base: float = 0.005
    blank_jitter: float = 0.001
    corrupted_factor: float = 3.0
    corrupted_jitter: float = 0.005
    floor: float = 0.001


@dataclass(frozen=True)
class VideoParams:
    """Capture and streaming constants."""

    process_width: int = 320
    process_height: int = 240
    jpeg_quality: int = 40
    default_tick_rate: int = 30
    min_tick_rate: int = 1
    max_tick_rate: int = 60
    playground_dt: float = 1.0 / 30.0
    upload_extensions: tuple = (".mp4", ".avi", ".mov", ".mkv", ".webm")


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


@dataclass(frozen=True)
class ServerParams:
    """The server's settings; every field and default is ``fav_tpu``'s."""

    host: str = "0.0.0.0"
    port: int = 8000
    upload_dir: str = "uploads"
    # live CNN scoring through the micro-batched InferenceService; the scores
    # ride every live state, and use_model_anomaly also feeds
    # max(analyzer, model) anomaly to the trust engine
    model_scoring: bool = True
    use_model_anomaly: bool = False
    inference_max_wait_ms: float = 4.0
    # 'msp' | 'mc_dropout' | 'ensemble' | 'autoencoder'; the port serves msp
    # (serving/inference.py says where the others stand)
    uncertainty: str = "msp"
    # the serving model's weights, a path stem (<stem>.npz and
    # <stem>.metadata.json); "" takes the per-mode default under weights/
    checkpoint: str = ""
    # a monitor's weights stem: its confidence min-gates the predictor's
    monitor: str = ""
    # micro-batch the frame analysis of all live streams (serving/analysis.py)
    batched_analysis: bool = True
    # await the JPEG encode inside each frame's gather (an A/B arm)
    encode_sync: bool = False
    # serving processes sharing one port through SO_REUSEPORT
    workers: int = 1


@dataclass(frozen=True)
class FrameworkConfig:
    trust: TrustParams = field(default_factory=TrustParams)
    analyzer: AnalyzerParams = field(default_factory=AnalyzerParams)
    anomaly_sim: AnomalySimParams = field(default_factory=AnomalySimParams)
    video: VideoParams = field(default_factory=VideoParams)
    model: ModelParams = field(default_factory=ModelParams)
    server: ServerParams = field(default_factory=ServerParams)

    def replace(self, **sections: Any) -> "FrameworkConfig":
        return dataclasses.replace(self, **sections)


def _coerce(raw: str, target_type: type) -> Any:
    if target_type is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    if target_type is tuple:
        return tuple(part.strip() for part in raw.split(","))
    return target_type(raw)


def _weights(name: str) -> str:
    """The stem of the port's committed weights ``<name>.npz`` and
    ``<name>.metadata.json`` (``utils/checkpoint.py:WEIGHTS_DIR``)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "weights", name)


#: One-flag deployment presets (``FAV_PRESET=<name>``), applied before the
#: per-field variables, so any ``FAV_SERVER_*`` variable still wins.
#: ``gated``: ``student_std`` (per-image standardized input) predicts,
#: ``student_nano`` monitors, and the served confidence is the smaller of
#: the two (``fav_tpu/config.py:271-298`` gives the measurements behind
#: the pair).
PRESETS: dict[str, dict[str, dict[str, Any]]] = {
    "gated": {
        "server": {
            "checkpoint": _weights("student_std"),
            "monitor": _weights("student_nano"),
        },
    },
}


def config_from_env(base: FrameworkConfig | None = None) -> FrameworkConfig:
    """A config with ``FAV_<SECTION>_<FIELD>`` environment overrides applied,
    after the preset ``FAV_PRESET=<name>`` names, if any. An empty variable
    counts as unset."""
    cfg = base or FrameworkConfig()
    preset_name = os.environ.get("FAV_PRESET", "")
    if preset_name:
        if preset_name not in PRESETS:
            raise ValueError(f"FAV_PRESET={preset_name!r} unknown (available: {sorted(PRESETS)})")
        for section_name, fields in PRESETS[preset_name].items():
            section = getattr(cfg, section_name)
            cfg = cfg.replace(**{section_name: dataclasses.replace(section, **fields)})
    updates: dict[str, Any] = {}
    for section_field in dataclasses.fields(cfg):
        section = getattr(cfg, section_field.name)
        sec_updates: dict[str, Any] = {}
        for f in dataclasses.fields(section):
            env_key = f"FAV_{section_field.name.upper()}_{f.name.upper()}"
            if os.environ.get(env_key):
                sec_updates[f.name] = _coerce(os.environ[env_key], type(getattr(section, f.name)))
        if sec_updates:
            updates[section_field.name] = dataclasses.replace(section, **sec_updates)
    return cfg.replace(**updates) if updates else cfg


DEFAULT_CONFIG = FrameworkConfig()
