"""Model configuration, copied from ``fav_tpu/config.py`` (``ModelParams``,
``model_params_from_metadata``) so the port needs nothing of the JAX
package. ``tests/test_torch_models.py`` pins the defaults equal."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

__all__ = ["ModelParams", "model_params_from_metadata"]


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
