"""Confidence and anomaly scalars (``fav_tpu/models/uncertainty.py:140-154``)."""

from __future__ import annotations

import torch

__all__ = ["msp", "anomaly_from_confidence"]


def msp(logits: torch.Tensor) -> torch.Tensor:
    """Max softmax probability per row, in float32."""
    return torch.softmax(logits.to(torch.float32), dim=-1).amax(dim=-1)


def anomaly_from_confidence(
    confidence: torch.Tensor,
    allowed_floor: float = 0.6,
    scale: float = 2.5,
) -> torch.Tensor:
    """Confidence -> the trust engine's anomaly scalar in [0, 1]: near 0 above
    ``allowed_floor``, toward 1 as confidence collapses to chance."""
    deficit = torch.clamp(allowed_floor - confidence, min=0.0) / allowed_floor
    return torch.clamp(deficit * scale, 0.0, 1.0)
