"""Confidence, uncertainty and anomaly scalars (``fav_tpu/models/uncertainty.py``).

The serving half of the JAX module: MSP with a temperature (:40),
predictive entropy (:57), mutual information over a member axis (:63) and
``anomaly_from_confidence`` (:140-154). ``energy_score``, MC dropout and
ensembles are ROADMAP.md Queue 1 item 5.
"""

from __future__ import annotations

import torch

__all__ = ["msp", "max_softmax_probability", "predictive_entropy", "mutual_information",
           "anomaly_from_confidence"]


def msp(logits: torch.Tensor) -> torch.Tensor:
    """Max softmax probability per row, in float32."""
    return torch.softmax(logits.to(torch.float32), dim=-1).amax(dim=-1)


def max_softmax_probability(logits: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """MSP confidence in [1/C, 1] of ``logits / temperature``."""
    return torch.softmax(logits / temperature, dim=-1).amax(dim=-1)


def predictive_entropy(probs: torch.Tensor) -> torch.Tensor:
    """Shannon entropy (nats) of a categorical distribution, 0 log 0 = 0."""
    logp = torch.log(torch.where(probs > 0, probs, torch.ones_like(probs)))
    return -(probs * logp).sum(dim=-1)


def mutual_information(member_probs: torch.Tensor) -> torch.Tensor:
    """BALD mutual information over the member axis 0: H[E p] - E H[p]; 0
    for one member in exact arithmetic."""
    mean_probs = member_probs.mean(dim=0)
    return predictive_entropy(mean_probs) - predictive_entropy(member_probs).mean(dim=0)


def anomaly_from_confidence(
    confidence: torch.Tensor,
    allowed_floor: float = 0.6,
    scale: float = 2.5,
) -> torch.Tensor:
    """Confidence -> the trust engine's anomaly scalar in [0, 1]: near 0 above
    ``allowed_floor``, toward 1 as confidence collapses to chance."""
    deficit = torch.clamp(allowed_floor - confidence, min=0.0) / allowed_floor
    return torch.clamp(deficit * scale, 0.0, 1.0)
