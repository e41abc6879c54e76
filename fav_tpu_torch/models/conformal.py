"""Conformal prediction sets at serving time (``fav_tpu/models/conformal.py``).

What the server reads of the JAX module: the deterministic APS (or LAC)
membership of each class against a checkpoint's calibrated threshold
``conformal_qhat`` (``prediction_sets``, :120) and each row's set size
(``set_sizes``, :153), the per-frame difficulty signal. The calibration
half (scores with randomisation, ``conformal_quantile``, coverage) is
ROADMAP.md Queue 1 item 5.
"""

from __future__ import annotations

import torch

__all__ = ["aps_all_scores", "prediction_sets", "set_sizes"]


def aps_all_scores(probs: torch.Tensor, rank_penalty: float = 0.0, k_reg: int = 1) -> torch.Tensor:
    """APS score of every class [B, C]: the mass of all classes ranked at or
    above it (descending probability, ties by class index as a stable sort
    orders them), plus ``rank_penalty * max(0, rank + 1 - k_reg)``."""
    order = torch.argsort(-probs, dim=-1, stable=True)
    cum = torch.cumsum(torch.gather(probs, -1, order), dim=-1)
    ranks = torch.argsort(order, dim=-1, stable=True)
    scores = torch.gather(cum, -1, ranks)
    if rank_penalty > 0.0:
        scores = scores + rank_penalty * torch.clamp(ranks.to(probs.dtype) + 1.0 - float(k_reg), min=0.0)
    return scores


def prediction_sets(probs: torch.Tensor, qhat: float, score: str = "aps", rank_penalty: float = 0.0,
                    k_reg: int = 1) -> torch.Tensor:
    """Boolean membership [B, C]: class c is in the set iff its score is at
    most ``qhat``. ``"aps"`` sets always hold the class of smallest score
    (the argmax); ``"lac"`` scores 1 - p_c."""
    if score == "lac":
        return (1.0 - probs) <= qhat
    if score != "aps":
        raise ValueError(f"unknown conformal score {score!r}")
    scores = aps_all_scores(probs, rank_penalty, k_reg)
    member = scores <= qhat
    force = torch.zeros_like(member).scatter_(-1, torch.argmin(scores, dim=-1, keepdim=True), True)
    return member | force


def set_sizes(sets_mask: torch.Tensor) -> torch.Tensor:
    """Per-row set cardinality [B], int32."""
    return sets_mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)
