"""Confidence, uncertainty and anomaly scalars (``fav_tpu/models/uncertainty.py``).

MSP with a temperature (:40), the energy score (:45), predictive entropy
(:57), mutual information over a member axis (:63), MC dropout (:72),
deep ensembles (:96), ``_summarize`` (:118), ``init_ensemble`` (:130) and
``anomaly_from_confidence`` (:140-154).

The JAX package vmaps its replicas and members. Here MC dropout folds its
K replicas into the batch: one forward on [K·B] rows, replica-major, with
independent masks from the caller's generator (the ViT draws one
attention mask per replica, as flax broadcasts it over a replica's batch
and heads), which is the law of the vmap over keys and one launch
sequence instead of K. Members of an ensemble have different weights:
they run one after another.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

__all__ = ["msp", "max_softmax_probability", "energy_score", "predictive_entropy", "mutual_information",
           "mc_dropout_logits", "mc_dropout_probs", "mc_dropout_predict", "ensemble_probs", "ensemble_predict",
           "init_ensemble", "summarize_members", "anomaly_from_confidence"]


def msp(logits: torch.Tensor) -> torch.Tensor:
    """Max softmax probability per row, in float32."""
    return torch.softmax(logits.to(torch.float32), dim=-1).amax(dim=-1)


def max_softmax_probability(logits: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """MSP confidence in [1/C, 1] of ``logits / temperature``."""
    return torch.softmax(logits / temperature, dim=-1).amax(dim=-1)


def energy_score(logits: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """Energy failure score (Liu et al. 2020): ``-T logsumexp(logits / T)``
    in float32; higher means less evidence, more failure-prone."""
    return -temperature * torch.logsumexp(logits.to(torch.float32) / temperature, dim=-1)


def predictive_entropy(probs: torch.Tensor) -> torch.Tensor:
    """Shannon entropy (nats) of a categorical distribution, 0 log 0 = 0."""
    logp = torch.log(torch.where(probs > 0, probs, torch.ones_like(probs)))
    return -(probs * logp).sum(dim=-1)


def mutual_information(member_probs: torch.Tensor) -> torch.Tensor:
    """BALD mutual information over the member axis 0: H[E p] - E H[p]; 0
    for one member in exact arithmetic."""
    mean_probs = member_probs.mean(dim=0)
    return predictive_entropy(mean_probs) - predictive_entropy(member_probs).mean(dim=0)


@torch.no_grad()
def mc_dropout_logits(model: nn.Module, images: torch.Tensor, generator: torch.Generator | None,
                      num_samples: int = 20, masks=None, max_rows: int = 0, batch: int = 0) -> torch.Tensor:
    """The logits of ``num_samples`` dropout replicas of ``model`` on
    ``images`` [B, H, W, C]: [K, B, C] from train-mode forwards on the
    replicas folded into the batch, replica-major, their masks drawn from
    ``generator`` (or taken from ``masks``, the models' hook: replayed
    masks, or a data shard's uniforms). ``max_rows`` > 0 folds at most that
    many rows of a batch of ``batch`` images (``B`` when 0; a shard passes
    the whole batch's) a forward (at least one replica), bounding the
    activations' memory; a shard so folds its replicas as the whole batch
    does."""
    b = images.shape[0]
    per = num_samples if max_rows <= 0 else max(1, min(num_samples, max_rows // (batch or b)))
    out = []
    for start in range(0, num_samples, per):
        k = min(per, num_samples - start)
        logits = model(images.repeat(k, 1, 1, 1), train=True, generator=generator, masks=masks, replicas=k)
        out.append(logits.view(k, b, -1))
    return out[0] if len(out) == 1 else torch.cat(out)


def mc_dropout_probs(model: nn.Module, images: torch.Tensor, generator: torch.Generator | None,
                     num_samples: int = 20, temperature: float = 1.0, masks=None) -> torch.Tensor:
    """The tempered softmax [K, B, C] of :func:`mc_dropout_logits`, all K
    replicas in one forward."""
    return torch.softmax(mc_dropout_logits(model, images, generator, num_samples, masks) / temperature, dim=-1)


def mc_dropout_predict(model: nn.Module, images: torch.Tensor, generator: torch.Generator | None,
                       num_samples: int = 20, temperature: float = 1.0, masks=None) -> dict[str, torch.Tensor]:
    """K stochastic forward passes with dropout on (:func:`mc_dropout_probs`),
    summarised by :func:`summarize_members`."""
    return summarize_members(mc_dropout_probs(model, images, generator, num_samples, temperature, masks))


@torch.no_grad()
def ensemble_probs(members, images: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """The tempered softmax of each member's eval forward: [M, B, C]."""
    return torch.stack([torch.softmax(m(images) / temperature, dim=-1) for m in members])


def ensemble_predict(members, images: torch.Tensor, temperature: float = 1.0) -> dict[str, torch.Tensor]:
    """Deep-ensemble forward (:func:`ensemble_probs`), summarised by
    :func:`summarize_members`."""
    return summarize_members(ensemble_probs(members, images, temperature))


def summarize_members(member_probs: torch.Tensor) -> dict[str, torch.Tensor]:
    """Member probabilities [M, B, C] -> their mean ``probs``, the
    ``member_probs`` themselves, ``confidence`` (the mean's max),
    ``prediction`` (its argmax), ``entropy`` of the mean and the BALD
    ``mutual_information`` (``_summarize``, :118)."""
    mean_probs = member_probs.mean(dim=0)
    return {
        "probs": mean_probs,
        "member_probs": member_probs,
        "confidence": mean_probs.amax(dim=-1),
        "prediction": mean_probs.argmax(dim=-1),
        "entropy": predictive_entropy(mean_probs),
        "mutual_information": mutual_information(member_probs),
    }


def init_ensemble(model: nn.Module, generator: torch.Generator, size: int) -> list[nn.Module]:
    """``size`` copies of ``model``, each drawn in turn from ``generator`` by
    flax's initialisation law (``models/cnn.py:init_params``): independent
    members with the template's architecture."""
    from fav_tpu_torch.models.cnn import init_params

    return [init_params(copy.deepcopy(model), generator) for _ in range(size)]


def anomaly_from_confidence(
    confidence: torch.Tensor,
    allowed_floor: float = 0.6,
    scale: float = 2.5,
) -> torch.Tensor:
    """Confidence -> the trust engine's anomaly scalar in [0, 1]: near 0 above
    ``allowed_floor``, toward 1 as confidence collapses to chance."""
    deficit = torch.clamp(allowed_floor - confidence, min=0.0) / allowed_floor
    return torch.clamp(deficit * scale, 0.0, 1.0)
