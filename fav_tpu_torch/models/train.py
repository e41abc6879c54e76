"""Training the classifier: CE and AugMix + Jensen-Shannon steps, the
device-resident megastep and the host loop.

Counterpart of ``fav_tpu/models/train.py`` for the single-model
objectives: ``create_train_state`` (:48), ``classifier_train_step`` (:70),
``augmix_train_step`` (:86) and its core (:111), ``classifier_eval_step``
(:252), ``make_train_megastep`` (:259) and ``train_classifier`` (:489).
What differs from the JAX package, and why:

* ``TrainState`` holds the model, a ``torch.optim.AdamW`` and a step count,
  and a step updates them in place. AdamW is made with ``optax.adamw``'s
  defaults (betas 0.9 and 0.999, eps 1e-8, weight decay on every leaf):
  optax computes ``p - lr (m̂ / (√v̂ + eps) + wd p)``, torch ``p (1 - lr wd)``
  then the same Adam step, the same algebra with other roundings.
* Randomness comes from one ``torch.Generator`` threaded through the run:
  each AugMix step draws its two views' augmentations and then its dropout
  masks from it, in that order. The megastep draws in the same order, so
  per-step and megastep runs from one generator take the same trajectory.
* The step core takes the two views, so that a test can feed it
  ``fav_tpu``'s.
* SAM, DeepAugment, the ``freq``/``occlude``/``bars``/``bf16`` AugMix
  options, ensembles, the autoencoder and distillation are not ported
  (ROADMAP.md Queue 1 item 9): they raise ``NotImplementedError``.

Entry points run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from fav_tpu_torch.data.cifar import Dataset, index_iterator
from fav_tpu_torch.device import resolve_device
from fav_tpu_torch.models.cnn import FailureAwareCNN, init_params
from fav_tpu_torch.ops.augment import augmix, js_consistency

__all__ = [
    "TrainState",
    "create_train_state",
    "classifier_train_step",
    "classifier_eval_step",
    "augmix_views",
    "augmix_objective",
    "augmix_step_core",
    "augmix_train_step",
    "make_train_megastep",
    "train_classifier",
]


@dataclass
class TrainState:
    model: FailureAwareCNN
    optimizer: torch.optim.AdamW
    step: int = 0


def create_train_state(model: FailureAwareCNN, learning_rate: float = 1e-3,
                       weight_decay: float = 1e-4) -> TrainState:
    """``model`` with an AdamW of ``optax.adamw``'s defaults over its parameters."""
    opt = torch.optim.AdamW(model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    return TrainState(model, opt, 0)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md Queue 1 item 9)")


def _update(state: TrainState, loss: torch.Tensor) -> None:
    """Backward and one AdamW step; the gradients stay on the parameters
    until the next step clears them."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1


def _accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).to(torch.float32).mean()


def classifier_train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
                          generator: torch.Generator) -> dict[str, torch.Tensor]:
    """One plain cross-entropy step in train mode, dropout from ``generator``."""
    logits = state.model(images, train=True, generator=generator)
    loss = F.cross_entropy(logits, labels.long())
    _update(state, loss)
    return {"loss": loss.detach(), "accuracy": _accuracy(logits.detach(), labels)}


@torch.no_grad()
def classifier_eval_step(model: FailureAwareCNN, images: torch.Tensor,
                         labels: torch.Tensor) -> dict[str, torch.Tensor]:
    logits = model(images)
    return {"loss": F.cross_entropy(logits, labels.long()), "accuracy": _accuracy(logits, labels),
            "logits": logits}


def augmix_views(generator: torch.Generator, images: torch.Tensor,
                 plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The step's two AugMix views of ``images``, drawn one after the other
    (K9a/K9b on the card unless ``plain``)."""
    return augmix(generator, images, plain=plain), augmix(generator, images, plain=plain)


def augmix_objective(model: FailureAwareCNN, images: torch.Tensor, labels: torch.Tensor, aug1: torch.Tensor,
                     aug2: torch.Tensor, js_lam: float,
                     generator: torch.Generator | None) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One train-mode forward over ``[clean; aug1; aug2]`` (3B images), the
    loss CE on the clean third + ``js_lam`` x JS across the three, and the
    step's metrics."""
    b = images.shape[0]
    logits = model(torch.cat([images, aug1, aug2], dim=0), train=True, generator=generator)
    lc, la, lb = logits[:b], logits[b:2 * b], logits[2 * b:]
    ce = F.cross_entropy(lc, labels.long())
    js = js_consistency(lc, la, lb)
    loss = ce + js_lam * js
    return loss, {"loss": loss.detach(), "accuracy": _accuracy(lc.detach(), labels), "ce": ce.detach(),
                  "js": js.detach()}


def augmix_step_core(state: TrainState, images: torch.Tensor, labels: torch.Tensor, aug1: torch.Tensor,
                     aug2: torch.Tensor, js_lam: float, generator: torch.Generator | None) -> dict:
    """The AugMix step given its views (``_augmix_step_core`` :111):
    objective, backward, AdamW."""
    loss, metrics = augmix_objective(state.model, images, labels, aug1, aug2, js_lam, generator)
    _update(state, loss)
    return metrics


def augmix_train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
                      generator: torch.Generator, js_lam: float = 12.0, plain: bool = False) -> dict:
    """AugMix step (Hendrycks et al., ICLR 2020): two views from
    ``generator``, then CE on the clean view plus ``js_lam`` x JS across
    (clean, view 1, view 2), dropout from ``generator``."""
    aug1, aug2 = augmix_views(generator, images, plain=plain)
    return augmix_step_core(state, images, labels, aug1, aug2, js_lam, generator)


def _step_fn(augmix: bool, js_lam: float) -> Callable:
    if augmix:
        return lambda st, x, y, g: augmix_train_step(st, x, y, g, js_lam)
    return classifier_train_step


def make_train_megastep(*, augmix: bool = False, js_lam: float = 12.0,
                        device: str | torch.device | None = None) -> Callable:
    """Device-resident training megastep: the train set stays on the device,
    each call uploads one [K, B] index chunk and runs K steps, gathering
    each batch on the device. Draws come from the generator in the per-step
    loop's order, so the two take the same trajectory.

    Returns ``megastep(state, images_all, labels_all, idx_chunk, generator)
    -> (state, metrics)``, each metric a [K] tensor over the chunk's steps
    (``fav_tpu`` returns the last step's only); ``images_all`` and
    ``labels_all`` lie on ``device`` (the card unless ``"cpu"`` is asked
    for)."""
    dev = resolve_device(device)
    step = _step_fn(augmix, js_lam)

    def megastep(state: TrainState, images_all: torch.Tensor, labels_all: torch.Tensor, idx_chunk,
                 generator: torch.Generator) -> tuple[TrainState, dict]:
        if images_all.device.type != dev.type or labels_all.device.type != dev.type:
            raise ValueError(f"megastep: the train set must lie on {dev}")
        idx = torch.as_tensor(np.asarray(idx_chunk), device=dev).long()  # one upload of [K, B]
        steps = [step(state, images_all.index_select(0, i), labels_all.index_select(0, i), generator)
                 for i in idx]
        return state, {k: torch.stack([m[k] for m in steps]) for k in steps[0]}

    return megastep


def train_classifier(
    model: FailureAwareCNN,
    dataset: Dataset,
    num_steps: int = 800,
    batch_size: int = 128,
    learning_rate: float = 1e-3,
    seed: int = 0,
    log_every: int = 0,
    augmix: bool = False,
    js_lam: float = 12.0,
    sam_rho: float = 0.0,
    deepaugment: bool = False,
    freq_aug: bool = False,
    occlude_aug: bool = False,
    bars_aug: bool = False,
    bf16_aug: bool = False,
    megastep: int = 0,
    device: str | torch.device | None = None,
) -> tuple[FailureAwareCNN, dict]:
    """Train ``model`` from flax's initialisation law on ``dataset`` on
    ``device`` (the card unless ``"cpu"`` is asked for); returns the trained
    model and the last step's metrics. One generator seeded ``seed`` draws
    the initialisation and then every step's randomness; batches follow
    ``index_iterator(seed=seed)``. ``augmix=True`` trains the AugMix + JS
    objective. ``megastep=K`` runs the bulk as device-resident K-step
    chunks; the remainder continues the same shuffle stream and generator
    step by step."""
    unported = {"SAM (sam_rho > 0)": sam_rho > 0, "DeepAugment": deepaugment, "the AugMix option freq_aug": freq_aug,
                "the AugMix option occlude_aug": occlude_aug, "the AugMix option bars_aug": bars_aug,
                "the AugMix option bf16_aug": bf16_aug}
    for what, asked in unported.items():
        if asked:
            raise _not_ported(what)
    dev = resolve_device(device)
    step = _step_fn(augmix, js_lam)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = init_params(model.to(dev), gen)
    state = create_train_state(model, learning_rate)

    def log(done: int, metrics: dict) -> None:
        print(f"step {done}: loss={float(metrics['loss']):.4f} acc={float(metrics['accuracy']):.4f}")

    metrics: dict = {}
    steps_done = 0
    idx_it = index_iterator(dataset.train_images.shape[0], batch_size, seed=seed)
    if megastep > 0:
        mega = make_train_megastep(augmix=augmix, js_lam=js_lam, device=dev)
        images_all = torch.from_numpy(dataset.train_images).to(dev)  # resident for the run
        labels_all = torch.from_numpy(dataset.train_labels).to(dev)
        while num_steps - steps_done >= megastep:
            chunk = np.stack([next(idx_it) for _ in range(megastep)])
            state, stacked = mega(state, images_all, labels_all, chunk, gen)
            metrics = {k: v[-1] for k, v in stacked.items()}
            steps_done += megastep
            if log_every and (steps_done % log_every == 0 or megastep >= log_every):
                log(steps_done, metrics)
    for i in range(steps_done, num_steps):
        idx = next(idx_it)
        images = torch.from_numpy(dataset.train_images[idx]).to(dev)
        labels = torch.from_numpy(dataset.train_labels[idx]).to(dev)
        metrics = step(state, images, labels, gen)
        if log_every and (i + 1) % log_every == 0:
            log(i + 1, metrics)
    return state.model, {k: float(v) for k, v in metrics.items()}
