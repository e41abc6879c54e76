"""Training: the classifier's objectives (CE, AugMix + Jensen-Shannon with
every AugMix option, SAM, DeepAugment), the autoencoder, deep ensembles,
the device-resident megasteps and the host loops.

Counterpart of ``fav_tpu/models/train.py``: ``create_train_state`` (:48),
``classifier_train_step`` (:70), ``augmix_train_step`` (:86) and its core
(:111), ``deepaugment_train_step`` (:144) and its core (:170),
``sam_augmix_train_step`` (:200) and its core (:222),
``classifier_eval_step`` (:252), ``make_train_megastep`` (:259),
``autoencoder_train_step`` (:351), ``_ensemble_member_step`` (:369),
``make_ensemble_train_step`` (:418), ``make_ensemble_megastep`` (:448),
``train_classifier`` (:489) and ``train_autoencoder`` (:593). What differs
from the JAX package, and why:

* ``TrainState`` holds the model, a ``torch.optim.AdamW`` and a step count,
  and a step updates them in place. AdamW is made with ``optax.adamw``'s
  defaults (betas 0.9 and 0.999, eps 1e-8, weight decay on every leaf):
  optax computes ``p - lr (m̂ / (√v̂ + eps) + wd p)``, torch ``p (1 - lr wd)``
  then the same Adam step, the same algebra with other roundings.
* Randomness comes from one ``torch.Generator`` threaded through the run:
  each step draws its views' augmentations and then its dropout masks from
  it, in that order. The megasteps draw in the same order, so per-step and
  megastep runs from one generator take the same trajectory.
* An ensemble step instead takes an integer seed, and member ``m`` draws
  its views and masks from a generator of its own seeded ``fold_in(seed,
  m)`` (:func:`member_generator`), as ``fav_tpu`` vmaps the member step
  over one key a member (:418-438): a rank that holds member 3 draws as
  member 3 does in the whole ensemble. The run's step ``i`` takes
  ``fold_in(run seed, i)`` (:func:`step_seed`).
* Sharded over a mesh (``parallel/mesh.py``), a rank steps its members of
  the ``ensemble`` axis on its rows of the ``data`` axis: the views and
  dropout masks are drawn for the whole batch and cut to its rows, each
  member's gradients are averaged over the ``data`` group before AdamW
  (SUM then a divide: the shards are equal), and the logged loss and
  accuracy are averaged the same way; the optimizer state stays with the
  member.
* Each step core takes its views, so that a test can feed it ``fav_tpu``'s.
* SAM's two backward passes see the same dropout masks, as JAX reuses its
  dropout key: the generator's state is taken before the first forward and
  restored before the second.
* An ensemble is a list of models, each with its own AdamW, stepped one
  after another: AdamW is elementwise, so this is the algebra of the
  vmapped optimizer over stacked members.
* Each training forward runs inside ``models/cnn.training_norms``, whose
  GroupNorm gradient holds to flax's where torch's fused CPU kernels part
  from it.
* As in ``fav_tpu``, SAM makes its views from the base op pool and
  DeepAugment takes only the ``freq`` option (their cores take no others).

Entry points run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fav_tpu_torch.data.cifar import Dataset, batch_iterator, index_iterator
from fav_tpu_torch.device import resolve_device
from fav_tpu_torch.models.cnn import init_params, training_norms
from fav_tpu_torch.ops.augment import augmix, augmix_apply, augmix_draws, js_consistency, shard_draws
from fav_tpu_torch.ops.deepaugment import deepaugment, load_augmenter
from fav_tpu_torch.ops.random import fold_in
from fav_tpu_torch.parallel.mesh import Mesh, all_gather_rows, all_reduce_mean, data_sharding

__all__ = [
    "TrainState",
    "create_train_state",
    "classifier_train_step",
    "classifier_eval_step",
    "augmix_views",
    "augmix_objective",
    "augmix_step_core",
    "augmix_train_step",
    "sam_step_core",
    "sam_augmix_train_step",
    "deepaugment_views",
    "deepaugment_train_step",
    "autoencoder_train_step",
    "member_generator",
    "step_seed",
    "row_masks",
    "ensemble_member_views",
    "ensemble_member_step_core",
    "ensemble_train_step",
    "make_ensemble_megastep",
    "make_train_megastep",
    "train_classifier",
    "train_autoencoder",
]


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.AdamW
    step: int = 0


def create_train_state(model: nn.Module, learning_rate: float = 1e-3, weight_decay: float = 1e-4) -> TrainState:
    """``model`` with an AdamW of ``optax.adamw``'s defaults over its parameters."""
    opt = torch.optim.AdamW(model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    return TrainState(model, opt, 0)


def _backward(state: TrainState, loss: torch.Tensor) -> None:
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()


def _update(state: TrainState, loss: torch.Tensor, reduce: Callable | None = None) -> None:
    """Backward and one AdamW step; the gradients stay on the parameters
    until the next step clears them. ``reduce`` maps the flat gradient of
    every parameter, in order, to the one to apply (a data shard's mean over
    the ``data`` group)."""
    _backward(state, loss)
    if reduce is not None:
        params = [p for p in state.model.parameters() if p.grad is not None]
        flat = reduce(torch.cat([p.grad.reshape(-1) for p in params]))
        start = 0
        for p in params:
            n = p.grad.numel()
            p.grad.copy_(flat[start:start + n].view_as(p.grad))
            start += n
    state.optimizer.step()
    state.step += 1


def _accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).to(torch.float32).mean()


def _ce_objective(model: nn.Module, images: torch.Tensor, labels: torch.Tensor,
                  generator: torch.Generator | None, masks=None) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """``_ce_loss`` (:55): a train-mode forward, mean CE and accuracy."""
    with training_norms():
        logits = model(images, train=True, generator=generator, masks=masks)
    loss = F.cross_entropy(logits, labels.long())
    return loss, {"loss": loss.detach(), "accuracy": _accuracy(logits.detach(), labels)}


def classifier_train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
                          generator: torch.Generator) -> dict[str, torch.Tensor]:
    """One plain cross-entropy step in train mode, dropout from ``generator``."""
    loss, metrics = _ce_objective(state.model, images, labels, generator)
    _update(state, loss)
    return metrics


@torch.no_grad()
def classifier_eval_step(model: nn.Module, images: torch.Tensor, labels: torch.Tensor) -> dict[str, torch.Tensor]:
    logits = model(images)
    return {"loss": F.cross_entropy(logits, labels.long()), "accuracy": _accuracy(logits, labels),
            "logits": logits}


def augmix_views(generator: torch.Generator, images: torch.Tensor, plain: bool = False, freq: bool = False,
                 occlude: bool = False, bars: bool = False, bf16: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The step's two AugMix views of ``images``, drawn one after the other
    (K9a/K9b on the card unless ``plain``), with the options asked for."""
    kw = dict(freq=freq, occlude=occlude, bars=bars, bf16=bf16, plain=plain)
    return augmix(generator, images, **kw), augmix(generator, images, **kw)


def augmix_objective(model: nn.Module, images: torch.Tensor, labels: torch.Tensor, aug1: torch.Tensor,
                     aug2: torch.Tensor, js_lam: float, generator: torch.Generator | None,
                     masks=None) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One train-mode forward over ``[clean; aug1; aug2]`` (3B images), the
    loss CE on the clean third + ``js_lam`` x JS across the three, and the
    step's metrics."""
    b = images.shape[0]
    with training_norms():
        logits = model(torch.cat([images, aug1, aug2], dim=0), train=True, generator=generator, masks=masks)
    lc, la, lb = logits[:b], logits[b:2 * b], logits[2 * b:]
    ce = F.cross_entropy(lc, labels.long())
    js = js_consistency(lc, la, lb)
    loss = ce + js_lam * js
    return loss, {"loss": loss.detach(), "accuracy": _accuracy(lc.detach(), labels), "ce": ce.detach(),
                  "js": js.detach()}


def augmix_step_core(state: TrainState, images: torch.Tensor, labels: torch.Tensor, aug1: torch.Tensor,
                     aug2: torch.Tensor, js_lam: float, generator: torch.Generator | None) -> dict:
    """The AugMix step given its views (``_augmix_step_core`` :111, and
    ``_deepaugment_step_core`` :170, whose loss is the same):
    objective, backward, AdamW."""
    loss, metrics = augmix_objective(state.model, images, labels, aug1, aug2, js_lam, generator)
    _update(state, loss)
    return metrics


def augmix_train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
                      generator: torch.Generator, js_lam: float = 12.0, plain: bool = False, freq: bool = False,
                      occlude: bool = False, bars: bool = False, bf16: bool = False) -> dict:
    """AugMix step (Hendrycks et al., ICLR 2020): two views from
    ``generator``, then CE on the clean view plus ``js_lam`` x JS across
    (clean, view 1, view 2), dropout from ``generator``."""
    aug1, aug2 = augmix_views(generator, images, plain, freq, occlude, bars, bf16)
    return augmix_step_core(state, images, labels, aug1, aug2, js_lam, generator)


@contextlib.contextmanager
def _same_draws(generator: torch.Generator | None):
    """Restores ``generator``'s state on leaving, so the next draws repeat
    the ones made inside."""
    saved = None if generator is None else generator.get_state()
    try:
        yield
    finally:
        if saved is not None:
            generator.set_state(saved)


def sam_step_core(state: TrainState, images: torch.Tensor, labels: torch.Tensor, aug1: torch.Tensor,
                  aug2: torch.Tensor, js_lam: float, rho: float, generator: torch.Generator | None) -> dict:
    """Sharpness-aware minimisation on the AugMix objective given its views
    (``_sam_step_core`` :222): the gradient g at p, the ascent to
    ``p + rho / max(||g||_2, 1e-12) g`` (the norm over every leaf), the
    gradient there, and AdamW applied with it to the original p. Both
    passes see the same dropout masks; the metrics are the second pass's."""
    model = state.model
    params = list(model.parameters())
    with _same_draws(generator):
        loss, _ = augmix_objective(model, images, labels, aug1, aug2, js_lam, generator)
        _backward(state, loss)
    with torch.no_grad():
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        gnorm = torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in grads))
        scale = rho / torch.clamp(gnorm, min=1e-12)
        saved = [p.detach().clone() for p in params]
        for p, g in zip(params, grads):
            p.add_(scale * g)
    loss, metrics = augmix_objective(model, images, labels, aug1, aug2, js_lam, generator)
    _backward(state, loss)
    with torch.no_grad():
        for p, s in zip(params, saved):
            p.copy_(s)
    state.optimizer.step()
    state.step += 1
    return metrics


def sam_augmix_train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
                          generator: torch.Generator, js_lam: float = 12.0, rho: float = 0.05,
                          plain: bool = False) -> dict:
    """SAM + AugMix step (Foret et al., ICLR 2021): two views of the base op
    pool, made once, then :func:`sam_step_core`."""
    aug1, aug2 = augmix_views(generator, images, plain)
    return sam_step_core(state, images, labels, aug1, aug2, js_lam, rho, generator)


def deepaugment_views(generator: torch.Generator, images: torch.Tensor, augmenter: nn.Module, plain: bool = False,
                      freq: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``_deepaugment_step_core``'s views (:174-176): ``augmix(images)`` and
    ``augmix(deepaugment(images))``, drawn in that order."""
    aug1 = augmix(generator, images, freq=freq, plain=plain)
    aug2 = augmix(generator, deepaugment(generator, images, augmenter), freq=freq, plain=plain)
    return aug1, aug2


def deepaugment_train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
                           generator: torch.Generator, augmenter: nn.Module, js_lam: float = 12.0,
                           freq: bool = False, plain: bool = False) -> dict:
    """AugMix + DeepAugment step (Hendrycks et al., ICCV 2021): the second
    view passes through the perturbed autoencoder ``augmenter`` before its
    AugMix chain; the one [3B] forward and JS objective of AugMix."""
    aug1, aug2 = deepaugment_views(generator, images, augmenter, plain, freq)
    return augmix_step_core(state, images, labels, aug1, aug2, js_lam, generator)


def autoencoder_train_step(state: TrainState, images: torch.Tensor) -> dict[str, torch.Tensor]:
    """One MSE step of the autoencoder against its float32 sigmoid output;
    it trains on normal images only."""
    recon = state.model(images)
    loss = ((recon - images.to(recon.dtype)) ** 2).mean()
    _update(state, loss)
    return {"loss": loss.detach()}


# ── ensembles ──────────────────────────────────────────────────────────────


_SEED_MASK = (1 << 63) - 1  # torch.Generator.manual_seed takes an int64


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step`` (from 0) of an ensemble run seeded ``seed``."""
    return fold_in(seed, step) & _SEED_MASK


def member_generator(seed: int, member: int, device) -> torch.Generator:
    """Member ``member``'s generator in the ensemble step seeded ``seed``."""
    return torch.Generator(device=device).manual_seed(fold_in(seed, member) & _SEED_MASK)


def row_masks(generator: torch.Generator, batch: int, rows: slice):
    """The dropout uniforms of a data shard (``masks`` of the models'
    forwards): for a forward over k stacked segments of the shard's rows
    (``[clean; view ...]``), the draw of the whole batch's k segments, cut
    to this shard's rows of each, so the shard keeps the units the whole
    batch's forward keeps."""
    local = rows.stop - rows.start

    def uniforms(shape) -> torch.Tensor:
        k = shape[0] // local
        full = torch.rand((k * batch, *shape[1:]), generator=generator, device=generator.device, dtype=torch.float32)
        return full.view(k, batch, *shape[1:])[:, rows].reshape(shape)

    return uniforms


def ensemble_member_views(generator: torch.Generator, images: torch.Tensor, augmix_on: bool, augmix_mode: str,
                          plain: bool = False, rows: slice | None = None) -> tuple[torch.Tensor, ...]:
    """A member's own views: none for plain CE, one for ``ce``, two for ``js``.
    With ``rows``, the views of those rows of ``images`` (the whole batch),
    drawn for the whole batch."""
    if not augmix_on:
        return ()
    count = 1 if augmix_mode == "ce" else 2
    if rows is None:
        if count == 1:
            return (augmix(generator, images, plain=plain),)
        return augmix_views(generator, images, plain)
    b, h, w, _ = images.shape
    mine = images[rows]
    return tuple(augmix_apply(mine, shard_draws(augmix_draws(generator, b, image_size=(h, w)), rows), plain=plain)
                 for _ in range(count))


def ensemble_member_step_core(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
                              views: tuple[torch.Tensor, ...], augmix_mode: str, js_lam: float,
                              generator: torch.Generator | None, masks=None, reduce: Callable | None = None) -> dict:
    """``_ensemble_member_step``'s update (:377-413) given the member's views:
    plain CE without views; with one view (``ce``), CE over ``[clean;
    view]`` with both label halves; with two (``js``), the AugMix + JS
    objective. Metrics: loss and accuracy. ``masks`` and ``reduce`` are a
    data shard's dropout uniforms and gradient mean."""
    if not views:
        loss, metrics = _ce_objective(state.model, images, labels, generator, masks)
    elif augmix_mode == "ce":
        loss, metrics = _ce_objective(state.model, torch.cat([images, views[0]]), torch.cat([labels, labels]),
                                      generator, masks)
    else:
        loss, metrics = augmix_objective(state.model, images, labels, views[0], views[1], js_lam, generator, masks)
        metrics = {k: metrics[k] for k in ("loss", "accuracy")}
    _update(state, loss, reduce)
    return metrics


def ensemble_train_step(states: list[TrainState], images: torch.Tensor, labels: torch.Tensor, seed: int,
                        augmix: bool = False, js_lam: float = 12.0, augmix_mode: str = "js", plain: bool = False,
                        mesh: Mesh | None = None) -> dict[str, torch.Tensor]:
    """One step of every member on the same batch (``make_ensemble_train_step``
    :418), member ``m`` drawing its views and dropout masks from
    ``member_generator(seed, m)``. Returns each metric as an [M] tensor.

    With ``mesh``, ``states`` are this rank's members of the ``ensemble``
    axis (its ``len(states)`` members at its place on the axis) and
    ``images`` and ``labels`` the whole batch, of which it trains on its
    rows of the ``data`` axis; the metrics are every member's, averaged over
    the data shards and gathered over the ensemble axis."""
    if augmix_mode not in ("js", "ce"):
        raise ValueError(f"augmix_mode must be 'js' or 'ce', got {augmix_mode!r}")
    first, rows, masks, reduce = 0, None, None, None
    sharded_data = mesh is not None and mesh.size("data") > 1
    if mesh is not None:
        first = mesh.index("ensemble") * len(states)
    if sharded_data:
        rows = data_sharding(mesh, images.shape[0])

        def reduce(flat):
            return all_reduce_mean(flat, mesh, "data")

    out = []
    for i, st in enumerate(states):
        gen = member_generator(seed, first + i, images.device)
        views = ensemble_member_views(gen, images, augmix, augmix_mode, plain, rows)
        if sharded_data:
            masks = row_masks(gen, images.shape[0], rows)
            x, y = images[rows], labels[rows]
        else:
            x, y = images, labels
        out.append(ensemble_member_step_core(st, x, y, views, augmix_mode, js_lam, gen, masks, reduce))
    metrics = {k: torch.stack([m[k] for m in out]) for k in out[0]}
    if mesh is not None:
        metrics = {k: all_gather_rows(all_reduce_mean(v, mesh, "data"), mesh, "ensemble") for k, v in metrics.items()}
    return metrics


def _resident_loop(step: Callable, device, per_step: bool = False) -> Callable:
    """A megastep over ``step(state, images, labels, draws)``: the train
    set stays on the device, each call uploads one [K, B] index chunk and
    runs K steps, gathering each batch on the device. Returns
    ``megastep(state, images_all, labels_all, idx_chunk, draws) -> (state,
    metrics)``, each metric stacked over the chunk's steps; ``draws`` is the
    generator every step draws from, or with ``per_step`` a sequence of K,
    one a step."""
    dev = resolve_device(device)

    def megastep(state, images_all: torch.Tensor, labels_all: torch.Tensor, idx_chunk, draws):
        if images_all.device.type != dev.type or labels_all.device.type != dev.type:
            raise ValueError(f"megastep: the train set must lie on {dev}")
        idx = torch.as_tensor(np.asarray(idx_chunk), device=dev).long()  # one upload of [K, B]
        if per_step and len(draws) != idx.shape[0]:
            raise ValueError(f"megastep: {len(draws)} step seeds for {idx.shape[0]} steps")
        steps = [step(state, images_all.index_select(0, i), labels_all.index_select(0, i),
                      draws[k] if per_step else draws) for k, i in enumerate(idx)]
        return state, {k: torch.stack([m[k] for m in steps]) for k in steps[0]}

    return megastep


def make_ensemble_megastep(augmix: bool = False, js_lam: float = 12.0, augmix_mode: str = "js",
                           device: str | torch.device | None = None, mesh: Mesh | None = None) -> Callable:
    """Device-resident K-step ensemble megastep (:448): ``megastep(states,
    images_all, labels_all, idx_chunk, seeds) -> (states, metrics)``, K
    step seeds, each metric [K, M]; the per-step loop's draws. With
    ``mesh``, the train set is replicated (``fav_tpu/models/pretrain.py``
    :69-70) and each step runs sharded as :func:`ensemble_train_step`."""
    return _resident_loop(lambda sts, x, y, s: ensemble_train_step(sts, x, y, s, augmix, js_lam, augmix_mode,
                                                                   mesh=mesh), device, per_step=True)


def _step_fn(augmix: bool, js_lam: float, freq: bool = False, occlude: bool = False, bars: bool = False,
             bf16_aug: bool = False, sam_rho: float = 0.0, augmenter: nn.Module | None = None) -> Callable:
    """The step of ``fav_tpu``'s objective choice (:333-347): DeepAugment
    where an augmenter is given, SAM where ``augmix`` and ``sam_rho > 0``,
    AugMix, or plain CE."""
    if augmenter is not None:
        return lambda st, x, y, g: deepaugment_train_step(st, x, y, g, augmenter, js_lam, freq)
    if augmix and sam_rho > 0:
        return lambda st, x, y, g: sam_augmix_train_step(st, x, y, g, js_lam, sam_rho)
    if augmix:
        return lambda st, x, y, g: augmix_train_step(st, x, y, g, js_lam, False, freq, occlude, bars, bf16_aug)
    return classifier_train_step


def make_train_megastep(*, augmix: bool = False, js_lam: float = 12.0, freq: bool = False, occlude: bool = False,
                        bars: bool = False, bf16_aug: bool = False, sam_rho: float = 0.0, deepaugment: bool = False,
                        augmenter: nn.Module | None = None,
                        device: str | torch.device | None = None) -> Callable:
    """Device-resident training megastep for every single-model objective
    (:259): plain CE, AugMix with its options, SAM + AugMix (``sam_rho >
    0``) and DeepAugment (``deepaugment=True`` with the ``augmenter``). The
    train set stays on the device, each call uploads one [K, B] index chunk
    and runs K steps, gathering each batch on the device. Draws come from
    the generator in the per-step loop's order, so the two take the same
    trajectory.

    Returns ``megastep(state, images_all, labels_all, idx_chunk, generator)
    -> (state, metrics)``, each metric a [K] tensor over the chunk's steps
    (``fav_tpu`` returns the last step's only); ``images_all`` and
    ``labels_all`` lie on ``device`` (the card unless ``"cpu"`` is asked
    for)."""
    if deepaugment and augmenter is None:
        raise ValueError("deepaugment=True requires the augmenter")
    step = _step_fn(augmix, js_lam, freq, occlude, bars, bf16_aug, sam_rho, augmenter if deepaugment else None)
    return _resident_loop(step, device)


def train_classifier(
    model: nn.Module,
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
) -> tuple[nn.Module, dict]:
    """Train ``model`` (any family ``create_model`` builds) from flax's
    initialisation law on ``dataset`` on ``device`` (the card unless
    ``"cpu"`` is asked for); returns the trained model and the last step's
    metrics. One generator seeded ``seed`` draws the initialisation and then
    every step's randomness; batches follow ``index_iterator(seed=seed)``.
    ``augmix=True`` trains the AugMix + JS objective with the options
    ``freq_aug``, ``occlude_aug``, ``bars_aug`` and ``bf16_aug``;
    ``sam_rho > 0`` adds SAM; ``deepaugment=True`` sends the second view
    through the perturbed autoencoder ``weights/autoencoder``. ``megastep=K`` runs the bulk as
    device-resident K-step chunks; the remainder continues the same shuffle
    stream and generator step by step."""
    dev = resolve_device(device)
    step = _step_fn(augmix, js_lam, freq_aug, occlude_aug, bars_aug, bf16_aug, sam_rho,
                    load_augmenter(device=dev) if deepaugment else None)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = init_params(model.to(dev), gen)
    state = create_train_state(model, learning_rate)

    def log(done: int, metrics: dict) -> None:
        print(f"step {done}: loss={float(metrics['loss']):.4f} acc={float(metrics['accuracy']):.4f}")

    metrics: dict = {}
    steps_done = 0
    idx_it = index_iterator(dataset.train_images.shape[0], batch_size, seed=seed)
    if megastep > 0:
        mega = _resident_loop(step, dev)
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


def train_autoencoder(
    model: nn.Module,
    images: np.ndarray,
    num_steps: int = 500,
    batch_size: int = 128,
    learning_rate: float = 1e-3,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> tuple[nn.Module, dict]:
    """Train the autoencoder (:593) from flax's initialisation law (a
    generator seeded ``seed``) on ``images`` by MSE, batches from
    ``batch_iterator(seed=seed)``; returns the model and the last loss."""
    dev = resolve_device(device)
    model = init_params(model.to(dev), torch.Generator(device=dev).manual_seed(seed))
    state = create_train_state(model, learning_rate)
    it = batch_iterator(images, np.zeros(images.shape[0], np.int32), batch_size, seed=seed)
    metrics: dict = {}
    for _ in range(num_steps):
        batch, _ = next(it)
        metrics = autoencoder_train_step(state, torch.from_numpy(batch).to(dev))
    return state.model, {k: float(v) for k, v in metrics.items()}
