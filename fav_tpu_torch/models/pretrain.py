"""Train and calibrate a model and save its weights.

    python -m fav_tpu_torch.models.pretrain --augmix --steps 3000 --widths 64,128,256
    python -m fav_tpu_torch.models.pretrain --ensemble 5 --steps 2000
    python -m fav_tpu_torch.models.pretrain --autoencoder --steps 2000
    python -m fav_tpu_torch.models.pretrain --distill-mc 20 --steps 1500
    python -m fav_tpu_torch.models.pretrain --distill-ensemble --augmix --widths 32,64,128 --steps 3000
    torchrun --nproc-per-node 4 -m fav_tpu_torch.models.pretrain --ensemble 4 --shard

Counterpart of ``fav_tpu/models/pretrain.py``, every mode and flag: train the classifier
(any ``--arch``, with CE, AugMix and its op options, SAM or DeepAugment),
an N-member deep ensemble (plain CE, ``--augmix`` JS or ``--augmix-ce``),
the conv autoencoder, an MC-dropout distilled student or a KD student of
the ensemble, on CIFAR-10 (real batches under ``$FAV_CIFAR_DIR``, the
deterministic synthetic set otherwise), on the card (``--device cpu`` for
the host). The temperature is fitted on the first half of the test split
and accuracy, ECE, failure AUROC and the conformal threshold reported on
the second, as ``fav_tpu`` does; the autoencoder reports its
reconstruction-error baseline on 512 held-out images. Weights go to
``<out>.npz`` (one array per flax path; an ensemble's leaves stacked on a
leading member axis) beside ``<out>.metadata.json`` with the JAX
package's metadata keys, the layout ``utils/checkpoint.py:load_weights``
reads back.

``--shard`` with ``--ensemble N`` in a world of more than one rank
(``torchrun``, or a world the caller joined: ``parallel/dist.py``) trains
over the mesh ``auto_mesh_shape(world, N)``: members on the ``ensemble``
axis, the batch on ``data`` (``models/train.py``), the same trajectory as
one rank's run. The members are gathered to rank 0, which alone
calibrates, prints the metadata and writes the weights; every rank returns
the metadata. With one rank it trains unsharded, as ``fav_tpu`` does on one
device.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from fav_tpu_torch.config import ModelParams, model_params_from_metadata
from fav_tpu_torch.data.cifar import index_iterator, load_cifar10
from fav_tpu_torch.device import resolve_device
from fav_tpu_torch.models.calibration import auroc, expected_calibration_error, failure_labels, fit_temperature
from fav_tpu_torch.models.cnn import ConvAutoencoder, create_autoencoder, create_model
from fav_tpu_torch.models.conformal import calibration_metadata
from fav_tpu_torch.models.distill import distill_ensemble, distill_mc_dropout
from fav_tpu_torch.models.train import (create_train_state, ensemble_train_step, make_ensemble_megastep, step_seed,
                                        train_autoencoder, train_classifier)
from fav_tpu_torch.models.uncertainty import init_ensemble
from fav_tpu_torch.parallel.dist import current_world, init_world
from fav_tpu_torch.parallel.mesh import auto_mesh_shape, build_mesh, ensemble_sharding
from fav_tpu_torch.utils.checkpoint import WEIGHTS_DIR, flax_to_torch, load_weights, save_flax_npz, torch_to_flax

__all__ = ["DEFAULT_OUT_DIR", "heldout_split", "main", "mean_logits", "quality_metadata"]

DEFAULT_OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_checkpoints"


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default=None,
                   help="path prefix of <out>.npz and <out>.metadata.json (default: build/torch_checkpoints/<mode>)")
    p.add_argument("--log-every", type=int, default=200)
    p.add_argument("--ensemble", type=int, default=0,
                   help="train an N-member deep ensemble (stacked weights for the server's ensemble mode)")
    p.add_argument("--shard", action="store_true",
                   help="shard ensemble training over the ranks of the world (torchrun): members over the ensemble "
                        "axis, the batch over the data axis")
    p.add_argument("--widths", type=str, default="", help="comma-separated stage widths (default: ModelParams)")
    p.add_argument("--arch", type=str, default="vgg", choices=("vgg", "resnet", "vit"),
                   help="classifier family (models/cnn.py)")
    p.add_argument("--autoencoder", action="store_true",
                   help="train the conv autoencoder on normal frames; its reconstruction-error baseline goes into "
                        "the metadata for the server's autoencoder mode")
    p.add_argument("--distill-mc", type=int, default=0,
                   help="distill a teacher's K-replica MC-dropout predictive into a deterministic student")
    p.add_argument("--teacher", type=str, default=None,
                   help="teacher weights path prefix for --distill-mc (default: weights/classifier) or "
                        "--distill-ensemble (default: weights/ensemble)")
    p.add_argument("--distill-ensemble", action="store_true",
                   help="distill the stacked ensemble into a compact student (--widths sets the student; default: "
                        "half the teacher's widths)")
    p.add_argument("--kd-temperature", type=float, default=2.0, help="Hinton KD temperature for --distill-ensemble")
    p.add_argument("--augmix", action="store_true",
                   help="AugMix chains with the Jensen-Shannon consistency loss")
    p.add_argument("--js-lam", type=float, default=12.0, help="JS consistency weight for --augmix")
    p.add_argument("--augmix-ce", action="store_true",
                   help="ensemble variant: plain CE on [clean; AugMix] views, no consistency term")
    p.add_argument("--sam", type=float, default=0.0, metavar="RHO",
                   help="sharpness-aware minimization radius on top of --augmix (0 = off; try 0.05)")
    p.add_argument("--freqband", action="store_true",
                   help="add the spectral band-gain op to the AugMix pool (implies --augmix)")
    p.add_argument("--occlude", action="store_true",
                   help="add the rectangular occlusion op to the AugMix pool (implies --augmix)")
    p.add_argument("--occlude-bars", action="store_true",
                   help="add the oriented-bar occlusion op to the AugMix pool (implies --augmix)")
    p.add_argument("--bf16-aug", action="store_true",
                   help="run the AugMix chain in bfloat16 (draws, shifts and the mix stay float32)")
    p.add_argument("--standardize", action="store_true", help="per-image input standardization in the forward")
    p.add_argument("--megastep", type=int, default=0, metavar="K",
                   help="train in device-resident K-step chunks (same trajectory as the per-step loop); every "
                        "objective, ensembles and --distill-ensemble")
    p.add_argument("--deepaugment", action="store_true",
                   help="route the second AugMix view through the perturbed-weights autoencoder (DeepAugment; "
                        "implies --augmix; needs weights/autoencoder)")
    p.add_argument("--device", type=str, default=None, help="'cpu' to train on the host; the card by default")
    return p


def _validate(parser: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    """``fav_tpu``'s checks and implications (pretrain.py:441-483), with its texts."""
    if args.deepaugment:
        if args.ensemble:
            parser.error("--deepaugment is single-model only (use --augmix-ce for ensemble augmentation)")
        args.augmix = True
    if args.freqband:
        if args.ensemble:
            parser.error("--freqband is single-model or KD only for now")
        args.augmix = True
    if args.occlude:
        if args.ensemble:
            parser.error("--occlude is single-model or KD only for now")
        args.augmix = True
    if args.occlude_bars:
        if args.ensemble or args.distill_ensemble:
            parser.error("--occlude-bars is single-model only")
        args.augmix = True
    if args.bf16_aug:
        if args.ensemble or args.distill_mc or args.autoencoder or args.sam > 0 or args.deepaugment:
            parser.error("--bf16-aug covers the plain AugMix objective (single-model --augmix or "
                         "--distill-ensemble --augmix) only")
        if not args.augmix:
            parser.error("--bf16-aug needs the AugMix chain (--augmix, or an op flag that implies it)")
    if args.augmix_ce and not args.ensemble:
        parser.error("--augmix-ce requires --ensemble (use --augmix for the single-model JS-consistency objective)")
    if args.megastep and (args.distill_mc or args.autoencoder):
        parser.error("--megastep does not cover --distill-mc/--autoencoder (their per-step loops are not "
                     "index-stream based)")


def _widths(args) -> tuple[int, ...] | None:
    return tuple(int(w) for w in args.widths.split(",")) if args.widths else None


def heldout_split(ds, dev):
    """The held-out split ``(val_x, val_y, test_x, test_y)`` on ``dev``: the
    first half of the test set fits the temperature, the second is
    reported."""
    n_val = ds.test_images.shape[0] // 2

    def t(a):
        return torch.from_numpy(a).to(dev)

    return (t(ds.test_images[:n_val]), t(ds.test_labels[:n_val]), t(ds.test_images[n_val:]),
            t(ds.test_labels[n_val:]))


def quality_metadata(val_logits, val_y, logits, test_y, uncalibrated: bool = False, u=None) -> dict:
    """The calibration keys of ``fav_tpu``'s metadata, in its order, from
    the held-out logits: the temperature fitted on ``val_logits``, the
    conformal threshold on their tempered probabilities (``u``: the APS
    uniforms, ``calibration_metadata``'s default when None), accuracy, ECE
    (and ``ece_uncalibrated``) and failure AUROC on ``logits``."""
    temperature = float(fit_temperature(val_logits, val_y))
    probs = torch.softmax(logits / temperature, dim=-1)
    conf, preds = probs.max(dim=-1)
    correct = (preds == test_y).to(torch.float64)
    fails = failure_labels(preds, test_y)
    out = {
        "accuracy": round(float((logits.argmax(-1) == test_y).to(torch.float32).mean()), 4),
        "temperature": round(temperature, 4),
        # deploy-time conformal threshold, calibrated on the same held-out
        # clean split as the temperature (alpha = 0.1)
        **calibration_metadata(torch.softmax(val_logits / temperature, dim=-1), val_y, u=u),
        "ece": round(float(expected_calibration_error(conf, correct)), 4),
    }
    if uncalibrated:
        out["ece_uncalibrated"] = round(float(expected_calibration_error(
            torch.softmax(logits, -1).amax(-1), correct)), 4)
    out["failure_auroc"] = round(float(auroc(1.0 - conf, fails)), 4) if int(fails.sum()) > 0 else None
    return out


@torch.no_grad()
def mean_logits(models, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode logits; the members' mean for an ensemble (logit-averaged)."""
    if isinstance(models, list):
        return torch.stack([m(x) for m in models]).mean(dim=0)
    return models(x)


def _save(out: str | None, default: str, tree: dict[str, np.ndarray], metrics: dict) -> dict:
    prefix = Path(out) if out else DEFAULT_OUT_DIR / default
    prefix.parent.mkdir(parents=True, exist_ok=True)
    metrics = {**metrics, "format": "npz"}
    save_flax_npz(prefix.with_name(prefix.name + ".npz"), tree)
    prefix.with_name(prefix.name + ".metadata.json").write_text(json.dumps(metrics, indent=2) + "\n")
    print(f"weights -> {prefix}.npz")
    return metrics


def _teacher(path: str | None, default: str, dev):
    prefix = Path(path) if path else WEIGHTS_DIR / default
    return (*load_weights(prefix.name, device=dev, directory=prefix.parent), str(prefix))


def _train_ensemble(model, ds, args, dev, mesh=None) -> list[torch.nn.Module]:
    """N members from independent initialisations (one generator seeded
    ``seed``), each with its own AdamW, stepped on one index stream, step i
    seeded ``step_seed(seed + 1, i)``; ``--megastep`` runs the bulk as
    device-resident chunks. With ``mesh``, every rank draws all N
    initialisations and trains its members of the ensemble axis; returns
    those."""
    members = init_ensemble(model.to(dev), torch.Generator(device=dev).manual_seed(args.seed), args.ensemble)
    if mesh is not None:
        members = members[ensemble_sharding(mesh, args.ensemble)]
    states = [create_train_state(m, args.lr) for m in members]
    aug = dict(augmix=args.augmix or args.augmix_ce, js_lam=args.js_lam,
               augmix_mode="ce" if args.augmix_ce else "js")
    idx_it = index_iterator(ds.train_images.shape[0], args.batch, seed=args.seed)
    talk = mesh is None or dist.get_rank() == 0

    def log(done, metrics):
        if talk:
            print(f"step {done}: member losses {[round(float(v), 4) for v in metrics['loss']]}")

    steps_done = 0
    if args.megastep > 0:
        mega = make_ensemble_megastep(device=dev, mesh=mesh, **aug)
        images_all = torch.from_numpy(ds.train_images).to(dev)  # replicated on every rank
        labels_all = torch.from_numpy(ds.train_labels).to(dev)
        while args.steps - steps_done >= args.megastep:
            chunk = np.stack([next(idx_it) for _ in range(args.megastep)])
            seeds = [step_seed(args.seed + 1, steps_done + k) for k in range(args.megastep)]
            states, m = mega(states, images_all, labels_all, chunk, seeds)
            steps_done += args.megastep
            if args.log_every and (steps_done % args.log_every == 0 or args.megastep >= args.log_every):
                log(steps_done, {k: v[-1] for k, v in m.items()})
    for i in range(steps_done, args.steps):
        idx = next(idx_it)
        x = torch.from_numpy(ds.train_images[idx]).to(dev)
        y = torch.from_numpy(ds.train_labels[idx]).to(dev)
        m = ensemble_train_step(states, x, y, step_seed(args.seed + 1, i), mesh=mesh, **aug)
        if args.log_every and (i + 1) % args.log_every == 0:
            log(i + 1, m)
    return [st.model.eval() for st in states]


def _shard_mesh(args, dev):
    """The mesh of ``--shard``: ``auto_mesh_shape(world, N)`` over the world
    this process is in (joining ``torchrun``'s), or None with one rank."""
    if not (args.shard and args.ensemble):
        return None
    world = current_world()
    if world is None and int(os.environ.get("WORLD_SIZE", "1") or 1) > 1:
        world = init_world(dev)
    if world is None or world.size == 1:
        return None
    mesh = build_mesh(auto_mesh_shape(world.size, args.ensemble))
    if world.rank == 0:
        print(f"sharded ensemble training over mesh {mesh.shape}")
    return mesh


def _gather_members(mesh, trained: list[torch.nn.Module], template: torch.nn.Module, size: int, dev):
    """Every member on rank 0, in order (None on the other ranks): each
    ensemble shard's first data rank sends its members' weights."""
    keep = ensemble_sharding(mesh, size)
    mine = None
    if mesh.index("data") == 0 and mesh.index("model") == 0:
        mine = {keep.start + i: torch_to_flax(m.state_dict()) for i, m in enumerate(trained)}
    parts = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
    dist.gather_object(mine, parts, dst=0)
    if dist.get_rank() != 0:
        return None
    trees = {k: v for part in parts if part for k, v in part.items()}
    members = []
    for k in range(size):
        m = copy.deepcopy(template)
        m.load_state_dict(flax_to_torch(trees[k]), strict=True)
        members.append(m.to(dev).eval())
    return members


def _pretrain_autoencoder(args, ds, dev) -> dict:
    """The conv autoencoder on normal data only, with its
    reconstruction-error baseline on 512 held-out images."""
    widths = _widths(args)
    ae = ConvAutoencoder(widths=widths, latent=widths[-1]) if widths else create_autoencoder()
    ae, train_metrics = train_autoencoder(ae, ds.train_images, num_steps=args.steps, batch_size=args.batch,
                                          learning_rate=args.lr, seed=args.seed, device=dev)
    held_out = torch.from_numpy(ds.test_images[:512]).to(dev)
    with torch.no_grad():
        err = ConvAutoencoder.reconstruction_error(ae.eval()(held_out), held_out)
    metrics = {
        "err_baseline": round(float(err.mean()), 6),
        "err_p95": round(float(torch.quantile(err, 0.95)), 6),
        "final_train_loss": round(train_metrics["loss"], 6),
        "data_source": ds.source,
        "train_steps": args.steps,
        "model": "ConvAutoencoder",
        # serving rebuilds the exact architecture from these
        "ae_widths": list(ae.widths),
        "ae_latent": ae.latent,
    }
    print(json.dumps(metrics, indent=2))
    return _save(args.out, "autoencoder", torch_to_flax(ae.state_dict()), metrics)


def _distill(args, ds, dev) -> dict:
    """An MC-dropout distilled student of the teacher (a copy of it at the start)."""
    teacher, meta, teacher_dir = _teacher(args.teacher, "classifier", dev)
    mp = model_params_from_metadata(ModelParams(), meta)
    student = distill_mc_dropout(teacher, ds.train_images, mc_samples=args.distill_mc, num_steps=args.steps,
                                 batch_size=args.batch, learning_rate=args.lr, seed=args.seed,
                                 log_every=args.log_every, device=dev).eval()
    val_x, val_y, test_x, test_y = heldout_split(ds, dev)
    metrics = {
        **quality_metadata(mean_logits(student, val_x), val_y, mean_logits(student, test_x), test_y),
        "data_source": ds.source,
        "train_steps": args.steps,
        "distilled_from": teacher_dir,
        "distill_mc_samples": args.distill_mc,
        "arch": mp.arch,
        "widths": list(mp.widths),
        "dense_width": mp.dense_width,
    }
    print(json.dumps(metrics, indent=2))
    return _save(args.out, "distilled", torch_to_flax(student.state_dict()), metrics)


def _distill_ensemble(args, ds, dev) -> dict:
    """A compact KD student of the stacked ensemble, ``--widths`` wide
    (default: half the teacher's)."""
    teachers, meta, teacher_dir = _teacher(args.teacher, "ensemble", dev)
    teachers = teachers if isinstance(teachers, list) else [teachers]
    t_mp = model_params_from_metadata(ModelParams(), meta)
    size = len(teachers)
    widths = _widths(args) or tuple(w // 2 for w in t_mp.widths)
    s_mp = ModelParams(arch="vgg", widths=widths, dense_width=widths[-1], standardize_input=args.standardize)
    print(f"distilling {size}-member {tuple(t_mp.widths)} ensemble -> student {widths}")
    student = distill_ensemble(
        create_model(s_mp), teachers, ds.train_images, ds.train_labels, num_steps=args.steps,
        batch_size=args.batch, learning_rate=args.lr, kd_temperature=args.kd_temperature, seed=args.seed,
        log_every=args.log_every, augmix=args.augmix, freq=args.freqband, occlude=args.occlude,
        bf16_aug=args.bf16_aug, megastep=args.megastep, device=dev,
    ).eval()
    val_x, val_y, test_x, test_y = heldout_split(ds, dev)
    metrics = {
        **quality_metadata(mean_logits(student, val_x), val_y, mean_logits(student, test_x), test_y),
        "data_source": ds.source,
        "train_steps": args.steps,
        "distilled_from": teacher_dir,
        "teacher_ensemble_size": size,
        "kd_temperature": args.kd_temperature,
        **({"augmix_distill": True} if args.augmix else {}),
        **({"freqband": True} if args.freqband else {}),
        **({"occlude": True} if args.occlude else {}),
        **({"bf16_aug": True} if args.bf16_aug else {}),
        "ensemble_size": None,
        "arch": s_mp.arch,
        "widths": list(s_mp.widths),
        "dense_width": s_mp.dense_width,
        **({"standardize_input": True} if s_mp.standardize_input else {}),
    }
    print(json.dumps(metrics, indent=2))
    return _save(args.out, "student_compact", torch_to_flax(student.state_dict()), metrics)


def main(argv: list[str] | None = None, dataset=None) -> dict:
    """Run the CLI; returns the metadata written. ``dataset`` stands in for
    ``load_cifar10()``."""
    parser = _parser()
    args = parser.parse_args(argv)
    _validate(parser, args)
    dev = resolve_device(args.device)
    ds = dataset if dataset is not None else load_cifar10()
    print(f"dataset: {ds.source} ({ds.train_images.shape[0]} train / {ds.test_images.shape[0]} test)")
    if args.autoencoder:
        return _pretrain_autoencoder(args, ds, dev)
    if args.distill_mc:
        return _distill(args, ds, dev)
    if args.distill_ensemble:
        return _distill_ensemble(args, ds, dev)

    widths = _widths(args)
    mp = ModelParams(arch=args.arch, standardize_input=args.standardize)
    if widths:
        mp = ModelParams(arch=args.arch, widths=widths, dense_width=widths[-1], standardize_input=args.standardize)
    model = create_model(mp)
    mesh = _shard_mesh(args, dev)
    if args.ensemble:
        trained = _train_ensemble(model, ds, args, dev, mesh)
        if mesh is not None:
            trained = _gather_members(mesh, trained, model, args.ensemble, dev)
            if trained is None:  # rank 0 calibrates and writes
                out = [None]
                dist.broadcast_object_list(out, src=0)
                return out[0]
        stacked = [torch_to_flax(m.state_dict()) for m in trained]
        tree = {k: np.stack([t[k] for t in stacked]) for k in stacked[0]}
    else:
        trained, _ = train_classifier(
            model, ds, num_steps=args.steps, batch_size=args.batch, learning_rate=args.lr, seed=args.seed,
            log_every=args.log_every, augmix=args.augmix, js_lam=args.js_lam, sam_rho=args.sam,
            deepaugment=args.deepaugment, freq_aug=args.freqband, occlude_aug=args.occlude,
            bars_aug=args.occlude_bars, bf16_aug=args.bf16_aug, megastep=args.megastep, device=dev,
        )
        trained = trained.eval()
        tree = torch_to_flax(trained.state_dict())
    val_x, val_y, test_x, test_y = heldout_split(ds, dev)
    metrics = {
        **quality_metadata(mean_logits(trained, val_x), val_y, mean_logits(trained, test_x), test_y, uncalibrated=True),
        "data_source": ds.source,
        "train_steps": args.steps,
        "ensemble_size": args.ensemble or None,
        **({"augmix": True, "js_lam": args.js_lam} if args.augmix else {}),
        **({"augmix_ce": True} if args.augmix_ce else {}),
        **({"sam_rho": args.sam} if args.sam else {}),
        **({"deepaugment": True} if args.deepaugment else {}),
        **({"freqband": True} if args.freqband else {}),
        **({"occlude": True} if args.occlude else {}),
        **({"occlude_bars": True} if args.occlude_bars else {}),
        **({"bf16_aug": True} if args.bf16_aug else {}),
        # serving rebuilds the exact architecture from these
        "arch": mp.arch,
        "widths": list(mp.widths),
        "dense_width": mp.dense_width,
        **({"standardize_input": True} if mp.standardize_input else {}),
        **({"vit_dim": mp.vit_dim, "vit_depth": mp.vit_depth, "vit_heads": mp.vit_heads} if mp.arch == "vit"
           else {}),
    }
    print(json.dumps(metrics, indent=2))
    saved = _save(args.out, "ensemble" if args.ensemble else "classifier", tree, metrics)
    if mesh is not None:
        dist.broadcast_object_list([saved], src=0)
    return saved


if __name__ == "__main__":
    main()
