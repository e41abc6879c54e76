"""Corruption-sweep evaluation CLI: the 15x5 robustness grid on the card.

    python -m fav_tpu_torch.models.evaluate [--checkpoint NAME ...] [--out FILE]

Counterpart of ``fav_tpu/models/evaluate.py``: every (corruption, severity)
cell of the CIFAR-10-C-style grid runs through the classifier and reports
accuracy, confidence, failure-detection AUROC, calibration, the L1
analyzer's columns and the trust engine's anomaly scalar, with the same
flags and the same ``summary`` / ``per_corruption`` / ``grid`` JSON.

``--checkpoint`` takes weight names of ``fav_tpu_torch/weights`` (default
``classifier``) or paths to ``<stem>.npz`` files beside their
``<stem>.metadata.json``, as ``utils/checkpoint.py:load_student`` reads
them; a name with no weights evaluates a random initialisation (or trains
one of the ``--arch`` family with ``--train-steps``). The device is ``FAV_TORCH_DEVICE``, the card (``cuda``)
by default; with no card and no ``cpu`` asked for it raises.

The multi-forward scorers hand the grid stacked member logits [M, B, C]
(``parallel/sweep.py:_reduce_members``: predictions from the mean logits,
plus the BALD and vote rows): ``--ensemble N`` the members of an ensemble
copy (``ensemble`` by default; a copy holding another member count
raises), ``--mc-dropout K`` K dropout replicas of one model, folded into
the batch with the same masks in every cell (one generator seeded 7 per
call, as the JAX CLI's fixed ``PRNGKey(7)`` keys), and ``--tta K`` the
mean logits of the clean view and K - 1 AugMix views (K9a/K9b on the
card), view i drawn from its own fixed seed, the counterpart of
``fold_in(PRNGKey(11), i)``, so the grid stays deterministic.
``--arch`` picks the family of a checkpoint without metadata (a
checkpoint's metadata wins).

In a world of more than one rank (``torchrun --nproc-per-node N -m
fav_tpu_torch.models.evaluate``, or a world the caller joined:
``parallel/dist.py``) whose size divides the image count, the grid shards
its batch over a ``(N, 1, 1)`` mesh (``parallel/sweep.py:sharded_sweep``),
as the JAX CLI does with more than one device; each rank runs on its own
card (``cuda:LOCAL_RANK``), and only rank 0 prints and writes the JSON.
Its draws are the one-rank grid's, so its per-sample rows are too, bit
for bit on the CPU and up to the last bits on cards (cuDNN and cuBLAS
pick their algorithms by the batch's shape). The MC-dropout masks and the
TTA views of a shard are its rows of the whole batch's
(``models/train.py:row_masks``, ``ops/augment.py:shard_draws``), so
those scorers give one rank's grid too.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

DEVICE_ENV = "FAV_TORCH_DEVICE"
DEFAULT_CHECKPOINT = "classifier"
DEFAULT_ENSEMBLE = "ensemble"
MC_DROPOUT_SEED = 7  # the JAX CLI's PRNGKey(7)
TTA_SEED = 11  # the JAX CLI's PRNGKey(11)
# rows of one MC-dropout forward in the grid: 2048 images fold 4 replicas,
# so 20 replicas take five forwards, not one of 40,960 rows
MC_FOLD_ROWS = 8192


def _resolve(ckpt: str) -> tuple[Path, str] | None:
    """(directory, stem) of a checkpoint's weights, or None if there are none
    (``utils/checkpoint.py:resolve_copy``)."""
    from fav_tpu_torch.utils.checkpoint import resolve_copy

    return resolve_copy(ckpt)


def _metadata(ckpt: str) -> dict | None:
    found = _resolve(ckpt)
    if found is None:
        return None
    meta = found[0] / f"{found[1]}.metadata.json"
    return json.loads(meta.read_text()) if meta.is_file() else None


def _model_params_for(ckpt: str, args, parser):
    """ModelParams of a checkpoint: its metadata wins over ``--arch`` and
    ``--widths``, so weights never load into the wrong template."""
    from fav_tpu_torch.config import ModelParams, model_params_from_metadata

    mp = ModelParams(arch=args.arch)
    if args.widths:
        widths = tuple(int(w) for w in args.widths.split(","))
        mp = ModelParams(arch=args.arch, widths=widths, dense_width=widths[-1])
    meta = _metadata(ckpt)
    if meta is not None:
        mp = model_params_from_metadata(mp, meta)
    return mp


def _load_monitor(monitor: str, parser, device):
    """The decoupled monitor ``(model, temperature)``; its weights must
    exist: a random monitor would score noise."""
    from fav_tpu_torch.utils.checkpoint import load_student

    found = _resolve(monitor)
    if found is None:
        parser.error(f"--monitor: no checkpoint at {monitor}")
    model, meta = load_student(found[1], device=device, directory=found[0])
    return model, float(meta.get("temperature", 1.0))


def _evaluate_checkpoint(ckpt, args, ds, images, labels, monitor, parser, device, world=None) -> dict:
    """One checkpoint through the grid; sharded over ``world``'s ranks where
    it has more than one and their number divides the images."""
    import torch

    from fav_tpu_torch.models.cnn import create_model, init_params
    from fav_tpu_torch.models.train import row_masks, train_classifier
    from fav_tpu_torch.models.uncertainty import init_ensemble, mc_dropout_logits
    from fav_tpu_torch.ops.corruptions import CORRUPTION_NAMES
    from fav_tpu_torch.parallel.sweep import GRID_SEED, corruption_sweep, fused_sweep, sharded_sweep
    from fav_tpu_torch.utils.checkpoint import flax_to_torch, load_flax_npz, load_weights

    n = images.shape[0]
    mesh = shard = None
    if world is not None and world.size > 1 and n % world.size == 0:
        from fav_tpu_torch.parallel.mesh import build_mesh, data_sharding

        mesh = build_mesh((world.size, 1, 1))
        shard = data_sharding(mesh, n)
    mp = _model_params_for(ckpt, args, parser)
    temperature = 1.0
    found = _resolve(ckpt)
    if found is not None:
        temperature = float((_metadata(ckpt) or {}).get("temperature", 1.0))
        source = f"checkpoint:{ckpt}"
    member_forward = None
    if args.ensemble:
        if found is not None:
            members, _ = load_weights(found[1], device=device, directory=found[0], members=args.ensemble)
        else:
            members = init_ensemble(create_model(mp).to(device), torch.Generator(device=device).manual_seed(0),
                                    args.ensemble)
            source = "random_init"
        for m in members:
            m.eval()

        def member_forward(x, rows=None):
            return torch.stack([m(x) for m in members])
    else:
        model = create_model(mp).to(device)
        if found is not None:
            model.load_state_dict(flax_to_torch(load_flax_npz(found[0] / f"{found[1]}.npz")), strict=True)
            model.to(device)
        elif args.train_steps > 0:
            model, _ = train_classifier(model, ds, num_steps=args.train_steps, device=device)
            source = f"trained:{args.train_steps}steps"
        else:
            init_params(model, torch.Generator(device=device).manual_seed(0))
            source = "random_init"
        model.eval()
        if args.mc_dropout:
            def member_forward(x, rows=None):
                # the same masks in every cell: each call replays one seed;
                # a shard (``rows`` of the batch) takes its rows of them
                g = torch.Generator(device=x.device).manual_seed(MC_DROPOUT_SEED)
                if rows is None:
                    return mc_dropout_logits(model, x, g, args.mc_dropout, max_rows=MC_FOLD_ROWS)
                return mc_dropout_logits(model, x, g, args.mc_dropout, masks=row_masks(g, n, rows),
                                         max_rows=MC_FOLD_ROWS, batch=n)

    # every forward takes ``rows``: None for a whole batch, or the shard's
    # rows of the grid's batch, whose draws it takes
    if member_forward is not None:
        def forward(x, rows=None):
            return member_forward(x, rows).mean(dim=0)
    else:
        def forward(x, rows=None):
            return model(x)
    if args.tta > 1:
        # the clean view and K - 1 AugMix views, each view's draws fixed
        from fav_tpu_torch.ops.augment import augmix, augmix_apply, augmix_draws, shard_draws
        from fav_tpu_torch.parallel.sweep import _fold_in

        def tta_wrap(base):
            def wrapped(x, rows=None):
                logits = base(x, rows)
                for i in range(args.tta - 1):
                    g = torch.Generator(device=x.device).manual_seed(_fold_in(TTA_SEED, i))
                    if rows is None:
                        view = augmix(g, x)
                    else:
                        view = augmix_apply(x, shard_draws(augmix_draws(g, n, image_size=x.shape[1:3]), rows))
                    logits = logits + base(view, rows)
                return logits / args.tta

            return wrapped

        forward = tta_wrap(forward)
        if member_forward is not None:
            member_forward = tta_wrap(member_forward)
    apply_fn = forward  # the single-output scorer (conformal calibration)
    sweep_forward = member_forward if member_forward is not None else forward
    if args.maha:
        # feature-space scores: class Gaussians fitted on train-set features,
        # each cell also scoring Mahalanobis and relative-Mahalanobis rows
        from fav_tpu_torch.models.mahalanobis import collect_features, fit_feature_gaussians, mahalanobis_scores

        n_fit = min(args.maha_fit_images, ds.train_images.shape[0])
        fit_feats = collect_features(model, ds.train_images[:n_fit])
        fit = fit_feature_gaussians(fit_feats, ds.train_labels[:n_fit], mp.num_classes).to(device)

        def sweep_forward(x, rows=None):
            feats, logits = model.features_and_logits(x)
            return logits, mahalanobis_scores(feats, fit)

    names = tuple(c for c in args.corruptions.split(",") if c) or CORRUPTION_NAMES
    # multi-forward scorers and a monitor bound the chunk by the forwards a
    # cell runs, as the JAX CLI does
    multi = max(args.ensemble, args.mc_dropout, args.tta, 1) + (monitor is not None)
    cells_per_call = 0 if multi <= 1 else max(1, 25 // multi)
    want_probs = args.conformal > 0.0
    want_rows: tuple = ()
    if args.policy:
        want_rows = ("l1_status", "l1_anomaly", "conf", "correct")
        if monitor is not None:
            want_rows += ("mon_conf",)
    devices = 1
    if mesh is not None:
        devices = world.size
        held = (members if args.ensemble else [model]) + ([monitor[0]] if monitor else [])
        grid = sharded_sweep(mesh, lambda x: sweep_forward(x, shard), images, labels, GRID_SEED,
                             corruptions=names, temperature=temperature, fused=not args.per_cell,
                             cells_per_call=cells_per_call, return_probs=want_probs, monitor=monitor,
                             return_rows=want_rows, params=[p for m in held for p in m.parameters()],
                             timings=args.timings)
    elif args.per_cell:
        grid = corruption_sweep(sweep_forward, images, labels, GRID_SEED, corruptions=names,
                                temperature=temperature)
    else:
        grid = fused_sweep(sweep_forward, images, labels, GRID_SEED, corruptions=names, temperature=temperature,
                           cells_per_call=cells_per_call, return_probs=want_probs, monitor=monitor,
                           return_rows=want_rows, timings=args.timings)
    policy_summary = None
    if args.policy:
        from fav_tpu_torch.core.policy_replay import grid_policy

        grid, cells, rows = grid
        policy_rows = grid_policy(cells, rows, ticks=args.policy_ticks, device=device)
        for (cname, sev), prow in zip(cells, policy_rows):
            grid[cname][sev].update(prow)
        never_blocked_low_acc = [
            f"{cname}/{sev}"
            for (cname, sev), prow in zip(cells, policy_rows)
            if grid[cname][sev]["accuracy"] < 0.30 and prow["time_to_blocked_s"] < 0
        ]
        worst_allowed_wrong = sorted(
            ((round(prow["allowed_wrong_share"], 4), f"{cname}/{sev}") for (cname, sev), prow in zip(cells, policy_rows)),
            reverse=True,
        )[:5]
        n_cells = len(policy_rows)
        policy_summary = {
            "ticks": args.policy_ticks,
            "dt": 1.0 / 30.0,
            **{
                f"mean_share_{s}": round(sum(r[f"policy_share_{s}"] for r in policy_rows) / n_cells, 4)
                for s in ("vision_allowed", "vision_declining", "vision_degraded", "vision_blocked")
            },
            "mean_allowed_wrong_share": round(sum(r["allowed_wrong_share"] for r in policy_rows) / n_cells, 4),
            "cells_blocked": sum(1 for r in policy_rows if r["time_to_blocked_s"] > 0),
            "never_blocked_low_acc_cells": never_blocked_low_acc,
            "worst_allowed_wrong": [{"cell": c, "allowed_wrong_share": v} for v, c in worst_allowed_wrong],
        }
    conformal_summary = None
    if want_probs:
        from fav_tpu_torch.models.conformal import attach_conformal_metrics

        grid, cells, cell_probs = grid
        conformal_summary = attach_conformal_metrics(
            grid, cells, cell_probs, labels, forward=apply_fn, temperature=temperature,
            cal_images=torch.from_numpy(ds.test_images[n:]).to(device),
            cal_labels=torch.from_numpy(ds.test_labels[n:]).to(device),
            alpha=args.conformal,
        )

    # mean over severities per corruption; AUROC only over cells with failures
    def agg(cells):
        with_fail = [c for c in cells.values() if c["failure_rate"] > 0]
        out = {
            "accuracy": round(sum(c["accuracy"] for c in cells.values()) / len(cells), 4),
            "auroc": None,
            "ece": round(sum(c["ece"] for c in cells.values()) / len(cells), 4),
            "brier": round(sum(c["brier"] for c in cells.values()) / len(cells), 4),
            "mean_anomaly": round(sum(c["mean_anomaly"] for c in cells.values()) / len(cells), 4),
        }
        if with_fail:
            for m in ("auroc", "auroc_energy", "aupr", "fpr_at_95"):
                out[m] = round(sum(c[m] for c in with_fail) / len(with_fail), 4)
            for m in ("auroc_self", "auroc_gated", "auroc_mi", "auroc_vote",
                      "auroc_maha", "auroc_rmd", "auroc_l1", "auroc_composed"):
                if all(m in c for c in with_fail):
                    out[m] = round(sum(c[m] for c in with_fail) / len(with_fail), 4)
        for m in ("ece_self", "ece_gated", "mean_mi", "ece_vote", "mean_agreement",
                  "mean_maha", "mean_rmd", "l1_flag_rate", "l1_mean_anomaly",
                  "mean_anomaly_composed"):
            if all(m in c for c in cells.values()):
                out[m] = round(sum(c[m] for c in cells.values()) / len(cells), 4)
        if all("coverage" in c for c in cells.values()):
            out["coverage"] = round(sum(c["coverage"] for c in cells.values()) / len(cells), 4)
            out["set_size"] = round(sum(c["set_size"] for c in cells.values()) / len(cells), 3)
        return out

    per_corruption = {name: agg(cells) for name, cells in grid.items()}

    # confidently wrong cells (accuracy < 0.30 at operative confidence > 0.60),
    # and those of them the L1 analyzer does not majority-flag
    confident_wrong: list[dict] = []
    for name, cells in grid.items():
        for sev, c in cells.items():
            op_conf = c.get("mean_confidence_gated", c["mean_confidence"])
            if c["accuracy"] < 0.30 and op_conf > 0.60:
                confident_wrong.append({
                    "cell": f"{name}/{sev}",
                    "accuracy": round(c["accuracy"], 4),
                    "confidence": round(op_conf, 4),
                    "l1_flag_rate": round(c.get("l1_flag_rate", float("nan")), 4),
                    "l1_mean_anomaly": round(c.get("l1_mean_anomaly", float("nan")), 4),
                })
    unflagged = [r for r in confident_wrong
                 if not (r["l1_flag_rate"] == r["l1_flag_rate"] and r["l1_flag_rate"] >= 0.5)]

    def overall_mean(metric):
        vals = [v[metric] for v in per_corruption.values() if v.get(metric) is not None]
        return round(sum(vals) / len(vals), 4) if vals else None

    overall = {
        "model": source,
        "images_per_cell": n,
        "mean_corrupted_accuracy": round(
            sum(v["accuracy"] for v in per_corruption.values()) / len(per_corruption), 4),
        "mean_failure_auroc": overall_mean("auroc"),
        "mean_failure_auroc_energy": overall_mean("auroc_energy"),
        # BALD and the vote: only multi-forward scorers have members to disagree
        **({"mean_failure_auroc_mi": overall_mean("auroc_mi"),
            "mean_failure_auroc_vote": overall_mean("auroc_vote"),
            "mean_ece_vote": overall_mean("ece_vote")} if (args.ensemble or args.mc_dropout) else {}),
        **({"mean_failure_auroc_maha": overall_mean("auroc_maha"),
            "mean_failure_auroc_rmd": overall_mean("auroc_rmd")} if args.maha else {}),
        "mean_failure_aupr": overall_mean("aupr"),
        "mean_fpr_at_95": overall_mean("fpr_at_95"),
        "mean_ece": overall_mean("ece"),
        "mean_brier": overall_mean("brier"),
        "mean_l1_flag_rate": overall_mean("l1_flag_rate"),
        "mean_failure_auroc_l1": overall_mean("auroc_l1"),
        "mean_failure_auroc_composed": overall_mean("auroc_composed"),
        "confident_wrong_cells": confident_wrong,
        "unflagged_confident_wrong_cells": unflagged,
        "devices": devices,
        "data_source": ds.source,
        **({"tta_views": args.tta} if args.tta > 1 else {}),
        **({"monitor": args.monitor,
            "mean_failure_auroc_self": overall_mean("auroc_self"),
            "mean_ece_self": overall_mean("ece_self"),
            "mean_failure_auroc_gated": overall_mean("auroc_gated"),
            "mean_ece_gated": overall_mean("ece_gated")} if monitor is not None else {}),
    }
    if conformal_summary is not None:
        overall["conformal"] = conformal_summary
    if policy_summary is not None:
        overall["policy"] = policy_summary
    return {"summary": overall, "per_corruption": per_corruption, "grid": grid}


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", type=str, nargs="*", default=None,
                        help="weight names under fav_tpu_torch/weights or <stem>.npz paths (default: classifier)")
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--num-images", type=int, default=2048)
    parser.add_argument("--train-steps", type=int, default=0,
                        help="train this many steps if no checkpoint is found")
    parser.add_argument("--corruptions", type=str, default="",
                        help="comma-separated subset (default: all 15)")
    parser.add_argument("--widths", type=str, default="",
                        help="comma-separated CNN stage widths (default: config)")
    parser.add_argument("--arch", type=str, default="vgg", choices=("vgg", "resnet", "vit"),
                        help="classifier family of a checkpoint without metadata (models/cnn.py, models/vit.py)")
    parser.add_argument("--ensemble", type=int, default=0,
                        help="evaluate an N-member ensemble copy (weights/ensemble unless --checkpoint): the "
                             "members' mean logits in every cell, plus the BALD and vote rows")
    parser.add_argument("--mc-dropout", type=int, default=0,
                        help="evaluate the single-model checkpoint with N MC-dropout replicas (logit-averaged)")
    parser.add_argument("--tta", type=int, default=0, metavar="K",
                        help="test-time augmentation: average logits over the clean view and K-1 AugMix views, "
                             "each view's draws fixed")
    parser.add_argument("--per-cell", action="store_true",
                        help="finish each cell's metrics on the device, cell by cell (debugging aid)")
    parser.add_argument("--conformal", type=float, default=0.0, metavar="ALPHA",
                        help="split-conformal prediction sets at miscoverage ALPHA: calibrate on held-out "
                             "clean data, report coverage and set size per cell (fused path only)")
    parser.add_argument("--maha", action="store_true",
                        help="Mahalanobis and relative-Mahalanobis failure scores on penultimate features "
                             "(auroc_maha / auroc_rmd per cell)")
    parser.add_argument("--maha-fit-images", type=int, default=10240,
                        help="train images used for the Gaussian fit")
    parser.add_argument("--policy", action="store_true",
                        help="replay each cell's per-sample L1 statuses and composed anomalies through the "
                             "trust scan at 30 Hz; per-cell policy shares join the grid (fused path only)")
    parser.add_argument("--policy-ticks", type=int, default=900,
                        help="replay stream length in ticks (30 s default)")
    parser.add_argument("--monitor", type=str, default=None, metavar="NAME",
                        help="decoupled predictor/monitor deployment: accuracy from the checkpoint, the "
                             "failure score and operative calibration from this checkpoint's confidence")
    return parser


def main(argv=None, timings: dict | None = None, dataset=None) -> dict:
    """Run the CLI; returns the result dict. ``timings``, if given, gains the
    grid's seconds per stage (``parallel/sweep.py:fused_sweep``);
    ``dataset`` stands in for ``load_cifar10()`` (a caller running several
    grids loads it once)."""
    parser = _parser()
    args = parser.parse_args(argv)
    args.timings = timings
    if args.conformal and args.per_cell:
        parser.error("--conformal requires the fused sweep path")
    if args.policy and (args.per_cell or args.conformal):
        parser.error("--policy requires the fused sweep path and is mutually exclusive with --conformal")
    if args.monitor and (args.per_cell or args.conformal or args.tta > 1):
        parser.error("--monitor requires the fused sweep path and is mutually exclusive with --conformal/--tta")
    if args.maha and (args.ensemble or args.mc_dropout or args.tta > 1 or args.conformal or args.monitor):
        parser.error("--maha is a single-forward feature-space score; it is mutually exclusive with "
                     "--ensemble/--mc-dropout/--tta/--conformal/--monitor")

    import torch

    from fav_tpu_torch.data.cifar import load_cifar10
    from fav_tpu_torch.device import resolve_device

    from fav_tpu_torch.parallel.dist import current_world, init_world

    device = resolve_device(os.environ.get(DEVICE_ENV) or None)
    world = current_world()
    if world is None and int(os.environ.get("WORLD_SIZE", "1") or 1) > 1:
        world = init_world(device)
    if world is not None:
        device = world.device
    talk = world is None or world.rank == 0
    # float32 matmuls (the band-matrix families, the Mahalanobis products)
    # in full float32, as fav_tpu's Precision.HIGHEST: never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ds = dataset if dataset is not None else load_cifar10()
    ckpts = args.checkpoint or [DEFAULT_ENSEMBLE if args.ensemble else DEFAULT_CHECKPOINT]
    n = min(args.num_images, ds.test_images.shape[0])
    images = torch.from_numpy(ds.test_images[:n]).to(device)
    labels = torch.from_numpy(ds.test_labels[:n]).to(device)

    monitor = _load_monitor(args.monitor, parser, device) if args.monitor else None

    results: dict[str, dict] = {}
    for ckpt in ckpts:
        result = _evaluate_checkpoint(ckpt, args, ds, images, labels, monitor, parser, device, world)
        results[ckpt] = result
        if talk:
            print(json.dumps(result["summary"], indent=2))

    if len(ckpts) == 1:
        result = results[ckpts[0]]
        if args.out and talk:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=2)
            print(f"full grid -> {args.out}")
        return result
    combined = {"checkpoints": results}
    if args.out and talk:
        with open(args.out, "w") as f:
            json.dump(combined, f, indent=2)
        print(f"full grids -> {args.out}")
    return combined


def cli_main(argv=None) -> None:
    """Console entry: :func:`main` without its return value."""
    main(argv)


if __name__ == "__main__":
    main()
