"""Shift-aware temperature refitting of a single-classifier weight copy.

Counterpart of the repository's ``tools/refit_temperature.py``. The
clean-fit temperature (held-out clean NLL) does not survive corruption:
under shift accuracy falls but logit magnitudes do not. This refits T on a
leak-free proxy for shift: the held-out split (the first half of the test
set) plus K AugMix views of it (the op pool is disjoint from the grid's
15 corruptions; ``--occlude`` and ``--freqband`` widen it), made by the
port's ``ops/augment.py:augmix`` (the shear passes K9a and K9b on the
card). View i comes from a generator seeded ``fold_in(seed, i)``, the
counterpart of the JAX tool's ``fold_in(PRNGKey(seed), i)``: the views are
another draw of the same law, so the fit (:func:`fit_report`) is the JAX
tool's on any given logits, and the report agrees with it statistically.

By default it only reports the clean-fit and shift-fit temperatures and
their ECEs on the clean and augmented split, with the JAX tool's keys. With
``--out STEM`` it writes a copy of the weights (bit-equal) whose metadata
carries ``temperature`` (the shift fit), ``temperature_cleanfit`` and
``temperature_refit``; ``evaluate --checkpoint STEM`` and the server read
it unchanged. Ensembles are refused: their temperature rides the
logit-averaged forward and is refit at stack time
(``tools/stack_ensemble.py``).

    python -m fav_tpu_torch.tools.refit_temperature --checkpoint classifier \\
        [--views 7] [--occlude] [--freqband] [--seed 1234] [--out STEM] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import torch

from fav_tpu_torch.data.cifar import load_cifar10
from fav_tpu_torch.device import resolve_device
from fav_tpu_torch.models.calibration import expected_calibration_error, fit_temperature
from fav_tpu_torch.models.pretrain import heldout_split
from fav_tpu_torch.ops.augment import augmix
from fav_tpu_torch.ops.random import fold_in
from fav_tpu_torch.utils.checkpoint import load_weights, resolve_copy

__all__ = ["fit_report", "main", "refit", "view_logits"]


def ece_at(logits: torch.Tensor, y: torch.Tensor, t: float) -> float:
    probs = torch.softmax(logits / t, dim=-1)
    conf, preds = probs.max(dim=-1)
    return float(expected_calibration_error(conf, (preds == y).to(torch.float32)))


@torch.no_grad()
def view_logits(model, val_x: torch.Tensor, views: int, seed: int, freq: bool = False,
                occlude: bool = False) -> list[torch.Tensor]:
    """The logits of the clean split and of ``views`` AugMix views of it,
    view i from a generator seeded ``fold_in(seed, i)`` on the split's
    device."""
    sets = [model(val_x)]
    for i in range(views):
        g = torch.Generator(device=val_x.device).manual_seed(fold_in(seed, i))
        sets.append(model(augmix(g, val_x, freq=freq, occlude=occlude)))
    return sets


def fit_report(logit_sets: list[torch.Tensor], val_y: torch.Tensor) -> dict:
    """The fits and statistics of the JAX tool from the clean logits
    ``logit_sets[0]`` and the views' ``logit_sets[1:]``: T fitted on the
    clean set and on all sets together, the views' accuracy and the ECE of
    either T on the clean and on the augmented sets. The temperatures
    unrounded under ``t_clean`` and ``t_shift``."""
    views = len(logit_sets) - 1
    t_clean = float(fit_temperature(logit_sets[0], val_y))
    t_shift = float(fit_temperature(torch.cat(logit_sets), val_y.repeat(views + 1)))
    aug_logits, aug_y = torch.cat(logit_sets[1:]), val_y.repeat(views)
    return {
        "t_clean": t_clean,
        "t_shift": t_shift,
        "temperature_cleanfit": round(t_clean, 4),
        "temperature_shiftfit": round(t_shift, 4),
        "val_acc_augmented_views": round(float((aug_logits.argmax(-1) == aug_y).to(torch.float32).mean()), 4),
        "ece_clean_val": {
            "cleanfit_T": round(ece_at(logit_sets[0], val_y, t_clean), 4),
            "shiftfit_T": round(ece_at(logit_sets[0], val_y, t_shift), 4),
        },
        "ece_augmented_val": {
            "cleanfit_T": round(ece_at(aug_logits, aug_y, t_clean), 4),
            "shiftfit_T": round(ece_at(aug_logits, aug_y, t_shift), 4),
        },
    }


def refit(checkpoint: str, views: int = 7, occlude: bool = False, freqband: bool = False, seed: int = 1234,
          out: str | None = None, device: str | torch.device | None = None, dataset=None) -> dict:
    """The report of the JAX tool for the copy ``checkpoint`` (a stem or a
    path) on ``dataset`` (``load_cifar10()`` when None), on ``device`` (the
    card by default); with ``out``, the refit copy written there. The
    temperatures also unrounded under ``t_clean`` and ``t_shift``."""
    found = resolve_copy(checkpoint)
    if found is None:
        raise FileNotFoundError(f"no weight copy at {checkpoint}")
    directory, stem = found
    meta = json.loads((directory / f"{stem}.metadata.json").read_text())
    if meta.get("ensemble_size"):
        raise ValueError("single-model copies only (an ensemble's temperature rides the logit-averaged "
                         "forward: refit at stack time instead, tools/stack_ensemble.py)")
    dev = resolve_device(device)
    model, _ = load_weights(stem, device=dev, directory=directory)
    ds = load_cifar10() if dataset is None else dataset
    val_x, val_y, _, _ = heldout_split(ds, dev)
    fits = fit_report(view_logits(model, val_x, views, seed, freqband, occlude), val_y)
    report = {"checkpoint": os.path.normpath(checkpoint), "views": views,
              "view_pool": {"freqband": freqband, "occlude": occlude}, **fits}
    if out:
        new_meta = {**meta, "temperature": report["temperature_shiftfit"],
                    "temperature_cleanfit": report["temperature_cleanfit"],
                    "temperature_refit": {"views": views, "freqband": freqband, "occlude": occlude, "seed": seed},
                    "format": "npz"}
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        shutil.copyfile(directory / f"{stem}.npz", out + ".npz")
        with open(out + ".metadata.json", "w") as f:
            json.dump(new_meta, f, indent=2)
            f.write("\n")
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True, help="weight copy: a stem under weights/ or a path")
    ap.add_argument("--views", type=int, default=7,
                    help="AugMix views of the held-out split fitted beside its clean copy")
    ap.add_argument("--occlude", action="store_true", help="add the rectangular occlusion op to the view pool")
    ap.add_argument("--freqband", action="store_true", help="add the spectral band-gain op to the view pool")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--out", default=None, help="write a copy with the refit temperature to this stem")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    report = refit(args.checkpoint, args.views, args.occlude, args.freqband, args.seed, args.out, args.device)
    report = {k: v for k, v in report.items() if k not in ("t_clean", "t_shift")}
    print(json.dumps(report, indent=2))
    if args.out:
        print(f"weights -> {args.out}.npz")
    return report


if __name__ == "__main__":
    main()
