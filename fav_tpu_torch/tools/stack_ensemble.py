"""Stack same-architecture weight copies into one ensemble copy (a
heterogeneous-recipe ensemble), and calibrate it.

Counterpart of the repository's ``tools/stack_ensemble.py``. The members
are copies trained with different recipes (plain AugMix, +freqband,
+occlude) or seeds (``tools/train_occl_members.py``); diverse recipes make
diverse errors, which logit averaging turns into detection. Every leaf is
stacked on a leading member axis, the layout ``utils/checkpoint.py:
load_weights`` reads for ``ensemble.npz``; the temperature and the
deploy-time conformal threshold are fitted on the logit-averaged forward of
the first half of the test split and accuracy, ECE and failure AUROC
reported on the second (``models/pretrain.py:quality_metadata``, the
recipe of ``fav_tpu``'s pretrain and of the JAX tool). ``evaluate
--ensemble M --checkpoint OUT`` and the server's ensemble mode
(``FAV_SERVER_UNCERTAINTY=ensemble FAV_SERVER_CHECKPOINT=OUT``) read the
result unchanged.

    python -m fav_tpu_torch.tools.stack_ensemble --out build/ensemble_recipes \\
        classifier classifier_freq classifier_occl [--device cpu]

Members are copy stems under ``fav_tpu_torch/weights`` or paths to
``<stem>.npz`` beside ``<stem>.metadata.json``; members whose arch, widths
or dense width disagree are refused. Writes ``<out>.npz`` and
``<out>.metadata.json`` and prints the metadata.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from fav_tpu_torch.data.cifar import load_cifar10
from fav_tpu_torch.device import resolve_device
from fav_tpu_torch.models.pretrain import heldout_split, mean_logits, quality_metadata
from fav_tpu_torch.utils.checkpoint import load_flax_npz, load_weights, resolve_copy, save_flax_npz

__all__ = ["RECIPE_KEYS", "ensemble_metadata", "main", "stack", "stack_trees"]

# the training-recipe keys of each member's metadata kept in member_recipes
RECIPE_KEYS = ("augmix", "freqband", "occlude", "train_steps")


def _member(ckpt: str) -> tuple[str, str, dict]:
    found = resolve_copy(ckpt)
    if found is None:
        raise FileNotFoundError(f"no weight copy at {ckpt}")
    directory, stem = found
    return str(directory), stem, json.loads((directory / f"{stem}.metadata.json").read_text())


def stack_trees(trees: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """Flat flax trees of one architecture -> one tree, every leaf stacked on
    a new leading member axis. Trees with other paths or shapes raise."""
    paths = sorted(trees[0])
    for tree in trees[1:]:
        if sorted(tree) != paths or any(tree[p].shape != trees[0][p].shape for p in paths):
            raise ValueError("members disagree on their parameter trees")
    return {p: np.stack([np.asarray(t[p], np.float32) for t in trees]) for p in paths}


def ensemble_metadata(val_logits: torch.Tensor, val_y: torch.Tensor, logits: torch.Tensor, test_y: torch.Tensor,
                      metas: list[dict], stacked_from: list[str], data_source: str, u=None) -> dict:
    """The JAX tool's metadata from the logit-averaged forward's held-out
    logits, in its order: the calibration keys (``quality_metadata``; ``u``
    the APS uniforms), ``data_source``, ``ensemble_size``, ``stacked_from``,
    ``member_recipes`` and the members' architecture."""
    first = metas[0]
    return {
        **quality_metadata(val_logits, val_y, logits, test_y, u=u),
        "data_source": data_source,
        "ensemble_size": len(metas),
        "stacked_from": stacked_from,
        "member_recipes": [{k: m[k] for k in RECIPE_KEYS if k in m} for m in metas],
        "arch": first.get("arch", "vgg"),
        "widths": list(first["widths"]),
        "dense_width": first["dense_width"],
    }


def stack(members: list[str], out: str, device: str | torch.device | None = None, dataset=None) -> dict:
    """Stack the copies ``members`` into ``<out>.npz`` beside
    ``<out>.metadata.json`` (calibrated on ``dataset``, ``load_cifar10()``
    when None, on ``device``, the card by default). Returns the metadata."""
    dev = resolve_device(device)
    found = [_member(m) for m in members]
    metas = [meta for _, _, meta in found]
    arch_key = {(m.get("arch"), tuple(m.get("widths") or ()), m.get("dense_width")) for m in metas}
    if len(arch_key) != 1:
        raise ValueError(f"members disagree on architecture: {sorted(arch_key, key=str)}")
    stacked = stack_trees([load_flax_npz(os.path.join(d, f"{s}.npz")) for d, s, _ in found])
    models = [load_weights(s, device=dev, directory=d)[0] for d, s, _ in found]
    ds = load_cifar10() if dataset is None else dataset
    val_x, val_y, test_x, test_y = heldout_split(ds, dev)
    meta = ensemble_metadata(mean_logits(models, val_x), val_y, mean_logits(models, test_x), test_y, metas,
                             [os.path.normpath(m) for m in members], ds.source)
    meta["format"] = "npz"
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    save_flax_npz(out + ".npz", stacked)
    with open(out + ".metadata.json", "w") as f:
        json.dump(meta, f, indent=2)
        f.write("\n")
    return meta


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("members", nargs="+", help="weight copies to stack (stems or paths)")
    ap.add_argument("--out", required=True, help="output stem: <out>.npz and <out>.metadata.json")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if len(args.members) < 2:
        ap.error("need at least 2 member checkpoints")
    meta = stack(args.members, args.out, args.device)
    print(json.dumps(meta, indent=2))
    print(f"weights -> {args.out}.npz")
    return meta


if __name__ == "__main__":
    main()
