"""Backfill deploy-time conformal thresholds into weight copies.

Counterpart of the repository's ``tools/backfill_conformal.py``. Training
writes ``conformal_qhat``/``conformal_alpha`` into a copy's metadata
(``models/pretrain.py``); this derives the same entries for a copy that
lacks them, by the same recipe: randomised APS scores of the tempered
probabilities on the temperature-calibration split (the first half of the
test set), alpha 0.1 (``models/conformal.py:calibration_metadata``). An
ensemble is scored by its logit-averaged forward; an autoencoder (no label
space) and a copy that already has a threshold are skipped.

    python -m fav_tpu_torch.tools.backfill_conformal [STEM ...] [--device cpu]

With no stems it visits every copy under ``fav_tpu_torch/weights``. Every
shipped copy already carries its threshold, so that run changes nothing.
"""

from __future__ import annotations

import argparse
import json

import torch

from fav_tpu_torch.data.cifar import load_cifar10
from fav_tpu_torch.device import resolve_device
from fav_tpu_torch.models.conformal import calibration_metadata
from fav_tpu_torch.models.pretrain import heldout_split, mean_logits
from fav_tpu_torch.utils.checkpoint import WEIGHTS_DIR, load_weights, resolve_copy

__all__ = ["backfill", "main", "shipped_copies"]


def shipped_copies() -> list[str]:
    """Every copy under ``weights/``: a metadata file with weights beside it."""
    return sorted(str(p)[: -len(".metadata.json")] for p in WEIGHTS_DIR.glob("*.metadata.json")
                  if p.with_name(p.name[: -len(".metadata.json")] + ".npz").is_file())


@torch.no_grad()
def backfill(ckpt: str, device: str | torch.device | None = None, dataset=None, u=None) -> dict | None:
    """Add ``conformal_alpha``/``conformal_qhat`` to the metadata of the copy
    ``ckpt`` (a stem or a path) where they are missing, calibrated on
    ``dataset`` (``load_cifar10()`` when None) on ``device`` (the card by
    default); ``u`` the APS uniforms (``calibration_metadata``'s default
    when None). Returns the entries written, or None where it skipped."""
    found = resolve_copy(ckpt)
    if found is None:
        raise FileNotFoundError(f"no weight copy at {ckpt}")
    directory, stem = found
    meta_path = directory / f"{stem}.metadata.json"
    meta = json.loads(meta_path.read_text())
    if "conformal_qhat" in meta:
        print(f"{ckpt}: already has qhat {meta['conformal_qhat']}")
        return None
    if "ae_widths" in meta or meta.get("err_baseline") is not None:
        print(f"{ckpt}: autoencoder copy, no label space - skipped")
        return None
    dev = resolve_device(device)
    model, _ = load_weights(stem, device=dev, directory=directory)
    ds = load_cifar10() if dataset is None else dataset
    val_x, val_y, _, _ = heldout_split(ds, dev)
    probs = torch.softmax(mean_logits(model, val_x) / float(meta.get("temperature", 1.0)), dim=-1)
    entries = calibration_metadata(probs, val_y, u=u)
    meta.update(entries)
    meta_path.write_text(json.dumps(meta, indent=2) + "\n")
    print(f"{ckpt}: {entries}")
    return entries


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stems", nargs="*", help="weight copies (default: every copy under weights/)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return {stem: backfill(stem, args.device) for stem in args.stems or shipped_copies()}


if __name__ == "__main__":
    main()
