"""Train the single-model classifier and save its weights.

    python -m fav_tpu_torch.models.pretrain --augmix --steps 3000 --widths 64,128,256

Counterpart of ``fav_tpu/models/pretrain.py:main`` for one model: train
the CNN on CIFAR-10 (real batches under ``$FAV_CIFAR_DIR``, the
deterministic synthetic set otherwise) on the card
(``--device cpu`` for the host), report the test accuracy on the second
half of the test split, as ``fav_tpu`` does, and write ``<out>.npz`` (one
array per flax path, the layout ``utils/checkpoint.py:load_student``
reads) and ``<out>.metadata.json``.

Not ported yet (ROADMAP.md Queue 1 items 5 and 9): the temperature, ECE,
failure AUROC and conformal threshold of the metadata (they need
``models/calibration.py`` and ``models/conformal.py``), and ensembles, the
autoencoder, distillation, SAM, DeepAugment and the extra AugMix ops:
``fav_tpu``'s flags for them raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from fav_tpu_torch.config import ModelParams
from fav_tpu_torch.data.cifar import load_cifar10
from fav_tpu_torch.device import resolve_device
from fav_tpu_torch.models.cnn import create_model
from fav_tpu_torch.models.train import classifier_eval_step, train_classifier
from fav_tpu_torch.utils.checkpoint import save_flax_npz, torch_to_flax

__all__ = ["DEFAULT_OUT", "main"]

DEFAULT_OUT = Path(__file__).resolve().parents[2] / "build" / "torch_checkpoints" / "classifier"

# fav_tpu's flags for what the port does not train yet
_NOT_PORTED = ("--ensemble", "--shard", "--arch", "--autoencoder", "--distill-mc", "--teacher",
               "--distill-ensemble", "--kd-temperature", "--augmix-ce", "--sam", "--freqband", "--occlude",
               "--occlude-bars", "--bf16-aug", "--deepaugment")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default=str(DEFAULT_OUT),
                   help="path prefix of <out>.npz and <out>.metadata.json")
    p.add_argument("--log-every", type=int, default=200)
    p.add_argument("--widths", type=str, default="", help="comma-separated stage widths (default: ModelParams)")
    p.add_argument("--augmix", action="store_true",
                   help="AugMix chains with the Jensen-Shannon consistency loss")
    p.add_argument("--js-lam", type=float, default=12.0, help="JS consistency weight for --augmix")
    p.add_argument("--megastep", type=int, default=0, metavar="K",
                   help="train in device-resident K-step chunks (same trajectory as the per-step loop)")
    p.add_argument("--standardize", action="store_true", help="per-image input standardization in the forward")
    p.add_argument("--device", type=str, default=None, help="'cpu' to train on the host; the card by default")
    return p


def main(argv: list[str] | None = None) -> dict:
    parser = _parser()
    args, rest = parser.parse_known_args(argv)
    asked = [a for a in rest if a.split("=")[0] in _NOT_PORTED]
    if asked:
        raise NotImplementedError(f"pretrain: {asked[0]} is not ported yet (ROADMAP.md Queue 1 item 9)")
    if rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    dev = resolve_device(args.device)
    ds = load_cifar10()
    print(f"dataset: {ds.source} ({ds.train_images.shape[0]} train / {ds.test_images.shape[0]} test)")

    mp = ModelParams(standardize_input=args.standardize)
    if args.widths:
        widths = tuple(int(w) for w in args.widths.split(","))
        mp = ModelParams(widths=widths, dense_width=widths[-1], standardize_input=args.standardize)
    model, _ = train_classifier(
        create_model(mp), ds, num_steps=args.steps, batch_size=args.batch, learning_rate=args.lr,
        seed=args.seed, log_every=args.log_every, augmix=args.augmix, js_lam=args.js_lam,
        megastep=args.megastep, device=dev,
    )
    model.eval()
    n_val = ds.test_images.shape[0] // 2
    test_x = torch.from_numpy(ds.test_images[n_val:]).to(dev)
    test_y = torch.from_numpy(ds.test_labels[n_val:]).to(dev)
    out = classifier_eval_step(model, test_x, test_y)
    metrics = {
        "accuracy": round(float(out["accuracy"]), 4),
        "data_source": ds.source,
        "train_steps": args.steps,
        "ensemble_size": None,
        **({"augmix": True, "js_lam": args.js_lam} if args.augmix else {}),
        "arch": mp.arch,
        "widths": list(mp.widths),
        "dense_width": mp.dense_width,
        **({"standardize_input": True} if mp.standardize_input else {}),
    }
    print(json.dumps(metrics, indent=2))
    prefix = Path(args.out)
    prefix.parent.mkdir(parents=True, exist_ok=True)
    save_flax_npz(prefix.with_name(prefix.name + ".npz"), torch_to_flax(model.state_dict()))
    prefix.with_name(prefix.name + ".metadata.json").write_text(json.dumps(metrics, indent=2) + "\n")
    print(f"weights -> {prefix}.npz")
    return metrics


if __name__ == "__main__":
    main()
