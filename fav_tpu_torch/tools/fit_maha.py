"""Fit the feature-space Mahalanobis Gaussians of a weight copy and write
``<stem>.maha_fit.npz`` beside it.

Counterpart of the repository's ``tools/fit_maha.py``. Once the fit is
there, the server's ``msp`` InferenceService streams a per-frame
``feature_distance`` (the normalized relative Mahalanobis distance: 0 near
a typical training frame, 1 at the 99th percentile of the held-out training
data) beside confidence, entropy and the conformal set size
(``serving/inference.py``, ``models/mahalanobis.py``).

    python -m fav_tpu_torch.tools.fit_maha --checkpoint fav_tpu_torch/weights/student_nano \\
        [--fit-images 10240] [--out PATH] [--device cuda|cpu]

The recipe is the JAX tool's: the penultimate features of the first
``--fit-images`` training images of ``load_cifar10`` (the synthetic set
when CIFAR-10 is not on disk; nothing is downloaded); the Gaussians fitted
on the first 90% of them; ``rmd_q50`` and ``rmd_q99`` taken from the
held-out last 10% (float64 quantiles). The file has ``fav_tpu``'s layout,
so either package loads the other's. The model is rebuilt from the whole
metadata (``utils/checkpoint.py:load_weights``), ``standardize_input``
included. Prints one JSON object with the JAX tool's keys.
"""

from __future__ import annotations

import argparse
import json
import os
from dataclasses import replace

import numpy as np
import torch

from fav_tpu_torch.config import ModelParams
from fav_tpu_torch.data.cifar import load_cifar10
from fav_tpu_torch.device import resolve_device
from fav_tpu_torch.models.mahalanobis import collect_features, fit_feature_gaussians, mahalanobis_scores, save_fit
from fav_tpu_torch.serving.inference import MAHA_FIT_SUFFIX
from fav_tpu_torch.utils.checkpoint import load_weights

__all__ = ["fit_checkpoint", "main"]


def fit_checkpoint(stem: str, fit_images: int = 10240, out: str | None = None,
                   device: str | torch.device | None = None, dataset=None) -> dict:
    """Fit the Gaussians of the classifier at ``stem`` (``<stem>.npz`` and
    ``<stem>.metadata.json``) on ``dataset`` (``load_cifar10()`` when None)
    and write the fit to ``out`` (``<stem>.maha_fit.npz`` when None).
    Returns the report :func:`main` prints, with the quantiles unrounded
    under ``rmd_q50_exact`` and ``rmd_q99_exact``."""
    dev = resolve_device(device)
    model, meta = load_weights(os.path.basename(stem), device=dev, directory=os.path.dirname(stem) or ".")
    if isinstance(model, list) or not hasattr(model, "features_and_logits"):
        raise ValueError(f"{stem}: not a single classifier (metadata {meta})")
    ds = load_cifar10() if dataset is None else dataset
    n = min(fit_images, ds.train_images.shape[0])
    feats = collect_features(model, ds.train_images[:n])
    # the Gaussians fit on the first 90%; the wire scale's quantiles come
    # from the held-out last 10%, since in-sample quantiles flatter the tail
    n_fit = max(1, int(n * 0.9)) if n >= 10 else n
    fit = fit_feature_gaussians(feats[:n_fit], ds.train_labels[:n_fit], ModelParams().num_classes)
    held = torch.from_numpy(feats[n_fit:] if n_fit < n else feats).to(dev)
    rmd = mahalanobis_scores(held, fit.to(dev))["rmd"].double().cpu().numpy()
    fit = replace(fit, rmd_q50=float(np.quantile(rmd, 0.50)), rmd_q99=float(np.quantile(rmd, 0.99)))
    out = out or stem + MAHA_FIT_SUFFIX
    save_fit(out, fit)
    return {
        "checkpoint": stem,
        "fit_images": n,
        "feature_dim": int(feats.shape[1]),
        "rmd_q50": round(fit.rmd_q50, 3),
        "rmd_q99": round(fit.rmd_q99, 3),
        "out": out,
        "data_source": ds.source,
        "rmd_q50_exact": fit.rmd_q50,
        "rmd_q99_exact": fit.rmd_q99,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True, help="weight stem: <stem>.npz beside <stem>.metadata.json")
    ap.add_argument("--fit-images", type=int, default=10240)
    ap.add_argument("--out", default=None, help="output npz path (default: <checkpoint>.maha_fit.npz)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if not os.path.isfile(args.checkpoint + ".metadata.json"):
        ap.error(f"no weights at {args.checkpoint}")
    report = fit_checkpoint(args.checkpoint, args.fit_images, args.out, args.device)
    print(json.dumps({k: v for k, v in report.items() if not k.endswith("_exact")}, indent=2))


if __name__ == "__main__":
    main()
