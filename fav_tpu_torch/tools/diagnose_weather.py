"""Diagnose the weather-family robustness floor (fog, snow, frost).

Counterpart of the repository's ``tools/diagnose_weather.py``. For the
clean test images, one AugMix view of them and fog, snow, frost and
gaussian noise at severities 1, 3 and 5 it measures:

1. where the predictions go (the top predicted class and its share);
2. what the view does to image statistics beside what AugMix covers: the
   luminance mean and spread and the low-frequency energy fraction
   (:func:`lowfreq_fraction`), the axis the op set cannot express;
3. whether the confidence stays honest there (accuracy against mean
   confidence under the copy's temperature).

    python -m fav_tpu_torch.tools.diagnose_weather [--checkpoint classifier]
        [--num-images 2048] [--device cpu]

The corruptions are the families as ``ops/corruptions_cuda.corruption_fn``
routes them (K1 for gaussian noise, the Philox helper for the weather
draws, on the card), family f at severity s seeded ``fold_in(42, 10 f +
s)``; the AugMix view (K9a and K9b on the card) comes from a generator
seeded 42. The draws are another sample of the JAX tool's laws.
"""

from __future__ import annotations

import argparse

import torch

from fav_tpu_torch.data.cifar import load_cifar10
from fav_tpu_torch.device import resolve_device
from fav_tpu_torch.ops import corruptions_cuda
from fav_tpu_torch.ops.augment import augmix
from fav_tpu_torch.ops.random import fold_in
from fav_tpu_torch.utils.checkpoint import load_weights, resolve_copy

__all__ = ["FAMILIES", "PROBE_SEED", "SEVERITIES", "diagnose", "lowfreq_fraction", "main", "probe", "table"]

FAMILIES = ("fog", "snow", "frost", "gaussian_noise")
SEVERITIES = (1, 3, 5)
PROBE_SEED = 42  # the JAX tool's PRNGKey(42)


def lowfreq_fraction(x: torch.Tensor) -> torch.Tensor:
    """Fraction of the non-DC spectral energy of each grayscale image [N, H,
    W, C] that lies in the lowest-frequency octave (radius at most max(H,
    W) / 8): weather overlays live there. Float32, as the JAX tool."""
    gray = x.to(torch.float32).mean(dim=-1)
    mag2 = torch.fft.fft2(gray).abs() ** 2
    h, w = gray.shape[-2:]
    ar_h = torch.arange(h, device=x.device)
    ar_w = torch.arange(w, device=x.device)
    fy = torch.minimum(ar_h, h - ar_h)[:, None]
    fx = torch.minimum(ar_w, w - ar_w)[None, :]
    r = torch.sqrt((fy**2 + fx**2).to(torch.float32))
    zero = torch.zeros((), dtype=mag2.dtype, device=x.device)
    lo = torch.where((r > 0) & (r <= max(h, w) / 8), mag2, zero).sum(dim=(-2, -1))
    tot = torch.where(r > 0, mag2, zero).sum(dim=(-2, -1))
    return lo / torch.clamp(tot, min=1e-9)


@torch.no_grad()
def probe(model, x: torch.Tensor, y: torch.Tensor, temperature: float) -> dict[str, dict]:
    """Each view's accuracy, mean confidence, predicted-class histogram [10],
    luminance mean and spread and mean low-frequency fraction, as floats
    (the histogram a list), in the JAX tool's order of views."""
    g = torch.Generator(device=x.device).manual_seed(PROBE_SEED)
    views = {"clean": x, "augmix": augmix(g, x)}
    for fi, fam in enumerate(FAMILIES):
        for sev in SEVERITIES:
            views[f"{fam}_s{sev}"] = corruptions_cuda.corruption_fn(fam)(fold_in(PROBE_SEED, fi * 10 + sev), x, sev)
    out = {}
    for name, v in views.items():
        probs = torch.softmax(model(v) / temperature, dim=-1)
        conf, preds = probs.max(dim=-1)
        hist = torch.bincount(preds, minlength=probs.shape[-1]).to(torch.float32) / preds.shape[0]
        out[name] = {
            "acc": float((preds == y).to(torch.float32).mean()),
            "conf": float(conf.mean()),
            "pred_hist": hist.tolist(),
            "lum_mean": float(v.mean()),
            "lum_std": float(v.reshape(v.shape[0], -1).std(dim=1, correction=0).mean()),
            "lowfreq_frac": float(lowfreq_fraction(v).mean()),
        }
    return out


def diagnose(checkpoint: str = "classifier", num_images: int = 2048, device: str | torch.device | None = None,
             dataset=None) -> dict:
    """``{"checkpoint", "n", "views"}``: :func:`probe` of the copy
    ``checkpoint`` on the first ``n = min(num_images, test size)`` test
    images of ``dataset`` (``load_cifar10()`` when None), on ``device`` (the
    card by default)."""
    found = resolve_copy(checkpoint)
    if found is None:
        raise FileNotFoundError(f"no weight copy at {checkpoint}")
    dev = resolve_device(device)
    model, meta = load_weights(found[1], device=dev, directory=found[0])
    if isinstance(model, list):
        raise ValueError(f"{checkpoint}: single-model copies only")
    ds = load_cifar10() if dataset is None else dataset
    n = min(num_images, ds.test_images.shape[0])
    x = torch.from_numpy(ds.test_images[:n]).to(dev)
    y = torch.from_numpy(ds.test_labels[:n]).to(dev)
    return {"checkpoint": checkpoint, "n": n, "views": probe(model, x, y, float(meta.get("temperature", 1.0)))}


def table(res: dict[str, dict]) -> str:
    lines = [f"{'view':>18} {'acc':>6} {'conf':>6} {'lum_mu':>7} {'lum_sd':>7} {'lofreq':>7}  top-pred(frac)"]
    for name, m in res.items():
        top = max(range(len(m["pred_hist"])), key=m["pred_hist"].__getitem__)
        lines.append(f"{name:>18} {m['acc']:6.3f} {m['conf']:6.3f} {m['lum_mean']:7.3f} {m['lum_std']:7.3f} "
                     f"{m['lowfreq_frac']:7.3f}  class {top} ({m['pred_hist'][top]:.2f})")
    return "\n".join(lines)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", default="classifier", help="weight copy: a stem under weights/ or a path")
    ap.add_argument("--num-images", type=int, default=2048)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    res = diagnose(args.checkpoint, args.num_images, args.device)
    print(f"checkpoint={res['checkpoint']} n={res['n']}")
    print(table(res["views"]))
    return res


if __name__ == "__main__":
    main()
