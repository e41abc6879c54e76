"""The detection megastep: corrupt a batch per family, run the CNN, reduce
to the trust engine's scalars.

Counterpart of ``bench.py:107-136`` (the megastep) and
``__graft_entry__.py:60-93`` (``entry``). For each cell (family, severity)
the batch is corrupted, goes through the bf16 forward, MSP confidence and
``anomaly_from_confidence``; the megastep returns the same ``[3]`` vector as
``bench.py``: mean confidence, mean anomaly and failure rate
(``confidence < 0.5``), each averaged over the cells.

The default cells are ``bench.py``'s ``BENCH_CELLS``: all fifteen families
at severity 3, in its order, so the whole main path runs: K1-K6 and the
band-matrix families (``ops/corruptions_cuda.py``), then the nano forward.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from fav_tpu_torch.config import ModelParams
from fav_tpu_torch.device import resolve_device
from fav_tpu_torch.models.cnn import create_model
from fav_tpu_torch.models.uncertainty import anomaly_from_confidence, msp
from fav_tpu_torch.ops import corruptions_cuda

__all__ = ["BENCH_CELLS", "BATCH", "FAILURE_THRESHOLD", "cell_scalars", "make_megastep", "entry"]

# bench.py:27-43: all fifteen families at the severity-3 midpoint, in order.
BENCH_CELLS = (
    ("gaussian_noise", 3),
    ("shot_noise", 3),
    ("impulse_noise", 3),
    ("defocus_blur", 3),
    ("glass_blur", 3),
    ("motion_blur", 3),
    ("zoom_blur", 3),
    ("snow", 3),
    ("frost", 3),
    ("fog", 3),
    ("brightness", 3),
    ("contrast", 3),
    ("elastic_transform", 3),
    ("pixelate", 3),
    ("jpeg_compression", 3),
)
BATCH = 6144  # bench.py's batch
FAILURE_THRESHOLD = 0.5

SEED_HIGH = 1 << 62  # per-cell seeds are drawn in [0, SEED_HIGH)


def cell_scalars(model: torch.nn.Module, corrupted: torch.Tensor) -> torch.Tensor:
    """``[mean confidence, mean anomaly, failure rate]`` of one corrupted batch."""
    conf = msp(model(corrupted))
    return torch.stack([
        conf.mean(),
        anomaly_from_confidence(conf).mean(),
        (conf < FAILURE_THRESHOLD).to(torch.float32).mean(),
    ])


def make_megastep(
    model: torch.nn.Module,
    cells: Sequence[tuple[str, int]] = BENCH_CELLS,
    device: str | torch.device | None = None,
    corruption_fn: Callable[[str], Callable] | None = None,
):
    """``megastep(images, generator) -> [3]`` over ``cells``.

    ``images`` are NHWC float32 on ``device`` (the card unless ``"cpu"`` is
    asked for). One seed per cell is drawn from ``generator``, a CPU
    ``torch.Generator``, so two megasteps given equally seeded generators
    corrupt alike. ``corruption_fn`` maps a family name to
    ``fn(seed, x, severity)``; it defaults to the kernel router
    ``ops.corruptions_cuda.corruption_fn``.
    """
    dev = resolve_device(device)
    route = corruption_fn or corruptions_cuda.corruption_fn
    fns = [(route(name), severity) for name, severity in cells]

    @torch.no_grad()
    def megastep(images: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        if images.device.type != dev.type:
            raise ValueError(f"images are on {images.device}, the megastep runs on {dev}")
        seeds = torch.randint(0, SEED_HIGH, (len(fns),), generator=generator).tolist()
        rows = [cell_scalars(model, fn(seed, images, severity))
                for (fn, severity), seed in zip(fns, seeds)]
        return torch.stack(rows).mean(dim=0)

    return megastep


def entry(device: str | torch.device | None = None):
    """Return ``(fn, example_args)``: the flagship forward step, as
    ``__graft_entry__.entry`` does for the JAX package. The step corrupts a
    batch with gaussian noise (K1), runs the default-width CNN (random
    weights from seed 0) and returns prediction, confidence and anomaly."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = create_model(ModelParams()).to(dev).eval()
    images = torch.zeros((256, 32, 32, 3), dtype=torch.float32, device=dev)
    gaussian = corruptions_cuda.corruption_fn("gaussian_noise")

    @torch.no_grad()
    def forward_step(images: torch.Tensor, seed: int) -> dict[str, torch.Tensor]:
        corrupted = gaussian(seed, images, 3)
        probs = torch.softmax(model(corrupted), dim=-1)
        confidence = probs.amax(dim=-1)
        return {
            "prediction": probs.argmax(dim=-1),
            "confidence": confidence,
            "anomaly": anomaly_from_confidence(confidence),
        }

    return forward_step, (images, 1)
