"""Defense in depth across data draws: does the L1 signal analyzer catch the
grid cells where every model-confidence signal fails?

Counterpart of the repository's ``tools/defense_in_depth.py``. Every
confident-wrong cell seen across the synthetic draws is a luminance or
contrast failure (snow 3-5, contrast 2-5, brightness 5): the physics the
frame-level analyzer watches independently of any model. For each (draw,
corruption, severity) cell this re-creates the batch the port's grid
scores (``parallel/sweep.py:cell_key`` under the grid's seed, the family
as ``grid_corruption_fn`` routes it: K4 for brightness and contrast, the
Philox helper for snow's and fog's draws on the card), runs the analyzer
(``ops/signal.py:analyze_frame``, its statistics from K7 on the card) on
the uint8 BGR frames with a fresh carry, and reports the fraction flagged
non-OK, the BLANK/CORRUPTED split, the mean L1 anomaly, brightness and
entropy. A clean (severity 0) row per draw is the false-positive control.

    python -m fav_tpu_torch.tools.defense_in_depth [--draws 0,1,2] [--num-images 512]
        [--json FILE] [--device cpu]

Prints the JAX tool's markdown table and writes its ``--json`` keys
(``rows``, ``cells``). Each draw's images come from ``load_cifar10`` with
``FAV_SYNTH_DRAW`` set to the draw for the call.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from fav_tpu_torch.config import STATUS_NAMES, AnalyzerParams
from fav_tpu_torch.data.cifar import load_cifar10
from fav_tpu_torch.device import resolve_device
from fav_tpu_torch.ops import corruptions_cuda
from fav_tpu_torch.ops.signal import analyze_frame, init_analyzer_carry
from fav_tpu_torch.parallel.sweep import GRID_SEED, cell_key

__all__ = ["CELLS", "analyze_batch", "analyze_cells", "cell_batch", "load_draw", "main", "markdown"]

# the union of confident-wrong cells seen across draws 0-2 plus benign
# controls the models handle (fog 1, defocus 1): the analyzer must flag the
# former and not blanket-flag the latter
CELLS = [
    ("snow", 3), ("snow", 4), ("snow", 5),
    ("contrast", 2), ("contrast", 3), ("contrast", 4), ("contrast", 5),
    ("brightness", 5),
    ("fog", 1), ("defocus_blur", 1),
]


def cell_batch(images: torch.Tensor, name: str, severity: int) -> torch.Tensor:
    """The batch the grid scores in cell (``name``, ``severity``): the
    grid's family, seeded by the cell's absolute index."""
    return corruptions_cuda.grid_corruption_fn(name)(cell_key(GRID_SEED, name, severity), images, severity)


@torch.no_grad()
def analyze_batch(x: torch.Tensor):
    """Float32 RGB in [0, 1], [N, H, W, C] -> (status int32, anomaly,
    mean brightness, entropy), each [N]: the frames ``round(x 255)`` in BGR,
    a fresh carry (FROZEN cannot fire)."""
    frames = torch.round(x.flip(-1) * 255.0).to(torch.uint8)
    carry = init_analyzer_carry(x.shape[1], x.shape[2], (x.shape[0],), device=x.device)
    _, m = analyze_frame(AnalyzerParams(), carry, frames)
    return m.status, m.anomaly_score, m.mean_brightness, m.entropy


def load_draw(draw: int):
    """``load_cifar10()`` under ``FAV_SYNTH_DRAW=draw``; the variable is put
    back as it was."""
    before = os.environ.get("FAV_SYNTH_DRAW")
    os.environ["FAV_SYNTH_DRAW"] = str(draw)
    try:
        return load_cifar10()
    finally:
        if before is None:
            del os.environ["FAV_SYNTH_DRAW"]
        else:
            os.environ["FAV_SYNTH_DRAW"] = before


def analyze_cells(draws, num_images: int, cells=CELLS, device: str | torch.device | None = None,
                  datasets: dict | None = None) -> list[dict]:
    """One row per draw and cell (the clean row first), with the JAX tool's
    keys and rounding. ``datasets`` maps a draw to its dataset (made by
    :func:`load_draw` where missing); the device is the card by default."""
    dev = resolve_device(device)
    rows = []
    for draw in draws:
        ds = (datasets or {}).get(draw) or load_draw(draw)
        images = torch.from_numpy(ds.test_images[:num_images]).to(dev)
        for name, sev in [(None, 0)] + list(cells):
            batch = images if sev == 0 else cell_batch(images, name, sev)
            status, anomaly, bright, entropy = analyze_batch(batch)
            counts = {s: float((status == i).to(torch.float32).mean()) for i, s in enumerate(STATUS_NAMES)}
            rows.append({
                "draw": draw,
                "cell": "clean" if sev == 0 else f"{name}/{sev}",
                "flag_rate": round(1.0 - counts["VISION_OK"], 4),
                "blank_rate": round(counts["VISION_BLANK"], 4),
                "corrupted_rate": round(counts["VISION_CORRUPTED"], 4),
                "mean_anomaly": round(float(anomaly.mean()), 4),
                "mean_brightness": round(float(bright.mean()), 1),
                "mean_entropy": round(float(entropy.mean()), 2),
            })
    return rows


def markdown(rows: list[dict]) -> str:
    lines = [
        "| draw | cell | L1 flag rate | blank | corrupted | anomaly | brightness | entropy |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['draw']} | {r['cell']} | {r['flag_rate']:.3f} | {r['blank_rate']:.3f} | "
            f"{r['corrupted_rate']:.3f} | {r['mean_anomaly']:.3f} | {r['mean_brightness']:.0f} | "
            f"{r['mean_entropy']:.2f} |"
        )
    return "\n".join(lines)


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--draws", type=str, default="0,1,2")
    p.add_argument("--num-images", type=int, default=512)
    p.add_argument("--json", type=str, default=None)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    rows = analyze_cells([int(d) for d in args.draws.split(",")], args.num_images, device=args.device)
    print(markdown(rows))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"rows": rows, "cells": CELLS}, f, indent=2)
        print(f"\njson -> {args.json}")
    return rows


if __name__ == "__main__":
    main()
