"""Scripted camera streams, one per vision status, made from a seed with numpy.

``chip_smoke.py`` drives the analysis service with them on the card, and
the CPU tests and the committed monitor golden use the same frames, so all
three see identical pixels. Each kind is built to sit well inside one
status of the analyzer (``ops/signal.py``):

* ``ok``: a smooth, quantized texture (sinusoids and a checker, 4-level
  steps) that moves 2 rows and 3 columns a tick: mean brightness near 120,
  entropy about 5-6 bits, mean |frame - prev| far above the 1.0 freeze
  threshold;
* ``frozen``: the same texture, still: identical frames, so FROZEN from
  the sixth frame on;
* ``blank``: dark noise in 0..11, new every tick: mean brightness near 5.5,
  below the 15 blank threshold;
* ``corrupted``: uniform noise in 0..255, new every tick: entropy near 8.0
  bits, above the 7.5 corrupted threshold.
"""

from __future__ import annotations

import numpy as np

__all__ = ["GOLDEN_STREAMS", "MONITOR_STREAMS", "MONITOR_TICKS", "SCRIPTED_KINDS", "scripted_stream"]

SCRIPTED_KINDS = ("ok", "frozen", "blank", "corrupted")
SEED = 20240611

# The monitor run of chip_smoke.py: 32 streams, 8 of each kind, 60 ticks.
MONITOR_TICKS = 60
MONITOR_STREAMS = tuple((kind, i) for kind in SCRIPTED_KINDS for i in range(8))
# The streams whose every frame the committed golden (weights/monitor.golden.json) holds: two of each kind.
GOLDEN_STREAMS = tuple(j for j, (_, i) in enumerate(MONITOR_STREAMS) if i < 2)


def _texture(rng: np.random.Generator, height: int, width: int) -> np.ndarray:
    """A smooth gray texture, uint8 [H, W]; it moves by wrapping rolls."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    f = rng.uniform(12.0, 30.0, 3)
    ph = rng.uniform(0.0, 2.0 * np.pi, 3)
    img = (110.0 + 45.0 * np.sin(xx / f[0] + ph[0]) + 35.0 * np.cos(yy / f[1] + ph[1])
           + 25.0 * np.sin((xx + yy) / f[2] + ph[2]) + 20.0 * ((xx // 40 + yy // 40) % 2))
    return ((np.clip(img, 0.0, 255.0) // 4) * 4).astype(np.uint8)


def scripted_stream(kind: str, stream: int, ticks: int, height: int = 240, width: int = 320) -> np.ndarray:
    """Frames ``0 .. ticks - 1`` of scripted stream ``stream`` of ``kind``:
    uint8 BGR [ticks, H, W, 3]."""
    if kind not in SCRIPTED_KINDS:
        raise ValueError(f"unknown stream kind {kind!r}; expected one of {SCRIPTED_KINDS}")
    rng = np.random.default_rng([SEED, SCRIPTED_KINDS.index(kind), int(stream)])
    if kind == "blank":
        gray = rng.integers(0, 12, (ticks, height, width), dtype=np.uint8)
    elif kind == "corrupted":
        gray = rng.integers(0, 256, (ticks, height, width), dtype=np.uint8)
    else:
        tex = _texture(rng, height, width)
        step = (2, 3) if kind == "ok" else (0, 0)
        gray = np.stack([np.roll(tex, (step[0] * t, step[1] * t), axis=(0, 1)) for t in range(ticks)])
    # equal B, G and R: the gray conversion returns the level itself
    return np.repeat(gray[..., None], 3, axis=-1)
