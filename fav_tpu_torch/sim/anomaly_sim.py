"""ML anomaly-score simulator — heuristic stand-in for AE reconstruction MSE.

The port's copy of ``fav_tpu/sim/anomaly_sim.py``: the same ``random.Random``
seeding, so seeds 42 and 99 give ``fav_tpu``'s streams exactly
(``tests/test_torch_host.py``).

Parity target: ``platform/backend/anomaly_simulator.py``. Produces scores
matching the reference's distribution model: baseline 0.019 +- gauss(0,5e-4)
(anomaly_simulator.py:22-24,49), noise term 0.015*noise^1.5 (:52), brightness
term 0.008*dev^2 (:55-56), sinusoidal drift 0.001*sin(0.05 t) (:59), and the
status signatures — FROZEN halves the base error, BLANK collapses to ~0.005
(the documented AE blind spot, :65-70), CORRUPTED triples it plus jitter
(:71-73). Seeded via ``random.Random`` so streams are bit-identical to the
reference for the same seed (the reference seeds 42 for streaming and 99 for
the playground, main.py:112,327).

This simulator backs *simulation mode* only; live scoring comes from the
models on the card (:mod:`fav_tpu_torch.serving.inference`).
"""

from __future__ import annotations

import math
import random

from fav_tpu_torch.config import AnomalySimParams


class AnomalySimulator:
    """Deterministic anomaly-score generator (no ML dependency)."""

    def __init__(self, seed: int | None = None, params: AnomalySimParams | None = None):
        self.params = params or AnomalySimParams()
        self.reset(seed)

    def reset(self, seed: int | None = None) -> None:
        self._rng = random.Random(seed)
        self._t = 0.0

    def compute_anomaly(self, noise_level: float, brightness: float, vision_status: str) -> float:
        p = self.params
        self._t += 1

        base = p.baseline_normal + self._rng.gauss(0, p.baseline_jitter)
        noise_term = p.noise_gain * (noise_level**p.noise_exponent)
        brightness_term = p.brightness_gain * (abs(brightness - 0.5) ** 2)
        drift = p.drift_gain * math.sin(self._t * p.drift_freq)

        if vision_status == "VISION_FROZEN":
            return max(p.floor, base * p.frozen_factor + drift)
        if vision_status == "VISION_BLANK":
            return max(p.floor, p.blank_base + self._rng.gauss(0, p.blank_jitter))
        if vision_status == "VISION_CORRUPTED":
            return base * p.corrupted_factor + noise_term + self._rng.gauss(0, p.corrupted_jitter)

        return max(p.floor, base + noise_term + brightness_term + drift)
