"""Vision-state simulator — maps UI controls to a vision status.

The port's copy of ``fav_tpu/sim/vision_sim.py``.

Parity target: ``platform/backend/vision_simulator.py``. Explicit failure
modes dominate over noise/brightness sliders (vision_simulator.py:38-51);
slider values clamp to [0, 1] (vision_simulator.py:30-36).
"""

from __future__ import annotations

_MODE_TO_STATUS = {
    "frozen": "VISION_FROZEN",
    "blank": "VISION_BLANK",
    "corrupted": "VISION_CORRUPTED",
    "normal": "VISION_OK",
}

VALID_MODES = frozenset(_MODE_TO_STATUS)


class VisionSimulator:
    """Holds UI-driven fake-camera state for simulation mode."""

    VALID_MODES = VALID_MODES

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.mode = "normal"
        self.noise_level = 0.0
        self.brightness = 0.5

    def set_mode(self, mode: str) -> None:
        if mode in VALID_MODES:
            self.mode = mode

    def set_noise(self, level: float) -> None:
        self.noise_level = min(1.0, max(0.0, level))

    def set_brightness(self, level: float) -> None:
        self.brightness = min(1.0, max(0.0, level))

    def get_vision_status(self) -> str:
        return _MODE_TO_STATUS.get(self.mode, "VISION_OK")

    def get_frame_descriptor(self) -> dict:
        return {
            "mode": self.mode,
            "noise_level": self.noise_level,
            "brightness": self.brightness,
            "vision_status": self.get_vision_status(),
        }
