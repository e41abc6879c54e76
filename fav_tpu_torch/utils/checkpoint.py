"""Weights bridge: flax parameter trees as numpy arrays -> PyTorch state dicts.

The JAX package keeps its checkpoints as orbax trees (``fav_tpu/utils/
checkpoint.py:52-67``), which only JAX and orbax can read. The port keeps
its own copy of the weights it runs as a numpy ``.npz`` under
``fav_tpu_torch/weights/``, one array per flax path (``Conv_0/kernel``, ...),
beside a copy of the checkpoint's ``metadata.json``.
``tests/test_torch_weights.py`` writes that copy from the orbax checkpoint
(``--write``) and checks that it has not gone stale.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import torch

from fav_tpu_torch.config import ModelParams, model_params_from_metadata
from fav_tpu_torch.device import resolve_device
from fav_tpu_torch.models.cnn import FailureAwareCNN, create_model

__all__ = ["WEIGHTS_DIR", "flax_to_torch", "load_flax_npz", "load_student"]

WEIGHTS_DIR = Path(__file__).resolve().parents[1] / "weights"

_PATH = re.compile(r"^(Conv|GroupNorm|Dense)_(\d+)/(kernel|bias|scale)$")
_MODULE = {"Conv": "convs", "GroupNorm": "norms", "Dense": "dense"}


def flax_to_torch(params: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Map a flat flax tree of ``FailureAwareCNN`` to its state dict:
    ``Conv_k/kernel`` HWIO -> ``convs.k.weight`` OIHW, ``Dense_k/kernel``
    (in, out) -> ``dense.k.weight`` (out, in), ``GroupNorm_k/scale`` ->
    ``norms.k.weight``; biases keep their shape. A leading ``params/`` is
    ignored; any other path raises ``KeyError``."""
    out: dict[str, torch.Tensor] = {}
    for path, value in params.items():
        name = path[len("params/"):] if path.startswith("params/") else path
        m = _PATH.match(name)
        if m is None:
            raise KeyError(f"unexpected parameter path {path!r}")
        kind, idx, leaf = m.groups()
        arr = np.asarray(value, dtype=np.float32)
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if kind == "Conv" else arr.T
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        out[f"{_MODULE[kind]}.{idx}.{leaf}"] = torch.tensor(arr)
    return out


def load_flax_npz(path: str | Path) -> dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def load_student(
    name: str = "student_nano",
    device: str | torch.device | None = None,
) -> tuple[FailureAwareCNN, dict]:
    """The committed weights ``weights/<name>.npz`` in a model rebuilt from
    ``weights/<name>.metadata.json``, on ``device`` (the card unless
    ``"cpu"`` is asked for), in eval mode, computing in bf16. Returns
    ``(model, metadata)``."""
    dev = resolve_device(device)
    meta = json.loads((WEIGHTS_DIR / f"{name}.metadata.json").read_text())
    mp = model_params_from_metadata(ModelParams(), meta)
    model = create_model(mp)
    model.load_state_dict(flax_to_torch(load_flax_npz(WEIGHTS_DIR / f"{name}.npz")), strict=True)
    return model.to(dev).eval(), meta
