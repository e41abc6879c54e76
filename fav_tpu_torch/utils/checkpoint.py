"""Weights bridge between flax parameter trees as numpy arrays and PyTorch
state dicts, both ways, and from ``optax.adamw``'s state to
``torch.optim.AdamW``'s.

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

__all__ = [
    "WEIGHTS_DIR", "flax_to_torch", "torch_to_flax", "adamw_state_from_optax", "random_flax_params",
    "load_flax_npz", "save_flax_npz", "load_student",
]

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


_FLAX = {module: kind for kind, module in _MODULE.items()}


def torch_to_flax(state_dict: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The inverse of :func:`flax_to_torch`: ``convs.k.weight`` OIHW ->
    ``Conv_k/kernel`` HWIO, ``dense.k.weight`` (out, in) -> ``Dense_k/kernel``
    (in, out), ``norms.k.weight`` -> ``GroupNorm_k/scale``, float32 numpy."""
    out: dict[str, np.ndarray] = {}
    for name, value in state_dict.items():
        module, idx, leaf = name.split(".")
        kind = _FLAX[module]
        arr = value.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            if kind == "Conv":
                arr, leaf = arr.transpose(2, 3, 1, 0), "kernel"
            elif kind == "Dense":
                arr, leaf = arr.T, "kernel"
            else:
                leaf = "scale"
        out[f"{kind}_{idx}/{leaf}"] = np.ascontiguousarray(arr)
    return out


def adamw_state_from_optax(optimizer: torch.optim.AdamW, model: torch.nn.Module, mu: dict[str, np.ndarray],
                           nu: dict[str, np.ndarray], count: int) -> None:
    """Load ``optax.adamw``'s first and second moments (``mu``, ``nu``: flat
    flax paths -> numpy, as the parameters) and its step ``count`` into
    ``optimizer``, an AdamW over ``model.parameters()``, as ``exp_avg``,
    ``exp_avg_sq`` and ``step``. The two optimizers' updates are then the
    same algebra from the same state (optax's bias corrections use count + 1,
    torch's its step after the increment)."""
    m, v = flax_to_torch(mu), flax_to_torch(nu)
    names = {id(p): n for n, p in model.named_parameters()}
    params = optimizer.param_groups[0]["params"]
    if len(optimizer.param_groups) != 1 or {id(p) for p in params} != set(names):
        raise ValueError("adamw_state_from_optax: the optimizer must hold exactly the model's parameters")
    sd = optimizer.state_dict()
    sd["state"] = {
        i: {"step": torch.tensor(float(count)), "exp_avg": m[names[id(p)]].clone(),
            "exp_avg_sq": v[names[id(p)]].clone()}
        for i, p in enumerate(params)
    }
    optimizer.load_state_dict(sd)


def random_flax_params(model: torch.nn.Module, seed: int) -> dict[str, np.ndarray]:
    """A flat flax tree for ``model`` drawn with numpy from ``seed``: kernels
    normal with variance 1 / fan_in, biases and GroupNorm affines near their
    initial values but not at them, so a test sees every leaf. The tests and
    ``chip_smoke.py`` remake the same parameters from the same seed."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, arr in sorted(torch_to_flax(model.state_dict()).items()):
        if path.endswith("/kernel"):
            fan_in = int(np.prod(arr.shape[:-1]))
            out[path] = rng.normal(0.0, (1.0 / fan_in) ** 0.5, arr.shape).astype(np.float32)
        elif path.endswith("/scale"):
            out[path] = (1.0 + rng.normal(0.0, 0.1, arr.shape)).astype(np.float32)
        else:
            out[path] = rng.normal(0.0, 0.05, arr.shape).astype(np.float32)
    return out


def load_flax_npz(path: str | Path) -> dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def save_flax_npz(path: str | Path, params: dict[str, np.ndarray]) -> None:
    """One array per flax path, the layout :func:`load_flax_npz` reads."""
    with open(path, "wb") as f:
        np.savez(f, **params)


def load_student(
    name: str = "student_nano",
    device: str | torch.device | None = None,
    directory: str | Path | None = None,
) -> tuple[FailureAwareCNN, dict]:
    """The weights ``<directory>/<name>.npz`` (the committed ``weights/`` by
    default) in a model rebuilt from ``<name>.metadata.json`` beside them,
    on ``device`` (the card unless ``"cpu"`` is asked for), in eval mode,
    computing in bf16. Returns ``(model, metadata)``."""
    dev = resolve_device(device)
    root = WEIGHTS_DIR if directory is None else Path(directory)
    meta = json.loads((root / f"{name}.metadata.json").read_text())
    mp = model_params_from_metadata(ModelParams(), meta)
    model = create_model(mp)
    model.load_state_dict(flax_to_torch(load_flax_npz(root / f"{name}.npz")), strict=True)
    return model.to(dev).eval(), meta
