"""Weights bridge between flax parameter trees as numpy arrays and PyTorch
state dicts, both ways, and from ``optax.adamw``'s state to
``torch.optim.AdamW``'s.

The JAX package keeps its checkpoints as orbax trees (``fav_tpu/utils/
checkpoint.py:52-67``), which only JAX and orbax can read. The port keeps
its own copy of the weights it runs as a numpy ``.npz`` under
``fav_tpu_torch/weights/``, one array per flax path (``Conv_0/kernel``,
``ResidualBlock_2/Conv_0/kernel``, ``block_0/MultiHeadDotProductAttention_0/
query/kernel``, ...), beside a copy of the checkpoint's ``metadata.json``;
an ensemble's copy keeps every leaf stacked on a leading member axis.
``tests/test_torch_weights.py`` writes that copy from the orbax checkpoint
(``--write``) and checks that it has not gone stale. :func:`load_weights`
rebuilds whatever model a copy's metadata names.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import torch

from fav_tpu_torch.config import ModelParams, model_params_from_metadata
from fav_tpu_torch.device import resolve_device
from fav_tpu_torch.models.cnn import ConvAutoencoder, create_model

__all__ = [
    "WEIGHTS_DIR", "flax_to_torch", "torch_to_flax", "adamw_state_from_optax", "random_flax_params",
    "load_flax_npz", "save_flax_npz", "load_student", "load_weights", "resolve_copy", "unstack_members",
]

WEIGHTS_DIR = Path(__file__).resolve().parents[1] / "weights"

# flax module kinds numbered per parent (``Conv_3``) and the torch attribute
# holding them (``convs.3``); other path parts (``block_0``, ``mlp_in``,
# ``query``, ``patchify``) keep their names
_MODULE = {"Conv": "convs", "ConvTranspose": "deconvs", "GroupNorm": "norms", "LayerNorm": "lns", "Dense": "dense",
           "ResidualBlock": "blocks", "MultiHeadDotProductAttention": "attns"}
_FLAX = {module: kind for kind, module in _MODULE.items()}
_NUMBERED = re.compile(r"^([A-Za-z]+)_(\d+)$")


def _to_torch_layout(arr: np.ndarray) -> np.ndarray:
    """A kernel's layout in torch: Conv / ConvTranspose HWIO -> OIHW, Dense
    (in, out) -> (out, in); a DenseGeneral kernel (3-D) keeps flax's."""
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    return arr.T if arr.ndim == 2 else arr


def flax_to_torch(params: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Map a flat flax tree (paths joined by ``/``) of any of the port's
    models to its state dict: each numbered module ``Kind_k`` becomes
    ``<attr>.k`` (``Conv_k`` -> ``convs.k``, ``ResidualBlock_k`` ->
    ``blocks.k``, ``LayerNorm_k`` -> ``lns.k``, ...), named modules keep
    their names; ``kernel`` and ``scale`` become ``weight`` (kernels in
    torch's layout: HWIO -> OIHW, (in, out) -> (out, in), DenseGeneral's
    3-D kernels unchanged); top-level parameters (``cls``, ``pos_embed``)
    keep theirs. A leading ``params/`` is ignored; a module kind the port
    does not have (``BatchNorm_0``) or a leaf other than ``kernel``,
    ``scale`` or ``bias`` below a module raises ``KeyError``."""
    out: dict[str, torch.Tensor] = {}
    for path, value in params.items():
        name = path[len("params/"):] if path.startswith("params/") else path
        *mods, leaf = name.split("/")
        parts = []
        for m in mods:
            g = _NUMBERED.match(m)
            if g and g.group(1)[0].isupper():  # a flax-numbered module: its kind must be one the port has
                if g.group(1) not in _MODULE:
                    raise KeyError(f"unexpected parameter path {path!r}")
                parts += [_MODULE[g.group(1)], g.group(2)]
            else:
                parts.append(m)
        arr = np.asarray(value, dtype=np.float32)
        if mods:
            if leaf not in ("kernel", "scale", "bias"):
                raise KeyError(f"unexpected parameter path {path!r}")
            if leaf == "kernel":
                arr = _to_torch_layout(arr)
            leaf = "bias" if leaf == "bias" else "weight"
        out[".".join(parts + [leaf])] = torch.tensor(np.ascontiguousarray(arr))
    return out


def torch_to_flax(state_dict: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The inverse of :func:`flax_to_torch`, float32 numpy: ``<attr>.k`` ->
    ``Kind_k``; a 1-D ``weight`` is a norm's ``scale``, any other
    ``weight`` a ``kernel`` in flax's layout."""
    out: dict[str, np.ndarray] = {}
    for name, value in state_dict.items():
        *mods, leaf = name.split(".")
        arr = value.detach().to("cpu", torch.float32).numpy()
        parts, i = [], 0
        while i < len(mods):
            if mods[i] in _FLAX and i + 1 < len(mods) and mods[i + 1].isdigit():
                parts.append(f"{_FLAX[mods[i]]}_{mods[i + 1]}")
                i += 2
            else:
                parts.append(mods[i])
                i += 1
        if mods and leaf == "weight":
            if arr.ndim == 1:
                leaf = "scale"
            else:
                arr, leaf = (arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T if arr.ndim == 2 else arr), "kernel"
        out["/".join(parts + [leaf])] = np.ascontiguousarray(arr)
    return out


def unstack_members(params: dict[str, np.ndarray]) -> list[dict[str, np.ndarray]]:
    """A stacked flax tree (every leaf with a leading member axis, as
    ``init_ensemble`` and the ensemble checkpoints hold it) -> one flat tree
    per member. Leaves with different member counts raise."""
    counts = {np.shape(v)[0] for v in params.values()}
    if len(counts) != 1:
        raise ValueError(f"leaves disagree on the member axis: {sorted(counts)}")
    return [{k: np.asarray(v)[m] for k, v in params.items()} for m in range(counts.pop())]


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


def resolve_copy(ckpt: str | Path) -> tuple[Path, str] | None:
    """(directory, stem) of a weight copy, or None if there is none: a path
    whose ``.npz`` exists (``.npz`` may be given), else a name under
    ``weights/``."""
    ckpt = str(ckpt)
    path = Path(ckpt[:-4] if ckpt.endswith(".npz") else ckpt)
    for directory, stem in ((path.parent, path.name), (WEIGHTS_DIR, ckpt)):
        if (directory / f"{stem}.npz").is_file():
            return directory, stem
    return None


def load_student(
    name: str = "student_nano",
    device: str | torch.device | None = None,
    directory: str | Path | None = None,
) -> tuple[torch.nn.Module, dict]:
    """The weights ``<directory>/<name>.npz`` (the committed ``weights/`` by
    default) in the classifier rebuilt from ``<name>.metadata.json`` beside
    them (its ``arch``, widths, ViT sizes), on ``device`` (the card unless
    ``"cpu"`` is asked for), in eval mode, computing in bf16. Returns
    ``(model, metadata)``."""
    dev = resolve_device(device)
    root = WEIGHTS_DIR if directory is None else Path(directory)
    meta = json.loads((root / f"{name}.metadata.json").read_text())
    model = create_model(model_params_from_metadata(ModelParams(), meta))
    model.load_state_dict(flax_to_torch(load_flax_npz(root / f"{name}.npz")), strict=True)
    return model.to(dev).eval(), meta


def load_weights(
    name: str,
    device: str | torch.device | None = None,
    directory: str | Path | None = None,
    members: int | None = None,
) -> tuple[torch.nn.Module | list[torch.nn.Module], dict]:
    """Any copy under ``weights/`` (or ``directory``) in the model its
    metadata names, on ``device``, in eval mode: a ``ConvAutoencoder``
    where the metadata says ``model: ConvAutoencoder`` or carries
    ``ae_widths`` (widths and ``ae_latent`` from it); a list of
    ``ensemble_size`` classifiers where the metadata has one (the copy
    holds the members stacked on a leading axis); else one classifier
    (:func:`load_student`). ``members``, if given, is the member count the
    caller expects: a copy with another count raises ``ValueError``, as
    restoring 3 members into a 5-member template must be impossible.
    Returns ``(model or members, metadata)``."""
    dev = resolve_device(device)
    root = WEIGHTS_DIR if directory is None else Path(directory)
    meta = json.loads((root / f"{name}.metadata.json").read_text())
    size = meta.get("ensemble_size")
    if members is not None and members != (size or 1):
        raise ValueError(f"{name}: the copy holds {size or 1} member(s), {members} were asked for")
    params = load_flax_npz(root / f"{name}.npz")
    if meta.get("model") == "ConvAutoencoder" or "ae_widths" in meta:
        widths = tuple(meta.get("ae_widths", (32, 64, 128)))
        model = ConvAutoencoder(widths=widths, latent=int(meta.get("ae_latent", widths[-1])))
        model.load_state_dict(flax_to_torch(params), strict=True)
        return model.to(dev).eval(), meta
    if not size:
        return load_student(name, device=dev, directory=root)
    mp = model_params_from_metadata(ModelParams(), meta)
    stacked = unstack_members(params)
    if len(stacked) != size:
        raise ValueError(f"{name}: the metadata says {size} members, the weights hold {len(stacked)}")
    models = []
    for tree in stacked:
        model = create_model(mp)
        model.load_state_dict(flax_to_torch(tree), strict=True)
        models.append(model.to(dev).eval())
    return models, meta
