"""The device mesh and what each rank holds of it (``fav_tpu/parallel/mesh.py``).

A mesh names the world's ranks along three axes, as ``fav_tpu``'s does:

    data      -- batch and grid parallelism (a rank holds a slice of rows)
    ensemble  -- deep-ensemble members, member per rank where sizes divide
    model     -- tensor parallelism of the ViT (``models/vit.py``)

and, on a multi-slice mesh, an outermost ``dcn`` axis: the grid shards its
batch over ``("dcn", "data")`` so that only the per-sample rows of its
gather cross slices. Ranks are laid out row-major over the shape, as
``fav_tpu`` reshapes its device list.

JAX places a global array with a ``NamedSharding`` and lets XLA insert the
collectives. Here the math is explicit: :func:`data_sharding` and the other
placements return what this rank holds (its rows of a batch, its members),
and the callers reduce and gather with named collectives over the mesh's
per-axis process groups (:meth:`Mesh.group`). Nothing uses DTensor, DDP or
FSDP, so each reduction is written where it happens.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from fav_tpu_torch.config import MeshParams

__all__ = [
    "DCN_AXIS",
    "Mesh",
    "auto_mesh_shape",
    "build_mesh",
    "build_multislice_mesh",
    "data_sharding",
    "hierarchical_data_sharding",
    "ensemble_sharding",
    "replicate",
    "shard_params_for_ensemble",
    "all_reduce_mean",
    "all_gather_rows",
]

DCN_AXIS = "dcn"


def auto_mesh_shape(n_devices: int, ensemble_size: int = 1) -> tuple[int, int, int]:
    """(data, ensemble, model) sizes for ``n_devices`` ranks: the ensemble
    axis takes the largest divisor of n that divides ``ensemble_size``
    (member per rank where possible), the data axis the rest; model 1."""
    ens = math.gcd(n_devices, ensemble_size) if ensemble_size > 1 else 1
    return (n_devices // ens, ens, 1)


class Mesh:
    """A ``DeviceMesh`` with named axes, this rank's coordinates on it, and
    the process group of each axis; ``batch_axes`` are the axes a batch
    shards over (``("data",)``, or ``("dcn", "data")`` on a multi-slice
    mesh), whose joint group :meth:`group` also gives."""

    def __init__(self, device_mesh: DeviceMesh, axis_names: tuple[str, ...], batch_axes: tuple[str, ...],
                 batch_group=None):
        self.device_mesh = device_mesh
        self.axis_names = axis_names
        self.batch_axes = batch_axes
        self._batch_group = batch_group
        grid = device_mesh.mesh.numpy()
        self.shape = {name: int(n) for name, n in zip(axis_names, grid.shape)}
        where = np.argwhere(grid == dist.get_rank())[0]
        self.coords = {name: int(i) for name, i in zip(axis_names, where)}

    def size(self, axes: str | Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def index(self, axes: str | Sequence[str]) -> int:
        """This rank's place along ``axes`` taken jointly, the first outermost."""
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes: str | Sequence[str]):
        """The process group of the ranks that differ from this one only
        along ``axes`` (one axis, or the batch axes jointly)."""
        axes = _axes(axes)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if axes != self.batch_axes or self._batch_group is None:
            raise ValueError(f"no joint group of axes {axes} on this mesh")
        return self._batch_group

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _world_size(world_size: int | None) -> int:
    return dist.get_world_size() if world_size is None else int(world_size)


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def build_mesh(shape: Sequence[int] | None = None, params: MeshParams | None = None,
               world_size: int | None = None) -> Mesh:
    """The (data, ensemble, model) mesh over the world; by default every
    rank on the data axis. Raises ``ValueError`` where the shape does not
    hold the world's ranks (``world_size`` checks a shape with no world)."""
    p = params or MeshParams()
    n = _world_size(world_size)
    if shape is None:
        shape = (n, 1, 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
    names = (p.data_axis, p.ensemble_axis, p.model_axis)
    dm = init_device_mesh(_device_type(), tuple(int(s) for s in shape), mesh_dim_names=names)
    return Mesh(dm, names, (p.data_axis,))


def build_multislice_mesh(n_slices: int, per_slice_shape: Sequence[int] | None = None,
                          params: MeshParams | None = None, world_size: int | None = None) -> Mesh:
    """The 4-axis mesh ``(dcn, data, ensemble, model)``, ``dcn`` outermost:
    consecutive ranks form a slice. A batch shards over ``("dcn", "data")``
    jointly, whose group is made here."""
    p = params or MeshParams()
    n = _world_size(world_size)
    if n % n_slices:
        raise ValueError(f"{n} devices do not split into {n_slices} slices")
    per = n // n_slices
    if per_slice_shape is None:
        per_slice_shape = (per, 1, 1)
    if int(np.prod(per_slice_shape)) != per:
        raise ValueError(f"per-slice shape {tuple(per_slice_shape)} != {per} devices/slice")
    names = (DCN_AXIS, p.data_axis, p.ensemble_axis, p.model_axis)
    shape = (n_slices, *(int(s) for s in per_slice_shape))
    dm = init_device_mesh(_device_type(), shape, mesh_dim_names=names)
    # the joint (dcn, data) group of each (ensemble, model) coordinate, made
    # by every rank in the same order as new_group requires
    grid = dm.mesh.numpy().reshape(n_slices * shape[1], -1)
    mine = None
    for col in range(grid.shape[1]):
        ranks = [int(r) for r in grid[:, col]]
        g = dist.new_group(ranks)
        if dist.get_rank() in ranks:
            mine = g
    return Mesh(dm, names, (DCN_AXIS, p.data_axis), mine)


def _rows(n: int, shards: int, index: int, what: str) -> slice:
    if n % shards:
        raise ValueError(f"{what} of {n} does not split into {shards} equal shards")
    per = n // shards
    return slice(index * per, (index + 1) * per)


def data_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a batch of ``n`` sharded over the mesh's batch
    axes (``data``, or ``("dcn", "data")`` on a multi-slice mesh)."""
    return _rows(n, mesh.size(mesh.batch_axes), mesh.index(mesh.batch_axes), "a batch")


def hierarchical_data_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a batch of ``n`` over ``("dcn", "data")``, the
    slice axis outermost (multi-slice meshes only)."""
    if DCN_AXIS not in mesh.shape:
        raise ValueError("hierarchical_data_sharding needs a multi-slice mesh")
    return data_sharding(mesh, n)


def ensemble_sharding(mesh: Mesh, members: int) -> slice:
    """The members this rank holds of an ensemble of ``members``."""
    return _rows(members, mesh.size("ensemble"), mesh.index("ensemble"), "an ensemble")


def replicate(mesh: Mesh, n: int) -> slice:
    """All ``n``: a replicated tensor is whole on every rank."""
    return slice(0, n)


def shard_params_for_ensemble(mesh: Mesh, stacked):
    """This rank's members of stacked member parameters: a dict of arrays
    with a leading member axis (``{path: [M, ...]}``) or a list of member
    modules."""
    if isinstance(stacked, dict):
        m = len(next(iter(stacked.values())))
        keep = ensemble_sharding(mesh, m)
        return {k: v[keep] for k, v in stacked.items()}
    return list(stacked)[ensemble_sharding(mesh, len(stacked))]


def all_reduce_mean(t: torch.Tensor, mesh: Mesh, axes: str | Sequence[str]) -> torch.Tensor:
    """``t`` summed over the ranks along ``axes`` and divided by their
    number, in place; also returned. The collective runs on an axis of one
    rank too, so a world of one drives the path it shards."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group(axes))
    return t.div_(mesh.size(axes))


def all_gather_rows(t: torch.Tensor, mesh: Mesh, axes: str | Sequence[str], dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` along ``axes``, concatenated along ``dim`` in their
    order along the axes: the whole of a tensor sharded there (each rank's
    shard the same shape)."""
    parts = [torch.empty_like(t) for _ in range(mesh.size(axes))]
    dist.all_gather(parts, t.contiguous(), group=mesh.group(axes))
    return torch.cat(parts, dim=dim)
