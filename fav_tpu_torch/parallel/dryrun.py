"""The multi-device dry run: one sharded step of each parallel path
(``__graft_entry__.py:dryrun_multichip``, :96-220).

    python -m fav_tpu_torch.parallel.dryrun --devices 4              # 4 gloo ranks on the CPU
    torchrun --nproc-per-node 4 -m fav_tpu_torch.parallel.dryrun --devices 4   # 4 cards, NCCL

Over ``n`` ranks it runs

* one AugMix ensemble train step of a small CNN over the mesh
  ``auto_mesh_shape(n, 2 if n is even else 1)``: members on the
  ``ensemble`` axis, the batch of 16 on ``data``;
* where n is even, the tensor-parallel ViT (dim 16, depth 1, 2 heads) over
  a ``(n / 2, 1, 2)`` mesh, its heads and MLP width on ``model``;
* where n >= 4 and even, the fused grid (``gaussian_noise`` at severity 3)
  sharded over ``("dcn", "data")`` of a 2-slice mesh;

and asserts what the JAX dry run asserts. With no world joined it spawns
``n`` gloo ranks on the CPU, as JAX provisions ``n`` virtual CPU devices;
under ``torchrun`` it runs on the world's ranks, one card each.
"""

from __future__ import annotations

import argparse
import os

import torch

from fav_tpu_torch.parallel.dist import CpuWorld, World, current_world, destroy_world, init_world

__all__ = ["dryrun_multichip", "dryrun_rank", "main"]

BATCH = 16
HW = 32


def _check(cond: bool, msg) -> None:
    if not cond:
        raise AssertionError(msg)


def dryrun_rank(world: World, n_devices: int) -> dict:
    """The dry run on this rank of a world of at least ``n_devices``
    ranks; returns what it checked."""
    from fav_tpu_torch.config import ModelParams
    from fav_tpu_torch.models.cnn import create_model, init_params
    from fav_tpu_torch.models.train import create_train_state, ensemble_train_step
    from fav_tpu_torch.models.uncertainty import init_ensemble
    from fav_tpu_torch.models.vit import tensor_parallel_vit
    from fav_tpu_torch.parallel.mesh import (all_gather_rows, auto_mesh_shape, build_mesh, build_multislice_mesh,
                                             data_sharding, ensemble_sharding)
    from fav_tpu_torch.parallel.sweep import sharded_sweep

    if world.size < n_devices:
        raise RuntimeError(f"need {n_devices} ranks, the world has {world.size}")
    if world.size != n_devices:
        raise RuntimeError(f"the dry run takes the whole world: {n_devices} ranks asked for, {world.size} joined")
    dev = world.device
    out: dict = {}

    # member per rank where the ensemble divides n, data parallel otherwise;
    # 2 members keep both axes busy for any even n
    ensemble_size = 2 if n_devices % 2 == 0 else 1
    shape = auto_mesh_shape(n_devices, ensemble_size)
    mesh = build_mesh(shape)
    model = create_model(ModelParams(widths=(8, 16), dense_width=16, compute_dtype="float32"))
    members = init_ensemble(model.to(dev), torch.Generator(device=dev).manual_seed(0), ensemble_size)
    states = [create_train_state(m, 1e-3) for m in members[ensemble_sharding(mesh, ensemble_size)]]
    images = torch.zeros((BATCH, HW, HW, 3), device=dev)
    labels = torch.zeros(BATCH, dtype=torch.int64, device=dev)
    # augmix=True: the on-device augmentation (K9a/K9b on the card) on each
    # rank's rows inside the same sharded step
    metrics = ensemble_train_step(states, images, labels, 1, augmix=True, mesh=mesh)
    _check(metrics["loss"].shape == (ensemble_size,), metrics["loss"].shape)
    _check(all(st.step == 1 for st in states), [st.step for st in states])
    _check(bool(torch.isfinite(metrics["loss"]).all()), metrics["loss"])
    out["train_mesh"] = mesh.shape

    # tensor parallelism: the ViT's heads and MLP width on a model axis of 2
    if n_devices % 2 == 0:
        tp_mesh = build_mesh((n_devices // 2, 1, 2))
        vit = create_model(ModelParams(arch="vit", vit_dim=16, vit_depth=1, vit_heads=2, dropout_rate=0.0,
                                       compute_dtype="float32"))
        vit = init_params(vit.to(dev), torch.Generator(device=dev).manual_seed(2)).eval()
        local = tensor_parallel_vit(vit, tp_mesh)
        vx = torch.zeros((8, HW, HW, 3), device=dev)
        with torch.no_grad():
            logits = all_gather_rows(local(vx[data_sharding(tp_mesh, 8)]), tp_mesh, "data")
        _check(tuple(logits.shape) == (8, 10), logits.shape)
        out["tp_mesh"] = tp_mesh.shape

    # multi-slice: the grid's batch over ("dcn", "data") of a 2-slice mesh
    if n_devices >= 4 and n_devices % 2 == 0:
        ms_mesh = build_multislice_mesh(2, (n_devices // 2, 1, 1))
        _check(ms_mesh.axis_names[0] == "dcn", ms_mesh.axis_names)
        sweep_model = create_model(ModelParams(widths=(8, 16), dense_width=16, compute_dtype="float32"))
        sweep_model = init_params(sweep_model.to(dev), torch.Generator(device=dev).manual_seed(3)).eval()
        grid = sharded_sweep(ms_mesh, sweep_model, torch.zeros((BATCH, HW, HW, 3), device=dev),
                             torch.zeros(BATCH, dtype=torch.int64, device=dev), 4, corruptions=("gaussian_noise",),
                             severities=(3,), fused=True, params=list(sweep_model.parameters()))
        acc = grid["gaussian_noise"][3]["accuracy"]
        _check(0.0 <= acc <= 1.0, acc)
        out["multislice_mesh"] = ms_mesh.shape
    return out


def dryrun_multichip(n_devices: int, timeout: float = 300.0) -> list[dict]:
    """The dry run over ``n_devices`` ranks: this world's, if this process
    joined one (the results of this rank, in a list), else ``n_devices``
    gloo ranks spawned on the CPU (every rank's results)."""
    world = current_world()
    if world is not None:
        return [dryrun_rank(world, n_devices)]
    with CpuWorld(n_devices, timeout) as cpu:
        return cpu.run(dryrun_rank, n_devices)


def main(argv: list[str] | None = None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--devices", type=int, default=int(os.environ.get("WORLD_SIZE", "0") or 0) or 2)
    p.add_argument("--device", type=str, default=None,
                   help="under torchrun: 'cpu' for gloo ranks on the host; the card (NCCL) by default")
    args = p.parse_args(argv)
    joined = "WORLD_SIZE" in os.environ and current_world() is None
    rank = init_world(args.device).rank if joined else 0
    try:
        out = dryrun_multichip(args.devices)
    finally:
        if joined:
            destroy_world()
    if rank == 0:
        print(f"dryrun_multichip({args.devices}) OK: {out[0]}")
    return out


if __name__ == "__main__":
    main()
