"""What the ranks of the parallel tests run: each target is
``fn(world, *args)`` on every rank of a gloo CPU world
(``fav_tpu_torch.parallel.dist.CpuWorld``) and returns numpy arrays and
plain Python values. The module imports torch, numpy and the port only, so
that a spawned rank starts without JAX. Each test file makes one call of
a target with all its cases, so that a world's ranks do their work in one
round: on a loaded machine each wait for the slowest rank costs."""

from __future__ import annotations

import contextlib
import copy
import io
import os

import numpy as np
import torch

from fav_tpu_torch.models.cnn import FailureAwareCNN, init_params
from fav_tpu_torch.parallel import mesh as pm
from fav_tpu_torch.parallel import sweep as psweep

# the small model and batch of the grid and the ensemble step: 16x16
# images, which every family, the L1 pass and the CNN take
SIZE = 16
WIDTHS = (8, 16)
BATCH = 8
TRAIN_LR = 1e-2
SWEEP_SEED = 9
SWEEP_ROWS = ("conf", "correct", "fail", "entropy", "brier", "anomaly", "energy", "l1_status", "l1_anomaly")


def small_cnn(seed: int = 0) -> FailureAwareCNN:
    model = FailureAwareCNN(widths=WIDTHS, dense_width=16, compute_dtype="float32")
    return init_params(model, torch.Generator().manual_seed(seed))


def sweep_inputs(seed: int = 1):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((BATCH, SIZE, SIZE, 3), dtype=np.float32))
    y = torch.from_numpy((np.arange(BATCH) % 10).astype(np.int64))
    return x, y


def _members(model, k: int):
    """Stacked logits of ``k`` copies of ``model`` with scaled heads: a
    forward of member logits [M, B, C], as an ensemble's."""
    heads = []
    for i in range(k):
        m = copy.deepcopy(model)
        with torch.no_grad():
            m.dense[1].weight.mul_(1.0 + 0.5 * i)
        heads.append(m)
    return lambda x: torch.stack([m(x) for m in heads])


def _sweep_kw(case: dict) -> dict:
    kw = dict(seed=SWEEP_SEED, corruptions=case["names"], severities=case["sevs"])
    if case["fused"]:
        kw["return_rows"] = SWEEP_ROWS + (("mi", "agree") if case.get("members") else ())
    return kw


def _forward(case: dict):
    model = small_cnn().eval()
    return model, (_members(model, case["members"]) if case.get("members") else model)


def _host(out, fused: bool):
    if fused:
        results, cells, rows = out
        return results, cells, {k: np.asarray(v) for k, v in rows.items()}
    return out


def run_sweep_cases(world, cases: list[dict]):
    """``sharded_sweep`` for each case (``shape``; ``multislice``: 2 slices
    of ``shape``; ``names``, ``sevs``, ``fused``, ``members``,
    ``cells_per_call``); this rank's results of each."""
    x, y = sweep_inputs()
    out = []
    for case in cases:
        model, forward = _forward(case)
        shape = case["shape"]
        mesh = pm.build_multislice_mesh(2, shape) if case.get("multislice") else pm.build_mesh(shape)
        got = psweep.sharded_sweep(mesh, forward, x, y, fused=case["fused"], params=list(model.parameters()),
                                   cells_per_call=case.get("cells_per_call", 0), **_sweep_kw(case))
        out.append(_host(got, case["fused"]))
    return out


def unsharded_sweep(case: dict):
    """The case's grid on the whole batch in one process, in one chunk."""
    x, y = sweep_inputs()
    _, forward = _forward(case)
    if case["fused"]:
        return _host(psweep.fused_sweep(forward, x, y, **_sweep_kw(case)), True)
    return psweep.corruption_sweep(forward, x, y, **_sweep_kw(case))


def sweep_refusals(world):
    """The errors of ``sharded_sweep``'s argument checks, by name."""
    model = small_cnn().eval()
    x, y = sweep_inputs()
    mesh = pm.build_mesh()
    out = {}
    for label, kw in (("monitor", dict(monitor=(model, 1.0))), ("return_rows", dict(return_rows=("conf",))),
                      ("both", dict(fused=True, return_probs=True, monitor=(model, 1.0))),
                      ("probs_rows", dict(fused=True, return_probs=True, return_rows=("conf",)))):
        try:
            psweep.sharded_sweep(mesh, model, x, y, 9, ("contrast",), (1,), **kw)
            out[label] = None
        except ValueError as e:
            out[label] = str(e)
    # parameters that differ between ranks are refused on entry
    other = small_cnn(seed=world.rank).eval()
    try:
        psweep.sharded_sweep(mesh, other, x, y, 9, ("contrast",), (1,), params=list(other.parameters()))
        out["unreplicated"] = None
    except ValueError as e:
        out["unreplicated"] = str(e)
    return out


def run_evaluate(world, argv: list, data: tuple):
    """``evaluate.main(argv)`` on every rank (on the CPU) over the synthetic
    set ``data``."""
    from fav_tpu_torch.data.cifar import Dataset
    from fav_tpu_torch.models import evaluate

    os.environ[evaluate.DEVICE_ENV] = "cpu"
    return evaluate.main(argv, dataset=Dataset(*data, source="synthetic"))


def world_of_two_sweeps(world, cases: list[dict], argvs: list[list], data: tuple):
    """Everything the sweep file's world of 2 runs: the grid cases, the
    argument checks and the evaluate CLI on each of ``argvs``."""
    return {"sweeps": run_sweep_cases(world, cases), "refusals": sweep_refusals(world),
            "evaluate": [run_evaluate(world, argv, data) for argv in argvs]}


def run_tp_vit(world, cases: list[tuple]):
    """For each case ``(shape, vit_kw, state, x)``: the tensor-parallel ViT
    on the mesh of ``shape``, this rank's data rows through its shard, the
    logits gathered over ``data``, and its query kernel's shape."""
    from fav_tpu_torch.models.vit import VisionTransformer, tensor_parallel_vit

    out = []
    for shape, vit_kw, state, x in cases:
        model = VisionTransformer(**vit_kw)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
        mesh = pm.build_mesh(shape)
        local = tensor_parallel_vit(model.eval(), mesh)
        rows = pm.data_sharding(mesh, x.shape[0])
        with torch.no_grad():
            logits = local(torch.from_numpy(x[rows]))
        q = local.block_0.attns[0].query.weight
        out.append((pm.all_gather_rows(logits, mesh, "data").numpy(), tuple(q.shape)))
    return out


def train_states(members: int):
    """``members`` members of the small CNN from one generator (as
    ``init_ensemble`` draws them), each with plain SGD."""
    from fav_tpu_torch.models.train import TrainState
    from fav_tpu_torch.models.uncertainty import init_ensemble

    ms = init_ensemble(small_cnn(), torch.Generator().manual_seed(0), members)
    return [TrainState(m, torch.optim.SGD(m.parameters(), lr=TRAIN_LR)) for m in ms]


def train_batch(step: int):
    rng = np.random.default_rng(100 + step)
    x = torch.from_numpy(rng.random((BATCH, SIZE, SIZE, 3), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 10, BATCH).astype(np.int64))
    return x, y


def ensemble_steps(case: dict):
    """``steps`` ensemble steps (``mode`` plain, js or ce) of ``members``
    SGD members, sharded over the mesh of ``shape`` where it is not None,
    per step or as one ``megastep``; each held member's parameters by
    absolute index and the metrics of every step."""
    from fav_tpu_torch.models import train as tt

    mode, members, steps = case["mode"], case["members"], case["steps"]
    kw = dict(augmix=mode != "plain", augmix_mode="js" if mode == "plain" else mode)
    states, mesh, first = train_states(members), None, 0
    if case.get("shape") is not None:
        mesh = pm.build_mesh(case["shape"])
        keep = pm.ensemble_sharding(mesh, members)
        states, first = states[keep], keep.start
    seeds = [tt.step_seed(5, i) for i in range(steps)]
    if case.get("megastep"):
        xs, ys = zip(*(train_batch(i) for i in range(steps)))
        idx = np.arange(steps * BATCH).reshape(steps, BATCH)
        mega = tt.make_ensemble_megastep(device="cpu", mesh=mesh, **kw)
        _, m = mega(states, torch.cat(xs), torch.cat(ys), idx, seeds)
        metrics = [{k: v[i].numpy() for k, v in m.items()} for i in range(steps)]
    else:
        metrics = []
        for i in range(steps):
            x, y = train_batch(i)
            m = tt.ensemble_train_step(states, x, y, seeds[i], mesh=mesh, **kw)
            metrics.append({k: v.numpy() for k, v in m.items()})
    params = {first + j: {k: v.detach().numpy().copy() for k, v in st.model.state_dict().items()}
              for j, st in enumerate(states)}
    return params, metrics


def run_pretrain(argv: list, data: tuple):
    """``pretrain.main(argv)`` over the synthetic set ``data`` (its train
    and test images and labels): its metadata and what it printed."""
    from fav_tpu_torch.data.cifar import Dataset
    from fav_tpu_torch.models import pretrain

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        meta = pretrain.main(argv, dataset=Dataset(*data, source="synthetic"))
    return meta, printed.getvalue()


def world_of_two_training(world, cases: list[dict], runs: list[tuple]):
    """Everything the training file's world of 2 runs: the ensemble step
    cases and the ``pretrain`` runs ``(argv, data)``."""
    return {"steps": [ensemble_steps(case) for case in cases],
            "pretrain": [run_pretrain(argv, data) for argv, data in runs]}


def mesh_layout(world):
    """This rank's place on a (2, 2, 1) mesh and a 2-slice mesh of (2, 1, 1),
    its rows of a batch of 8, its members of 2, and the mean and gather
    collectives on them."""
    mesh = pm.build_mesh((2, 2, 1))
    mean = pm.all_reduce_mean(torch.full((3,), float(world.rank)), mesh, "data")
    gathered = pm.all_gather_rows(torch.tensor([float(world.rank)]), mesh, "ensemble")
    rows, members = pm.data_sharding(mesh, 8), pm.ensemble_sharding(mesh, 2)
    ms = pm.build_multislice_mesh(2, (2, 1, 1))
    ms_rows = pm.hierarchical_data_sharding(ms, 8)
    ms_gathered = pm.all_gather_rows(torch.tensor([float(world.rank)]), ms, ms.batch_axes)
    try:
        mesh.group(("data", "ensemble"))
        no_joint = False
    except ValueError:
        no_joint = True
    try:
        pm.hierarchical_data_sharding(mesh, 8)
        not_ms = False
    except ValueError:
        not_ms = True
    return {"shape": mesh.shape, "coords": mesh.coords, "rows": (rows.start, rows.stop),
            "members": (members.start, members.stop), "replicate": (0, pm.replicate(mesh, 8).stop),
            "stacked": pm.shard_params_for_ensemble(mesh, {"w": np.arange(2)})["w"].tolist(),
            "listed": pm.shard_params_for_ensemble(mesh, ["m0", "m1"]),
            "mean": mean.numpy(), "gathered": gathered.numpy(), "ms_shape": ms.shape,
            "ms_rows": (ms_rows.start, ms_rows.stop), "ms_gathered": ms_gathered.numpy(),
            "no_joint_group": no_joint, "not_multislice": not_ms}


def world_of_four(world, sweep_cases: list[dict]):
    """Everything the world of 4 runs: the mesh layout, the dry run on this
    world (``dryrun_multichip(4)`` on a joined world, as under
    ``torchrun``) and the multi-slice grid cases."""
    from fav_tpu_torch.parallel.dryrun import dryrun_multichip

    return {"layout": mesh_layout(world), "dryrun": dryrun_multichip(4),
            "sweeps": run_sweep_cases(world, sweep_cases)}


def assert_same_grid(got, want, fused: bool, tol: float) -> None:
    """A sharded grid against the whole batch's: the metrics within
    ``tol``; fused, the cells and every per-sample row bit for bit."""
    results = got[0] if fused else got
    want_results = want[0] if fused else want
    assert sorted(results) == sorted(want_results)
    for name in want_results:
        assert sorted(results[name]) == sorted(want_results[name])
        for sev, cell in want_results[name].items():
            assert sorted(results[name][sev]) == sorted(cell)
            for k, v in cell.items():
                assert abs(results[name][sev][k] - v) <= tol, (name, sev, k)
    if fused:
        assert got[1] == want[1] and sorted(got[2]) == sorted(want[2])
        for r, v in want[2].items():
            np.testing.assert_array_equal(got[2][r], v, err_msg=r)
