"""The port's sharded ensemble training (``models/train.py``,
``models/pretrain.py --shard``) on a gloo CPU world of 2 ranks, against the
port's unsharded step and run.

What is held, and to what:

* a data shard's AugMix views and dropout uniforms are the whole batch's
  rows, exactly (``ensemble_member_views(rows=)``, ``row_masks``);
* the sharded ensemble step, members per rank (mesh ``(1, 2, 1)``, 2
  members) and data parallel (``(2, 1, 1)``, 3 members), plain CE, ``js``
  and ``ce``, a step, and two steps of the data-parallel ``js`` megastep,
  under SGD (16x16 images, batch 8): every parameter and
  metric within rtol 1e-4 and atol 1e-5 of the unsharded step's, the bar
  of ``tests/test_parallel.py:283-315`` (the data shards' gradients are
  summed in another order; a rank runs one thread, so its convolutions
  sum in another order too). The unsharded step is held to ``fav_tpu``'s
  ``make_ensemble_train_step`` through the step-core fixtures of
  ``tests/test_torch_trainers.py``, which feed each member its views;
* ``pretrain --ensemble 2 --shard`` (members per rank) writes weights that
  ``load_weights`` reads back, within rtol 1e-4 and atol 1e-5 of the
  one-rank run's, with its metadata keys; ``pretrain --ensemble 3
  --shard`` (data parallel) prints its mesh, logs every step's member
  losses within ``LOSS_RTOL`` of the one-rank run's, and moves each
  weight leaf from its initialisation as that run does: the norm of the
  difference of the two changes within ``DELTA_GAP`` of the norm of the
  one-rank change. The CLI's forward runs in bfloat16, whose products a
  data shard sums in another order, and AdamW's first steps move a weight
  by about lr in the sign of its gradient, so the weights whose gradient
  lies within that noise move either way: a leaf's gap reads 0.003-0.09
  on the CPU. The conv biases before GroupNorm take a gradient that is
  zero in exact arithmetic, so their whole change is that noise: each is
  held within 2 lr a step instead. A shard that trains on its half of the
  batch alone reads a gap of 1.05 and a step-2 loss 0.022 away; members
  left at their initialisation read 1.0, which the test checks fails.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (REPO, os.path.join(REPO, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from fav_tpu_torch.data.cifar import synthetic_cifar10  # noqa: E402
from fav_tpu_torch.models import pretrain  # noqa: E402
from fav_tpu_torch.models import train as tt  # noqa: E402
from fav_tpu_torch.parallel.dist import CpuWorld  # noqa: E402
from fav_tpu_torch.utils.checkpoint import load_flax_npz, load_weights  # noqa: E402
import torch_parallel_targets as targets  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
PRETRAIN_STEPS, PRETRAIN_LR = 2, 1e-3
ADAMW_ATOL = 2 * PRETRAIN_LR * PRETRAIN_STEPS  # a conv bias before GroupNorm: up to lr a step, either way
LOSS_RTOL = 1e-3
DELTA_GAP = 0.25
# the conv biases before GroupNorm of the (8, 16) CNN: convs 0, 1, 3 and 4
NOISE_LEAVES = tuple(f"Conv_{i}/bias" for i in range(6) if i % 3 != 2)
MEMBERS, DATA = ((1, 2, 1), 2), ((2, 1, 1), 3)  # (mesh, members): members per rank; data parallel
STEP_CASES = {f"{mode}-{name}": dict(shape=shape, members=m, mode=mode, steps=1)
              for mode in ("plain", "js", "ce") for name, (shape, m) in (("members", MEMBERS), ("data", DATA))}
STEP_CASES["js-data-megastep"] = dict(shape=DATA[0], members=DATA[1], mode="js", steps=2, megastep=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The ranks run one thread each, and so does this process, so that a
    loaded machine shares its cores among fewer threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cli_data():
    return synthetic_cifar10(train_size=32, test_size=16)


def _pretrain_argv(members: int, out, steps: int = PRETRAIN_STEPS) -> list[str]:
    return ["--steps", str(steps), "--batch", "8", "--widths", "8,16", "--device", "cpu", "--log-every", "1",
            "--lr", str(PRETRAIN_LR), "--augmix", "--ensemble", str(members), "--out", str(out)]


@pytest.fixture(scope="module")
def world2(cli_data, tmp_path_factory):
    """One call of a world of 2 ranks for every case of this file: the step
    cases and ``pretrain --shard`` at 2 and 3 members."""
    d = tmp_path_factory.mktemp("shard")
    runs = [(_pretrain_argv(m, d / f"s{m}") + ["--shard"], tuple(cli_data[:4])) for m in (2, 3)]
    with CpuWorld(2) as w:
        return d, w.run(targets.world_of_two_training, list(STEP_CASES.values()), runs)


# ── a shard's draws ───────────────────────────────────────────────────────

@pytest.mark.parametrize("mode", ["js", "ce"])
def test_a_shards_views_are_the_whole_batchs_rows(mode):
    x, _ = targets.train_batch(3)
    whole = tt.ensemble_member_views(tt.member_generator(11, 2, "cpu"), x, True, mode)
    rows = slice(2, 6)
    part = tt.ensemble_member_views(tt.member_generator(11, 2, "cpu"), x, True, mode, rows=rows)
    assert len(part) == len(whole) == (2 if mode == "js" else 1)
    for p, w in zip(part, whole):
        assert torch.equal(p, w[rows])


def test_a_shards_dropout_uniforms_are_the_whole_batchs_rows():
    batch, rows = 8, slice(4, 8)
    want = torch.rand((3 * batch, 5, 2), generator=torch.Generator().manual_seed(4)).view(3, batch, 5, 2)
    got = tt.row_masks(torch.Generator().manual_seed(4), batch, rows)((3 * 4, 5, 2))
    assert torch.equal(got, want[:, rows].reshape(12, 5, 2))


def test_member_generators_and_step_seeds_are_distinct():
    seeds = {tt.step_seed(5, i) for i in range(64)}
    assert len(seeds) == 64 and all(0 <= s < 2 ** 63 for s in seeds)
    draws = {float(torch.rand(1, generator=tt.member_generator(5, m, "cpu"))) for m in range(16)}
    assert len(draws) == 16


# ── the sharded step ──────────────────────────────────────────────────────

@pytest.mark.parametrize("case", list(STEP_CASES))
def test_sharded_ensemble_step_is_the_unsharded_step(world2, case):
    spec = STEP_CASES[case]
    got = [out["steps"][list(STEP_CASES).index(case)] for out in world2[1]]
    held = sorted(m for params, _ in got for m in params)
    members = spec["members"]
    assert held == (list(range(members)) if spec["shape"][1] > 1 else [m for m in range(members) for _ in range(2)])
    want_params, want_metrics = targets.ensemble_steps({**spec, "shape": None})
    for params, metrics in got:
        for member, p in params.items():
            for k, v in p.items():
                np.testing.assert_allclose(v, want_params[member][k], rtol=RTOL, atol=ATOL, err_msg=f"{member} {k}")
        assert len(metrics) == len(want_metrics) == spec["steps"]
        for m, w in zip(metrics, want_metrics):
            for k in w:
                np.testing.assert_allclose(m[k], w[k], rtol=RTOL, atol=ATOL, err_msg=k)


# ── pretrain --shard ──────────────────────────────────────────────────────

def _run(argv, data) -> tuple[dict, str]:
    """``pretrain.main(argv)`` in this process: its metadata and what it printed."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        meta = pretrain.main(argv, dataset=data)
    return meta, printed.getvalue()


def _losses(printed: str) -> np.ndarray:
    """The member losses of every logged step: [steps, members]."""
    return np.array([[float(v) for v in ln.split("[")[1].rstrip("]").split(",")]
                     for ln in printed.splitlines() if ln.startswith("step ")])


def _change_gaps(got: dict, want: dict, init: dict) -> dict[str, float]:
    """Per leaf but the noise leaves: ||(got - init) - (want - init)|| over
    ||want - init||."""
    return {k: float(np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k] - init[k]))
            for k in want if k not in NOISE_LEAVES}


def _pretrain_pair(world2, cli_data, members: int):
    """The sharded run's and the one-rank run's weights and printed logs."""
    d, outs = world2
    (meta, printed), (meta1, printed1) = (out["pretrain"][members - 2] for out in outs)
    one, printed_one = _run(_pretrain_argv(members, d / f"o{members}"), cli_data)
    assert meta == meta1 and sorted(meta) == sorted(one)
    assert "weights ->" in printed and "weights ->" not in printed1  # rank 0 alone writes
    models, stored = load_weights(f"s{members}", device="cpu", directory=d)
    assert isinstance(models, list) and len(models) == members and stored == meta
    return load_flax_npz(d / f"s{members}.npz"), load_flax_npz(d / f"o{members}.npz"), printed, printed_one


def test_pretrain_shard_members_per_rank(world2, cli_data):
    got, want, printed, _ = _pretrain_pair(world2, cli_data, 2)
    assert "sharded ensemble training over mesh {'data': 1, 'ensemble': 2, 'model': 1}" in printed
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_pretrain_shard_data_parallel(world2, cli_data):
    got, want, printed, one = _pretrain_pair(world2, cli_data, 3)
    assert "sharded ensemble training over mesh {'data': 2, 'ensemble': 1, 'model': 1}" in printed
    losses, want_losses = _losses(printed), _losses(one)
    assert losses.shape == want_losses.shape == (PRETRAIN_STEPS, 3)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL, atol=0)
    d = world2[0]
    _run(_pretrain_argv(3, d / "i3", steps=0), cli_data)
    init = load_flax_npz(d / "i3.npz")
    gaps = _change_gaps(got, want, init)
    assert max(gaps.values()) <= DELTA_GAP, gaps
    assert max(float(np.abs(got[k] - want[k]).max()) for k in NOISE_LEAVES) <= ADAMW_ATOL
    # the control: members left at their initialisation fail the bound
    assert min(_change_gaps(init, want, init).values()) > DELTA_GAP
