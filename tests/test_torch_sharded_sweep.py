"""The port's sharded grid (``parallel/sweep.py:sharded_sweep``) and the
sharded evaluate CLI on a gloo CPU world of 2 ranks, against the port's
unsharded grid on the whole batch (the 2-slice mesh of 4 ranks is in
``tests/test_torch_mesh.py``).

What is held, and to what (``fav_tpu``'s bar is
``tests/test_parallel.py:212-254``: metrics within 3e-5):

* the fused grid, all fifteen families in chunks of 4 cells, and with an
  ensemble's stacked member logits: every per-sample row bit for bit,
  every metric within ``METRIC_TOL`` of the one-chunk unsharded grid;
  every rank returns the same results;
* the per-cell grid: metrics within ``METRIC_TOL`` of
  ``corruption_sweep``;
* the argument checks: ``monitor`` and ``return_rows`` without ``fused``
  and the mutually exclusive outputs raise ``fav_tpu``'s ``ValueError``
  texts; parameters that differ between ranks are refused;
* ``evaluate`` on 2 ranks (``--policy``, ``--mc-dropout 3``, ``--tta
  3``): the same grid as on one rank, ``devices`` 2 in its summary; a
  shard's MC-dropout replicas are the whole batch's rows, exactly, also
  where the replicas take several forwards.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (REPO, os.path.join(REPO, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from fav_tpu.parallel import mesh as jmesh  # noqa: E402
from fav_tpu.parallel import sweep as jsweep  # noqa: E402
from fav_tpu_torch.data.cifar import synthetic_cifar10  # noqa: E402
from fav_tpu_torch.models import evaluate as tev  # noqa: E402
from fav_tpu_torch.ops.corruptions import CORRUPTION_NAMES  # noqa: E402
from fav_tpu_torch.parallel.dist import CpuWorld  # noqa: E402
import torch_parallel_targets as targets  # noqa: E402

CASES = {
    "fused": dict(shape=(2, 1, 1), names=CORRUPTION_NAMES, sevs=(3,), fused=True, cells_per_call=4),
    "members": dict(shape=(2, 1, 1), names=("shot_noise", "snow"), sevs=(2,), fused=True, members=3),
    "per_cell": dict(shape=(2, 1, 1), names=("gaussian_noise", "glass_blur", "fog"), sevs=(5,), fused=False),
}
METRIC_TOL = 3e-5
_EVALUATE = ["--num-images", "8", "--corruptions", "gaussian_noise,contrast", "--checkpoint", "student_nano"]
EVALUATE = {"policy": [*_EVALUATE, "--policy", "--policy-ticks", "30"],
            "mc_dropout": [*_EVALUATE, "--mc-dropout", "3"],
            "tta": [*_EVALUATE, "--tta", "3"]}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The ranks run one thread each, and so does this process, so that a
    loaded machine shares its cores among fewer threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return synthetic_cifar10(train_size=32, test_size=24)


@pytest.fixture(scope="module")
def world2(data):
    """One call of a world of 2 ranks for every case of this file."""
    with CpuWorld(2) as w:
        return w.run(targets.world_of_two_sweeps, list(CASES.values()), list(EVALUATE.values()), tuple(data[:4]))


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_grid_equals_the_whole_batchs(world2, case):
    i = list(CASES).index(case)
    want = targets.unsharded_sweep(CASES[case])
    fused = CASES[case]["fused"]
    for got in world2:
        targets.assert_same_grid(got["sweeps"][i], want, fused, METRIC_TOL)
    results = [got["sweeps"][i][0] if fused else got["sweeps"][i] for got in world2]
    assert results[0] == results[1]


def _jax_message(**kw) -> str:
    mesh = jmesh.build_mesh((8, 1, 1))
    x, y = jnp.zeros((8, 32, 32, 3)), jnp.zeros(8, jnp.int32)
    with pytest.raises(ValueError) as exc:
        jsweep.sharded_sweep(mesh, None, {}, x, y, jax.random.PRNGKey(0), ("contrast",), (1,), **kw)
    return str(exc.value)


def test_argument_checks_match_fav_tpu(world2):
    for got in world2:
        out = got["refusals"]
        assert out["monitor"] == _jax_message(monitor=(None, {}, 1.0))
        assert out["return_rows"] == _jax_message(return_rows=("conf",))
        assert out["both"] == _jax_message(fused=True, return_probs=True, monitor=(None, {}, 1.0))
        assert out["probs_rows"] == _jax_message(fused=True, return_probs=True, return_rows=("conf",))
        assert "hold other parameters" in out["unreplicated"]


@pytest.mark.parametrize("case", list(EVALUATE))
def test_evaluate_on_two_ranks_is_the_one_rank_grid(world2, data, monkeypatch, case):
    monkeypatch.setenv(tev.DEVICE_ENV, "cpu")
    want = tev.main(EVALUATE[case], dataset=data)
    for got in world2:
        out = got["evaluate"][list(EVALUATE).index(case)]
        assert out["grid"] == want["grid"] and out["per_corruption"] == want["per_corruption"]
        assert out["summary"]["devices"] == 2 and want["summary"]["devices"] == 1
        assert {k: v for k, v in out["summary"].items() if k != "devices"} == \
            {k: v for k, v in want["summary"].items() if k != "devices"}


@pytest.mark.parametrize("max_rows", [0, 16])
def test_a_shards_mc_dropout_replicas_are_the_whole_batchs_rows(max_rows):
    """``mc_dropout_logits`` on rows [4, 8) of a batch of 8 with the
    shard's uniforms (``row_masks``) and the whole batch's fold (5 replicas
    in one forward, or 2 a forward at 16 rows): the whole call's rows,
    exactly."""
    from fav_tpu_torch.models.train import row_masks
    from fav_tpu_torch.models.uncertainty import mc_dropout_logits

    model = targets.small_cnn()
    x, _ = targets.sweep_inputs()
    rows = slice(4, 8)
    whole = mc_dropout_logits(model, x, torch.Generator().manual_seed(7), 5, max_rows=max_rows)
    g = torch.Generator().manual_seed(7)
    part = mc_dropout_logits(model, x[rows], g, 5, masks=row_masks(g, 8, rows), max_rows=max_rows, batch=8)
    assert torch.equal(part, whole[:, rows])
