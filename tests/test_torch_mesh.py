"""The port's mesh (``fav_tpu_torch/parallel/mesh.py``) and the grid's
shard offsets, against ``fav_tpu/parallel/mesh.py`` and the whole batch.

What is held, and to what:

* ``auto_mesh_shape`` equals ``fav_tpu``'s for 1-8 devices and ensembles
  of 1-6; ``build_mesh`` and ``build_multislice_mesh`` refuse what
  ``fav_tpu``'s refuse (``tests/test_parallel.py:40-55,257-263``), with
  the same messages;
* every family of the grid on a shard at row ``r`` with its offset equals
  rows ``r ..`` of the whole batch's call, exactly (the plain versions, as
  a CPU tensor takes them; the kernels are held to them on the card by
  ``chip_smoke.py`` phase 16); so do the uniforms of every draw shape, and
  an offset that is not a whole group of four is refused;
* on a gloo world of 4: each rank's coordinates, rows, members and
  groups, and the mean and gather collectives, exactly; the grid sharded
  over a 2-slice mesh, its rows bit for bit and its metrics within 3e-5
  of the whole batch's;
* ``dryrun_multichip(2)`` passes on 2 gloo CPU ranks it spawns, and
  ``dryrun_multichip(4)`` on the world of 4 (a joined world).
"""

from __future__ import annotations

import os
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (REPO, os.path.join(REPO, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from fav_tpu.parallel import mesh as jmesh  # noqa: E402
from fav_tpu_torch.ops import corruptions as tc  # noqa: E402
from fav_tpu_torch.ops import corruptions_cuda as cuda_ops  # noqa: E402
from fav_tpu_torch.ops.random import random_words  # noqa: E402
from fav_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from fav_tpu_torch.parallel.dist import CpuWorld  # noqa: E402
from fav_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
import torch_parallel_targets as targets  # noqa: E402

METRIC_TOL = 3e-5
SEED = 12345


@pytest.mark.parametrize("n", range(1, 9))
def test_auto_mesh_shape_is_fav_tpus(n):
    for ens in range(1, 7):
        assert tmesh.auto_mesh_shape(n, ens) == jmesh.auto_mesh_shape(n, ens), (n, ens)


def _message(fn) -> str:
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


def test_mesh_validation_matches_fav_tpu():
    """On 8 devices (the JAX tests' virtual CPU devices, a world of 8 here)."""
    assert jax.device_count() == 8
    assert (_message(lambda: tmesh.build_mesh((3, 1, 1), world_size=8))
            == _message(lambda: jmesh.build_mesh((3, 1, 1))))
    assert (_message(lambda: tmesh.build_multislice_mesh(3, world_size=8))
            == _message(lambda: jmesh.build_multislice_mesh(n_slices=3)))
    assert (_message(lambda: tmesh.build_multislice_mesh(2, (3, 1, 1), world_size=8))
            == _message(lambda: jmesh.build_multislice_mesh(n_slices=2, per_slice_shape=(3, 1, 1))))


# ── the shard offsets ─────────────────────────────────────────────────────

@pytest.mark.parametrize("name", tc.CORRUPTION_NAMES)
def test_family_on_a_shard_equals_the_whole_batchs_rows(name):
    x = torch.from_numpy(np.random.default_rng(3).random((6, 16, 16, 3), dtype=np.float32))
    fn = cuda_ops.grid_corruption_fn(name)
    whole = fn(SEED, x, 3)
    for row in (1, 2, 5):
        part = fn(SEED, x[row:].contiguous(), 3, row=row)
        assert torch.equal(part, whole[row:]), (name, row)
    assert torch.equal(tc.grid_corruption_fn(name)(SEED, x[4:].contiguous(), 3, row=4), whole[4:])


@pytest.mark.parametrize("tail", [(32, 32, 3), (32, 32, 1), (32, 32, 2), (2, 2, 1), (4, 4, 1), (16, 16, 1)])
def test_uniforms_at_an_offset_are_the_whole_fields_rows(tail):
    for draw in (0, 1, 4):
        whole = tc.uniform_field(SEED, (6, *tail), draw)
        assert torch.equal(tc.uniform_field(SEED, (3, *tail), draw, row=3), whole[3:])
        assert torch.equal(cuda_ops.uniform(SEED, (2, *tail), draw, "cpu", row=4), whole[4:])


def test_words_and_counter_bases():
    words = random_words(7, 64, draw=2)
    assert torch.equal(random_words(7, 20, draw=2, offset=8), words[8:28])
    assert torch.equal(random_words(7, 64, draw=2, offset=0), words)
    with pytest.raises(ValueError, match="multiple of 4"):
        random_words(7, 8, offset=6)
    with pytest.raises(ValueError, match="multiple of 4"):  # a 3x3x1 draw from row 1: 9 elements
        tc.uniform_field(SEED, (2, 3, 3, 1), 0, row=1)
    assert cuda_ops._base(0, 3072) == 0 and cuda_ops._base(5, 3072) == 5 * 3072 // 4
    with pytest.raises(ValueError, match="multiple of 4"):
        cuda_ops._base(1, 9)


# ── a world of 4: placements, collectives, the dry run, the multi-slice grid

MULTISLICE = [dict(shape=(2, 1, 1), multislice=True, names=("gaussian_noise", "zoom_blur", "elastic_transform"),
                   sevs=(2,), fused=fused) for fused in (True, False)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The ranks run one thread each, and so does this process, so that a
    loaded machine shares its cores among fewer threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world4():
    """One call of a world of 4 ranks for every case of this file."""
    with CpuWorld(4) as w:
        return w.run(targets.world_of_four, MULTISLICE)


def test_mesh_coordinates_rows_members_and_groups(world4):
    for rank, got in enumerate(world4):
        out = got["layout"]
        d, e = divmod(rank, 2)
        assert out["shape"] == {"data": 2, "ensemble": 2, "model": 1}
        assert out["coords"] == {"data": d, "ensemble": e, "model": 0}
        assert out["rows"] == (4 * d, 4 * d + 4) and out["members"] == (e, e + 1)
        assert out["replicate"] == (0, 8)
        assert out["stacked"] == [e] and out["listed"] == [f"m{e}"]
        # the mean over data and the gather over ensemble
        np.testing.assert_array_equal(out["mean"], np.full(3, (e + (2 + e)) / 2.0))
        np.testing.assert_array_equal(out["gathered"], np.array([2 * d, 2 * d + 1], np.float32))
        # the multi-slice mesh: dcn outermost, the batch over (dcn, data)
        assert out["ms_shape"] == {"dcn": 2, "data": 2, "ensemble": 1, "model": 1}
        assert out["ms_rows"] == (2 * rank, 2 * rank + 2)
        np.testing.assert_array_equal(out["ms_gathered"], np.arange(4, dtype=np.float32))
        assert out["no_joint_group"] and out["not_multislice"]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_cell"])
def test_multislice_sharded_grid_equals_the_whole_batchs(world4, fused):
    """A 2-slice mesh of (2, 1, 1), the batch over ("dcn", "data"): the
    fused rows bit for bit, every metric within ``METRIC_TOL``
    (``tests/test_parallel.py:231-254``)."""
    i = [c["fused"] for c in MULTISLICE].index(fused)
    want = targets.unsharded_sweep(MULTISLICE[i])
    for got in world4:
        targets.assert_same_grid(got["sweeps"][i], want, fused, METRIC_TOL)


def test_dryrun_multichip_2():
    """On 2 gloo CPU ranks that the dry run spawns itself."""
    out = dryrun_multichip(2)
    assert len(out) == 2
    assert out[0] == {"train_mesh": {"data": 1, "ensemble": 2, "model": 1},
                      "tp_mesh": {"data": 1, "ensemble": 1, "model": 2}}


def test_dryrun_multichip_4(world4):
    """On the world of 4 (a joined world, as under ``torchrun``)."""
    for got in world4:
        assert got["dryrun"] == [{"train_mesh": {"data": 2, "ensemble": 2, "model": 1},
                                  "tp_mesh": {"data": 2, "ensemble": 1, "model": 2},
                                  "multislice_mesh": {"dcn": 2, "data": 2, "ensemble": 1, "model": 1}}]
