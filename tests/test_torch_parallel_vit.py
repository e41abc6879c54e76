"""The port's tensor-parallel ViT (``models/vit.py:tp_shard_vit_params``,
``tensor_parallel_vit``) against ``fav_tpu.models.vit``'s forward, on a
gloo CPU world of 2 ranks.

The same flax parameters (``random_flax_params`` over the port's state
dict, mapped by the weights bridge, as ``tests/test_torch_vit.py`` makes
them) go through ``fav_tpu``'s jitted ``VisionTransformer`` (vit_dim 32,
depth 2, heads 4, MLP 64, float32, dropout 0) and through each rank's
shard. What is held, and to what:

* on a ``model`` axis of 2 (mesh ``(1, 1, 2)``) and on a ``data`` axis of
  2 (``(2, 1, 1)``, the logits gathered): within 2e-5 of ``fav_tpu``'s
  logits, the bar of ``tests/test_parallel.py:359-392``; the query
  kernels hold 2 of the 4 heads on the model axis;
* in bf16 compute on the model axis of 2: within ``BF16_ATOL`` of the
  port's plain bf16 forward, argmax equal (a row-parallel product is
  summed in float32 and rounded once, where the whole product rounds once
  after its own float32 sum);
* ``tp_shard_vit_params``: the shards of every rank put back together are
  the state dict; heads that do not divide the model axis are refused.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (REPO, os.path.join(REPO, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from fav_tpu.models.vit import VisionTransformer as JaxViT  # noqa: E402
from fav_tpu_torch.models.vit import VisionTransformer, tp_shard_vit_params  # noqa: E402
from fav_tpu_torch.parallel.dist import CpuWorld  # noqa: E402
from fav_tpu_torch.utils.checkpoint import flax_to_torch, random_flax_params  # noqa: E402
from test_torch_resnet_ae import images, nest  # noqa: E402
import torch_parallel_targets as targets  # noqa: E402

TP_ATOL = 2e-5
BF16_ATOL = 0.0625
SMALL = dict(dim=32, depth=2, heads=4, mlp_dim=64, dropout_rate=0.0)


def _state(dtype: str):
    port = VisionTransformer(**SMALL, compute_dtype=dtype)
    params = random_flax_params(port, 5)
    state = flax_to_torch(params)
    port.load_state_dict(state, strict=True)
    return port.eval(), params, {k: v.numpy() for k, v in state.items()}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The ranks run one thread each, and so does this process, so that a
    loaded machine shares its cores among fewer threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def float32_case():
    _, params, state = _state("float32")
    x = images(40)
    want = np.asarray(jax.jit(JaxViT(**SMALL, compute_dtype="float32").apply)(nest(params), jnp.asarray(x)),
                      np.float32)
    return x, state, want


@pytest.fixture(scope="module")
def bf16_case():
    port, _, state = _state("bfloat16")
    x = images(41)
    with torch.no_grad():
        want = port(torch.from_numpy(x)).numpy()
    return x, state, want


SHAPES = {"model": (1, 1, 2), "data": (2, 1, 1)}


@pytest.fixture(scope="module")
def world2(float32_case, bf16_case):
    """One call of a world of 2 ranks: float32 on each mesh, then bf16 on
    the model axis."""
    f32 = {**SMALL, "compute_dtype": "float32"}
    cases = [(shape, f32, float32_case[1], float32_case[0]) for shape in SHAPES.values()]
    cases.append((SHAPES["model"], {**SMALL, "compute_dtype": "bfloat16"}, bf16_case[1], bf16_case[0]))
    with CpuWorld(2) as w:
        return w.run(targets.run_tp_vit, cases)


@pytest.mark.parametrize("axis", list(SHAPES))
def test_tensor_parallel_vit_equals_fav_tpus_forward(world2, float32_case, axis):
    want = float32_case[2]
    for out in world2:
        logits, q_shape = out[list(SHAPES).index(axis)]
        np.testing.assert_allclose(logits, want, rtol=0, atol=TP_ATOL)
        assert q_shape == ((32, 2, 8) if axis == "model" else (32, 4, 8))


def test_bf16_tensor_parallel_vit_is_in_the_bf16_class(world2, bf16_case):
    want = bf16_case[2]
    for out in world2:
        logits, _ = out[-1]
        assert np.abs(logits - want).max() <= BF16_ATOL
        np.testing.assert_array_equal(logits.argmax(-1), want.argmax(-1))


class _ModelAxis:
    """A mesh's ``model`` axis seen from rank ``t`` of ``size``."""

    def __init__(self, t: int, size: int):
        self.t, self.n = t, size

    def index(self, axes):
        return self.t if axes == "model" else 0

    def size(self, axes):
        return self.n if axes == "model" else 1


def test_shards_put_back_together_are_the_state_dict():
    _, _, state = _state("float32")
    state = {k: torch.from_numpy(v) for k, v in state.items()}
    shards = [tp_shard_vit_params(_ModelAxis(t, 2), state) for t in range(2)]
    for k, v in state.items():
        parts = [s[k] for s in shards]
        if ".attns.0." in k and not k.endswith("out.bias") and k.split(".")[-2] in ("query", "key", "value"):
            whole = torch.cat(parts, dim=1 if k.endswith("weight") else 0)
        elif k.endswith("attns.0.out.weight") or ".mlp_in." in k:
            whole = torch.cat(parts, dim=0)
        elif k.endswith("mlp_out.weight"):
            whole = torch.cat(parts, dim=1)
        else:
            assert all(torch.equal(p, v) for p in parts), k
            continue
        assert parts[0].shape != v.shape and torch.equal(whole, v), k
    with pytest.raises(ValueError, match="do not split"):
        tp_shard_vit_params(_ModelAxis(0, 3), state)
    with pytest.raises(ValueError, match="do not split"):
        VisionTransformer(**SMALL, model_shards=3)
