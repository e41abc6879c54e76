"""The port's CNN, weights bridge and uncertainty scalars against fav_tpu.

The same numpy inputs and the same flax parameters go through
``fav_tpu.models.cnn.FailureAwareCNN.apply`` and
``fav_tpu_torch.models.cnn.FailureAwareCNN``.

Tolerances:

* float32 forward: 1e-4 abs on the logits (the two libraries sum the
  convolutions in other orders; logits are of order 1-10);
* bf16 forward: 0.0625 abs on the logits and at least 99% argmax agreement.
  Both round to bf16 at the same points (a conv or Dense product before its
  bias is added, GroupNorm once after float32 statistics), but sum in other
  orders, so about one activation in 1e5 lands one bf16 step (1/128 relative)
  apart per layer. The reference is the eager flax forward: under ``jit``
  XLA fuses each conv with its bias and skips a rounding, which alone moves
  bf16 logits by up to ~0.1.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fav_tpu import config as jconfig
from fav_tpu.models import uncertainty as juncertainty
from fav_tpu.models.cnn import FailureAwareCNN as JaxCNN
from fav_tpu.models.cnn import standardize_image as jax_standardize
from fav_tpu_torch import config as tconfig
from fav_tpu_torch.models import uncertainty as tuncertainty
from fav_tpu_torch.models.cnn import FailureAwareCNN, create_model, same_pad_stride2, standardize_image
from fav_tpu_torch.utils.checkpoint import WEIGHTS_DIR, flax_to_torch, load_flax_npz, load_student

F32_ATOL = 1e-4
BF16_ATOL = 0.0625
BF16_ARGMAX = 0.99


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v, dtype=np.float32)
    return out


def _nest(flat):
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _images(seed: int, n: int = 32) -> np.ndarray:
    return np.random.default_rng(seed).random((n, 32, 32, 3), dtype=np.float32)


@pytest.fixture(scope="module")
def nano_params():
    return load_flax_npz(WEIGHTS_DIR / "student_nano.npz")


def _small_params(standardize: bool):
    model = JaxCNN(widths=(8, 16), dense_width=32, standardize_input=standardize)
    variables = jax.jit(model.init)(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3), jnp.float32))
    params = _flat(variables["params"])
    # a trained net's GroupNorm affine is not (1, 0): perturb it so the test sees it
    rng = np.random.default_rng(5)
    for k in params:
        if k.startswith("GroupNorm"):
            params[k] = params[k] + rng.normal(0, 0.3, params[k].shape).astype(np.float32)
    return params


# (name, widths, dense_width, standardize_input)
CASES = [
    ("nano", (16, 32, 64), 64, False),
    ("small_std", (8, 16), 32, True),
    ("small_raw", (8, 16), 32, False),
]


def _pair(case, dtype, nano_params):
    name, widths, dense, std = case
    params = nano_params if name == "nano" else _small_params(std)
    jm = JaxCNN(widths=widths, dense_width=dense, standardize_input=std, compute_dtype=dtype)
    tm = FailureAwareCNN(widths=widths, dense_width=dense, standardize_input=std, compute_dtype=dtype)
    tm.load_state_dict(flax_to_torch(params), strict=True)
    return jm, _nest(params), tm.eval()


def _logits(case, dtype, nano_params, images):
    jm, tree, tm = _pair(case, dtype, nano_params)
    want = np.asarray(jm.apply({"params": tree}, jnp.asarray(images)), dtype=np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(images)).numpy()
    return got, want


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_float32_matches_flax(case, nano_params):
    got, want = _logits(case, "float32", nano_params, _images(1))
    assert got.dtype == np.float32 and got.shape == (32, 10)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_bf16_matches_flax(case, nano_params):
    got, want = _logits(case, "bfloat16", nano_params, _images(2, 64))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= BF16_ARGMAX


def test_flax_to_torch_maps_the_nano_tree(nano_params):
    sd = flax_to_torch(nano_params)
    assert len(sd) == len(nano_params) == 34
    assert sum(v.numel() for v in sd.values()) == 125_834
    k = nano_params["Conv_1/kernel"]  # HWIO (3, 3, 16, 16)
    np.testing.assert_array_equal(sd["convs.1.weight"].numpy(), k.transpose(3, 2, 0, 1))
    assert sd["convs.0.weight"].shape == (16, 3, 3, 3)
    np.testing.assert_array_equal(sd["dense.0.weight"].numpy(), nano_params["Dense_0/kernel"].T)
    assert sd["dense.1.weight"].shape == (10, 64)
    np.testing.assert_array_equal(sd["norms.5.weight"].numpy(), nano_params["GroupNorm_5/scale"])
    np.testing.assert_array_equal(sd["norms.5.bias"].numpy(), nano_params["GroupNorm_5/bias"])
    # the whole state dict loads strictly into the model the metadata describes
    FailureAwareCNN(widths=(16, 32, 64), dense_width=64).load_state_dict(sd, strict=True)


def test_flax_to_torch_accepts_params_prefix_and_refuses_strangers(nano_params):
    prefixed = {f"params/{k}": v for k, v in nano_params.items()}
    assert sorted(flax_to_torch(prefixed)) == sorted(flax_to_torch(nano_params))
    with pytest.raises(KeyError):
        flax_to_torch({"BatchNorm_0/scale": np.ones(3, np.float32)})


def test_load_student_rebuilds_the_nano_model():
    model, meta = load_student("student_nano", device="cpu")
    assert model.widths == (16, 32, 64) and model.dense[0].out_features == 64
    assert meta["arch"] == "vgg" and not model.training
    assert next(model.parameters()).dtype == torch.float32
    assert model.compute_dtype == torch.bfloat16


@pytest.mark.parametrize("size,pad", [(32, (0, 1)), (16, (0, 1)), (8, (0, 1)), (4, (0, 1)), (7, (1, 1)), (5, (1, 1))])
def test_stride2_same_padding(size, pad):
    """flax SAME with stride 2 pads (0, 1) on even sizes; torch's padding=1
    would pad (1, 1)."""
    assert same_pad_stride2(size) == pad


def test_stride2_conv_matches_flax_same():
    """One stride-2 SAME conv, 32 -> 16, in float32: (0, 1) padding then a
    valid conv reproduces flax exactly (to float32 summation order)."""
    import flax.linen as nn
    import torch.nn.functional as F

    x = _images(7, 4)[..., :3]
    conv = nn.Conv(5, (3, 3), strides=(2, 2), padding="SAME")
    params = jax.jit(conv.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(conv.apply({"params": params}, jnp.asarray(x)), np.float32)
    w = torch.from_numpy(np.asarray(params["kernel"], np.float32).transpose(3, 2, 0, 1).copy())
    b = torch.from_numpy(np.array(params["bias"], np.float32))
    h = F.pad(torch.from_numpy(x).permute(0, 3, 1, 2), (0, 1, 0, 1))
    got = F.conv2d(h, w, b, stride=2).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (4, 16, 16, 5)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    wrong = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), w, b, stride=2, padding=1)
    assert np.abs(wrong.permute(0, 2, 3, 1).numpy() - want).max() > 1e-2


def test_standardize_image_matches_flax():
    """Population std (ddof 0), floor 1e-3; a flat image hits the floor."""
    x = _images(8, 6)
    x[0] = 0.25
    got = standardize_image(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_standardize(jnp.asarray(x)), np.float32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.all(got[0] == 0.0)


def test_model_params_copy_equals_fav_tpu():
    assert dataclasses.asdict(tconfig.ModelParams()) == dataclasses.asdict(jconfig.ModelParams())
    meta = {"arch": "vgg", "widths": [16, 32, 64], "dense_width": 64, "standardize_input": True}
    t = tconfig.model_params_from_metadata(tconfig.ModelParams(), meta)
    j = jconfig.model_params_from_metadata(jconfig.ModelParams(), meta)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tconfig.model_params_from_metadata(tconfig.ModelParams(), {}) == tconfig.ModelParams()


def test_create_model_refuses_unported_archs():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        create_model(tconfig.ModelParams(arch="resnet"))
    model = create_model(tconfig.ModelParams(widths=(8,), dense_width=16))
    assert model(torch.zeros(2, 32, 32, 3)).shape == (2, 10)


def test_msp_and_anomaly_match_fav_tpu():
    logits = np.random.default_rng(9).normal(0, 3, (64, 10)).astype(np.float32)
    conf_j = np.asarray(jnp.max(jax.nn.softmax(jnp.asarray(logits), axis=-1), axis=-1), np.float32)
    conf_t = tuncertainty.msp(torch.from_numpy(logits)).numpy()
    np.testing.assert_allclose(conf_t, conf_j, atol=1e-6, rtol=0)
    grid = np.linspace(0, 1, 101, dtype=np.float32)
    for floor, scale in ((0.6, 2.5), (0.5, 1.0)):
        want = np.asarray(juncertainty.anomaly_from_confidence(jnp.asarray(grid), floor, scale), np.float32)
        got = tuncertainty.anomaly_from_confidence(torch.from_numpy(grid), floor, scale).numpy()
        np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
