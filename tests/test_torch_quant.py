"""The port's W8A8 quantisation (``fav_tpu_torch/models/quant.py``) against
``fav_tpu/models/quant.py``, on the CPU, at widths (8, 16), dense 16, with
parameters from a numpy seed and 16 images.

Tolerance classes:

* the float mirror against the port's own ``FailureAwareCNN``: exact, in
  float32 and in bf16 (the same ops in the same order);
* the float mirror against ``fav_tpu``'s, jitted: float32 within 1e-4
  (the forwards' class in ``tests/test_torch_models.py``), bf16 within
  0.0625 (measured 0.003) with argmax equal on every image whose top two
  logits lie further apart than twice that;
* the float32 amaxes of the calibration forward: 1e-5 relative
  (reassociation); ``calibrate_cnn``'s bf16 scales within one bf16 step
  (2^-7 relative): ``fav_tpu`` calibrates under ``jax.jit``, where XLA
  fuses a conv with its bias and skips a bf16 rounding that the port, like
  flax's eager forward, keeps;
* ``quantize_cnn``'s int8 kernels and weight scales: exact (the same
  float32 division and round half to even);
* both int8 convolutions (``im2col`` through ``torch._int_mm``, ``conv``
  through a float64 convolution) against ``fav_tpu``'s ``_conv_im2col_int8``
  and XLA's int8 conv on the same int8 tensors: exact, bit for bit;
* ``quantized_forward`` fed ``fav_tpu``'s own ``QuantizedCNN`` through
  ``from_flax_quantized``: the bf16 class above, argmax equal;
* the port's quantised ``student_nano`` on the eight golden images of
  ``weights/student_nano.golden.json`` against ``weights/quant.golden.json``
  (``fav_tpu``'s, calibrated on the same images): the activation scales
  within one bf16 step, and, under ``fav_tpu``'s scales (a scale one step
  off moves whole int8 levels), the int8 logits within
  ``QUANT_GOLDEN_ATOL`` (0.125, the nano golden's logit bound) with every
  argmax equal. ``chip_smoke.py`` holds the card to the same golden,
  there with the argmax held where the golden's top two logits lie more
  than twice the bound apart, as for the float golden.

Run as a script with ``--write`` to regenerate ``weights/quant.golden.json``
from the orbax checkpoint:

    JAX_PLATFORMS=cpu python tests/test_torch_quant.py --write
"""

from __future__ import annotations

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from fav_tpu.models import quant as jq  # noqa: E402
from test_torch_models import _nest  # noqa: E402

GOLDEN = os.path.join(REPO, "fav_tpu_torch", "weights", "quant.golden.json")
QUANT_GOLDEN_ATOL = 0.125


def jax_nano_quant_golden() -> dict:
    """``fav_tpu``'s quantised ``student_nano`` on the nano golden's eight
    images, calibrated on the same images: its activation scales and its
    int8 logits by both algorithms (equal), beside its bf16 float logits."""
    from test_torch_weights import golden_images, restore_nano

    params, meta = restore_nano("student_nano")
    variables = {"params": _nest(params)}
    widths = tuple(meta["widths"])
    x = jnp.asarray(golden_images())
    q = jq.quantize_cnn(variables, x, widths)
    conv = np.asarray(jq.quantized_forward(q, x, "conv"), np.float32)
    im2col = np.asarray(jq.quantized_forward(q, x, "im2col"), np.float32)
    assert np.array_equal(conv, im2col)
    return {
        "about": "fav_tpu's quantize_cnn of fav_tpu/checkpoints/student_nano, calibrated on the images of "
                 "student_nano.golden.json, and quantized_forward on them; written by tests/test_torch_quant.py "
                 "--write",
        "images": "student_nano.golden.json (seed, shape)",
        "calibration": "the same eight images",
        "widths": list(widths),
        "act_scales": np.asarray(q.act_scales, np.float32).tolist(),
        "logits": conv.tolist(),
        "fp_logits": np.asarray(jq.functional_forward(variables, x, widths), np.float32).tolist(),
    }


if __name__ == "__main__":
    if "--write" not in sys.argv[1:]:
        sys.exit("usage: python tests/test_torch_quant.py --write")
    jax.config.update("jax_platforms", "cpu")
    with open(GOLDEN, "w") as f:
        json.dump(jax_nano_quant_golden(), f, indent=1)
        f.write("\n")
    sys.exit(0)

import pytest  # noqa: E402
import torch  # noqa: E402

from fav_tpu_torch.models import quant as tq  # noqa: E402
from fav_tpu_torch.models.cnn import FailureAwareCNN  # noqa: E402
from fav_tpu_torch.utils.checkpoint import WEIGHTS_DIR, flax_to_torch, load_student, random_flax_params  # noqa: E402

WIDTHS = (8, 16)
DENSE = 16
B = 16
F32_ATOL = 1e-4
BF16_ATOL = 0.0625
AMAX_RTOL = 1e-5
BF16_STEP = 2.0 ** -7


def _port(dtype: str = "bfloat16", standardize: bool = False, seed: int = 3) -> FailureAwareCNN:
    model = FailureAwareCNN(widths=WIDTHS, dense_width=DENSE, compute_dtype=dtype, standardize_input=standardize)
    model.load_state_dict(flax_to_torch(random_flax_params(model, seed)), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def toy():
    """(port bf16 model, port float32 model, fav_tpu variables, images):
    one parameter tree for both packages."""
    flat = random_flax_params(_port(), 3)
    x = np.random.default_rng(0).random((B, 32, 32, 3), dtype=np.float32)
    return _port(), _port("float32"), {"params": _nest(flat)}, x


@pytest.fixture(scope="module")
def jax_quant(toy):
    _, _, variables, x = toy
    return jq.quantize_cnn(variables, jnp.asarray(x), WIDTHS)


@pytest.fixture(scope="module")
def jax_fp(toy):
    """``fav_tpu``'s mirror under ``jit`` (one compile each, where the eager
    walk compiles op by op; on these images the jitted bf16 logits lie
    0.003 from the eager ones): float32 logits and the calibration's
    amaxes, and bf16 logits."""
    _, _, variables, x = toy
    f32 = jax.jit(lambda v, xx: jq.functional_forward(v, xx, WIDTHS, collect_amax=True, compute_dtype=jnp.float32))
    logits, amax = f32(variables, jnp.asarray(x))
    bf16 = jax.jit(lambda v, xx: jq.functional_forward(v, xx, WIDTHS))(variables, jnp.asarray(x))
    return {"float32": np.asarray(logits, np.float32), "amax": np.asarray(amax, np.float64),
            "bfloat16": np.asarray(bf16, np.float32)}


def _held_argmax(got: np.ndarray, want: np.ndarray, atol: float) -> None:
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * atol
    assert clear.any() and np.array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp_mirror_is_the_ports_forward_and_matches_fav_tpu(toy, jax_fp, dtype):
    model = toy[1] if dtype == "float32" else toy[0]
    _, _, variables, x = toy
    cd = torch.float32 if dtype == "float32" else torch.bfloat16
    mirror = tq.functional_forward(model, torch.from_numpy(x), compute_dtype=cd)
    with torch.no_grad():
        assert torch.equal(mirror, model(torch.from_numpy(x)))
    want = jax_fp[dtype]
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    assert np.abs(mirror.numpy() - want).max() <= atol
    _held_argmax(mirror.numpy(), want, atol)


def test_calibration_matches_fav_tpu(toy, jax_quant, jax_fp):
    bf16, f32, _, x = toy
    _, amax = tq.functional_forward(f32, torch.from_numpy(x), compute_dtype=torch.float32, collect_amax=True)
    want = jax_fp["amax"]
    assert amax.shape == (3 * len(WIDTHS) - 1,) and amax.dtype == torch.float32
    np.testing.assert_allclose(amax.numpy(), want, rtol=AMAX_RTOL, atol=0)
    scales = tq.calibrate_cnn(bf16, torch.from_numpy(x))
    want_scales = np.asarray(jax_quant.act_scales, np.float64)
    assert bool((scales > 0).all())
    np.testing.assert_allclose(scales.numpy(), want_scales, rtol=BF16_STEP, atol=0)


def test_quantize_cnn_kernels_equal_fav_tpu(toy, jax_quant):
    bf16, _, _, x = toy
    q = tq.quantize_cnn(bf16, torch.from_numpy(x))
    assert len(q.qweights) == len(q.wscales) == 3 * len(WIDTHS) - 1 and q.widths == WIDTHS
    for got, sw, want, want_sw in zip(q.qweights, q.wscales, jax_quant.qweights, jax_quant.wscales):
        assert got.dtype == torch.int8 and sw.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(sw.numpy(), np.asarray(want_sw))


# (b, h, w, cin, cout, stride): the fav_tpu test's shapes, then products
# outside torch._int_mm's rules on the card (K = 27, N = 5, rows 9 and 4)
CONV_SHAPES = [
    (4, 32, 32, 16, 32, 1),
    (4, 32, 32, 16, 32, 2),
    (2, 16, 16, 8, 8, 2),
    (2, 15, 17, 8, 8, 2),
    (2, 15, 17, 8, 8, 1),
    (1, 3, 3, 3, 5, 1),
    (1, 4, 4, 3, 5, 2),
]


@pytest.mark.parametrize("shape", CONV_SHAPES, ids=["x".join(map(str, s)) for s in CONV_SHAPES])
def test_int8_convs_bit_equal_fav_tpu(shape):
    b, h, w, cin, cout, stride = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)
    k = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    xla = np.asarray(jq._conv(jnp.asarray(x), jnp.asarray(k), (stride, stride), out_dtype=jnp.int32))
    im2col = np.asarray(jq._conv_im2col_int8(jnp.asarray(x), jnp.asarray(k), (stride, stride)))
    np.testing.assert_array_equal(im2col, xla)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    kt = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    for fn in (tq._conv_im2col_int8, tq._conv_int8):
        got = fn(xt, kt, stride)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), xla, err_msg=fn.__name__)


def test_float32_conv_is_inexact_at_cin_256():
    """Why the ``conv`` route sums in float64: a float32 convolution of int8
    values at cin 256 (sums up to 127^2 * 9 * 256 > 2^24) misses the exact
    int32 sums, the float64 one does not."""
    rng = np.random.default_rng(7)  # same-signed values: the sums pass 2^24
    x = torch.from_numpy(rng.integers(64, 128, (1, 256, 6, 6)).astype(np.int8))
    k = torch.from_numpy(rng.integers(64, 128, (8, 256, 3, 3)).astype(np.int8))
    exact = tq._conv_im2col_int8(x, k, 1).to(torch.int64)
    f32 = torch.nn.functional.conv2d(x.float(), k.float(), padding=1).to(torch.int64)
    assert not torch.equal(f32, exact)
    assert torch.equal(tq._conv_int8(x, k, 1).to(torch.int64), exact)


@pytest.fixture(scope="module")
def jax_int8(toy, jax_quant):
    """``fav_tpu``'s int8 logits under ``jit`` (its ``im2col`` route, equal
    to its ``conv`` route bit for bit: ``tests/test_quant.py``)."""
    fn = jax.jit(lambda xx: jq.quantized_forward(jax_quant, xx, "im2col"))
    return np.asarray(fn(jnp.asarray(toy[3])), np.float32)


@pytest.mark.parametrize("algo", tq.INT8_ALGOS)
def test_quantized_forward_of_fav_tpus_quantisation(toy, jax_quant, jax_int8, algo):
    _, _, _, x = toy
    bridged = tq.from_flax_quantized(jax_quant)
    for got, want in zip(bridged.qweights, jax_quant.qweights):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).transpose(3, 2, 0, 1))
    got = tq.quantized_forward(bridged, torch.from_numpy(x), algo).numpy()
    want = jax_int8
    assert np.abs(got - want).max() <= BF16_ATOL
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_quantized_forward_tracks_fp_and_algos_agree(toy):
    """``fav_tpu``'s ``test_quantized_forward_tracks_fp`` at the toy size:
    within 0.05 of the float32 forward with the same argmax; both int8
    routes give the same logits."""
    bf16, f32, _, x = toy
    xt = torch.from_numpy(x)
    q = tq.quantize_cnn(bf16, xt)
    fp = tq.functional_forward(f32, xt, compute_dtype=torch.float32)
    conv = tq.quantized_forward(q, xt, "conv")
    assert float((fp - conv).abs().max()) < 0.05
    assert torch.equal(fp.argmax(-1), conv.argmax(-1))
    assert torch.equal(conv, tq.quantized_forward(q, xt, "im2col"))


def test_quant_ignores_standardize_input_as_fav_tpu_does():
    std, plain = _port(standardize=True), _port()
    x = torch.from_numpy(np.random.default_rng(1).random((4, 32, 32, 3), dtype=np.float32))
    assert torch.equal(tq.functional_forward(std, x), tq.functional_forward(plain, x))
    with torch.no_grad():
        assert not torch.equal(std(x), plain(x))
    with pytest.raises(ValueError, match="int8_algo"):
        tq.functional_forward(plain, x, int8_algo="dot")


def test_port_holds_the_quant_golden_on_the_cpu():
    with open(GOLDEN) as f:
        golden = json.load(f)
    nano = json.loads((WEIGHTS_DIR / "student_nano.golden.json").read_text())
    x = torch.from_numpy(np.random.default_rng(nano["seed"]).random(tuple(nano["shape"]), dtype=np.float32))
    model, _ = load_student("student_nano", device="cpu")
    q = tq.quantize_cnn(model, x)
    np.testing.assert_allclose(q.act_scales.numpy(), golden["act_scales"], rtol=BF16_STEP, atol=0)
    # one bf16 step in a scale moves whole int8 levels: the logits are held
    # under fav_tpu's own calibration
    q = q._replace(act_scales=torch.tensor(golden["act_scales"], dtype=torch.float32))
    want = np.asarray(golden["logits"], np.float32)
    for algo in tq.INT8_ALGOS:
        got = tq.quantized_forward(q, x, algo).numpy()
        assert np.abs(got - want).max() <= QUANT_GOLDEN_ATOL, algo
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_quant_golden_float_logits_agree_with_the_nano_golden():
    """The golden's float logits (``fav_tpu``'s functional mirror) against
    the nano golden's (flax's eager forward) and against the port's mirror
    on the CPU: the bf16 forward class."""
    with open(GOLDEN) as f:
        fp = np.asarray(json.load(f)["fp_logits"], np.float32)
    nano = json.loads((WEIGHTS_DIR / "student_nano.golden.json").read_text())
    assert np.abs(fp - np.asarray(nano["logits"], np.float32)).max() <= BF16_ATOL
    x = torch.from_numpy(np.random.default_rng(nano["seed"]).random(tuple(nano["shape"]), dtype=np.float32))
    model, _ = load_student("student_nano", device="cpu")
    assert np.abs(tq.functional_forward(model, x).numpy() - fp).max() <= BF16_ATOL
