"""Post-training W8A8 int8 quantisation of the vgg ``FailureAwareCNN``.

Counterpart of ``fav_tpu/models/quant.py:48-230``, the same scheme:

* **weights**: symmetric int8, one scale per output channel, ``amax / 127``
  over (kh, kw, cin);
* **activations**: one int8 scale per tensor, calibrated by one float
  forward over a calibration batch (every quantised conv's input is a ReLU
  output, so the int8 range is in effect [0, 127]);
* each quantised conv sums int8 x int8 products exactly in int32; the
  dequantisation, bias, GroupNorm and ReLU then run in the compute dtype
  as in the float model;
* the 3-channel stem conv and both dense layers stay in bf16/float32.

:func:`functional_forward` walks the port's module (``convs.k`` is
``Conv_k``, ``norms.k`` is ``GroupNorm_k``, ``dense.k`` is ``Dense_k``;
``models/cnn.py``) with its ``_conv``, ``_group_norm`` and SAME padding
(``same_pad_stride2``), rounding where flax rounds, so any vgg weights
quantise without retraining. Like ``fav_tpu``'s, it never standardises
its input: a model built with ``standardize_input`` (``student_std``) is
walked as if it had none.

Two routes for the int8 convolution, equal to the bit (``int8_algo``):

* ``"im2col"`` (:func:`_conv_im2col_int8`): the patches in (dy, dx, cin)
  order with XLA's asymmetric SAME padding, then ONE int8 x int8 -> int32
  product through ``torch._int_mm`` (cuBLASLt on the card);
* ``"conv"`` (:func:`_conv_int8`): a direct convolution of the int8 values
  in float64. Float32 is not exact here: at cin 256 a sum reaches
  127^2 * 9 * 256 = 37,161,216 > 2^24. Float64 holds every such integer
  (< 2^53) exactly, in any order of summation.

No hand-written kernel stands behind either: ``fav_tpu`` reaches no Pallas
kernel here (XLA's ``conv_general_dilated`` and ``dot_general``).
:func:`from_flax_quantized` turns ``fav_tpu``'s ``QuantizedCNN`` into the
port's, so that the tests feed both packages the same int8 tensors.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from fav_tpu_torch.models.cnn import FailureAwareCNN, _conv, _group_norm, same_pad_stride2
from fav_tpu_torch.utils.checkpoint import flax_to_torch

__all__ = [
    "QuantizedCNN",
    "functional_forward",
    "calibrate_cnn",
    "quantize_cnn",
    "quantized_forward",
    "from_flax_quantized",
    "INT8_ALGOS",
]

INT8_ALGOS = ("conv", "im2col")
# torch._int_mm's shape rules on CUDA (aten/src/ATen/native/cuda/Blas.cpp):
# more than 16 rows, K and N multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_MULTIPLE = 8


class QuantizedCNN(NamedTuple):
    """Quantised parameters of a vgg ``FailureAwareCNN``: the int8 kernels
    (OIHW) and per-channel scales of every conv but the stem, the
    calibrated per-tensor input scales of those convs (same order), the
    float model (stem, GroupNorm affines, biases and dense layers are read
    from it) and its stage widths."""

    qweights: tuple  # int8 [cout, cin, kh, kw] per quantised conv
    wscales: tuple  # float32 [cout] per quantised conv
    act_scales: torch.Tensor  # float32 [n_quantised_convs]
    fp: FailureAwareCNN
    widths: tuple


def _same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of XLA's ``SAME``: the total split with the
    smaller half first."""
    if stride == 2:
        return same_pad_stride2(size, kernel)
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """NCHW ``x`` zero-padded for a ``SAME`` window."""
    ph, pw = _same_pads(x.shape[-2], kernel, stride), _same_pads(x.shape[-1], kernel, stride)
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]))


def _quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-tensor activation quantisation, round half to even as ``jnp.round``."""
    return torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127).to(torch.int8)


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _conv_im2col_int8(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Int8 conv as im2col and one int8 x int8 -> int32 product:
    ``x`` int8 NCHW, ``kernel`` int8 OIHW -> int32 NCHW, ``SAME`` padding.

    The kh * kw shifted strided views of the padded input concatenate into
    [B * OH * OW, kh * kw * cin] patches in (dy, dx, cin) order, and the
    kernel flattens to [kh * kw * cin, cout] in the same order, as
    ``fav_tpu``'s ``_conv_im2col_int8`` builds them. ``torch._int_mm``
    takes on the card only more than 16 rows and K and N that are multiples
    of 8, so a product outside those rules is padded with zero rows (to 17),
    zero K columns of both operands and zero kernel columns, and the
    padding is cut from the result: a zero adds nothing to an integer sum,
    so the int32 sums stay exact. The same padding runs on the CPU."""
    cout, cin, kh, kw = kernel.shape
    b, _, h, w = x.shape
    oh, ow = -(-h // stride), -(-w // stride)
    xp = _pad_same(x, kh, stride).permute(0, 2, 3, 1)  # NHWC: cin innermost
    patches = [
        xp[:, dy: dy + (oh - 1) * stride + 1: stride, dx: dx + (ow - 1) * stride + 1: stride, :]
        for dy in range(kh)
        for dx in range(kw)
    ]
    lhs = torch.cat(patches, dim=-1).reshape(b * oh * ow, kh * kw * cin)
    rhs = kernel.permute(2, 3, 1, 0).reshape(kh * kw * cin, cout)
    m, k = lhs.shape
    k_pad, n_pad = _round_up(k, _INT_MM_MULTIPLE), _round_up(cout, _INT_MM_MULTIPLE)
    m_pad = max(m, _INT_MM_MIN_ROWS)
    if (m_pad, k_pad) != (m, k):
        lhs = F.pad(lhs, (0, k_pad - k, 0, m_pad - m))
    if (k_pad, n_pad) != (k, cout):
        rhs = F.pad(rhs, (0, n_pad - cout, 0, k_pad - k))
    y = torch._int_mm(lhs.contiguous(), rhs.contiguous())[:m, :cout]
    return y.reshape(b, oh, ow, cout).permute(0, 3, 1, 2)


def _conv_int8(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Int8 conv as a direct float64 convolution of the int8 values:
    ``x`` int8 NCHW, ``kernel`` int8 OIHW -> int32 NCHW, ``SAME`` padding.
    Every product and partial sum is an integer below 2^53, so float64
    holds each exactly and the result equals the int32 sums."""
    y = F.conv2d(_pad_same(x, kernel.shape[-1], stride).to(torch.float64), kernel.to(torch.float64), stride=stride)
    return y.to(torch.int32)


@torch.no_grad()
def functional_forward(
    model: FailureAwareCNN,
    x: torch.Tensor,
    widths: Sequence[int] | None = None,
    *,
    quant: QuantizedCNN | None = None,
    collect_amax: bool = False,
    compute_dtype: torch.dtype = torch.bfloat16,
    int8_algo: str = "conv",
):
    """The forward of ``model`` (NHWC images -> float32 logits) in
    inference mode, walked layer by layer. Three modes:

    * the float mirror (default), equal to ``model``'s own forward in
      ``compute_dtype`` when it does not standardise its input;
    * ``collect_amax=True`` also returns the per-tensor amax [n] (float32)
      at every quantised conv's input, the calibration's observables;
    * ``quant=...`` runs ``Conv_1`` onwards in int8 by ``int8_algo``
      (``"conv"`` or ``"im2col"``)."""
    if int8_algo not in INT8_ALGOS:
        raise ValueError(f"int8_algo must be one of {INT8_ALGOS}, got {int8_algo!r}")
    widths = tuple(model.widths if widths is None else widths)
    cd = compute_dtype
    h = x.to(cd).permute(0, 3, 1, 2)  # no standardize_input, as fav_tpu's walk
    amaxes = []
    qi = 0  # index into the quantised-conv tables (the stem excluded)

    def conv_layer(h: torch.Tensor, k: int, stride: int) -> torch.Tensor:
        nonlocal qi
        conv = model.convs[k]
        if k == 0 or quant is None:
            if collect_amax and k != 0:
                amaxes.append(h.abs().amax().to(torch.float32))
            y = _conv(h if stride == 1 else _pad_same(h, 3, stride), conv, cd, stride=stride,
                      padding=1 if stride == 1 else 0)
        else:
            s_x = quant.act_scales[qi]
            x_i8 = _quantize_act(h, s_x)
            conv_i8 = _conv_im2col_int8 if int8_algo == "im2col" else _conv_int8
            y_i32 = conv_i8(x_i8, quant.qweights[qi], stride)
            y = (y_i32.to(torch.float32) * (s_x * quant.wscales[qi])[:, None, None]).to(cd)
            y = y + conv.bias.to(cd)[:, None, None]
        if k != 0:
            qi += 1
        return y

    conv_i = gn_i = 0
    for _ in widths:
        for _ in range(2):
            h = conv_layer(h, conv_i, 1)
            conv_i += 1
            h = F.relu(_group_norm(h, model.norms[gn_i]))
            gn_i += 1
        h = F.relu(conv_layer(h, conv_i, 2))
        conv_i += 1
    h = h.mean(dim=(-2, -1))  # global average pool; dropout is the identity here
    d0, d1 = model.dense
    h = F.relu(F.linear(h, d0.weight.to(cd)) + d0.bias.to(cd))
    logits = F.linear(h.to(torch.float32), d1.weight, d1.bias)
    if collect_amax:
        return logits, torch.stack(amaxes)
    return logits


@torch.no_grad()
def calibrate_cnn(model: FailureAwareCNN, calib_images: torch.Tensor,
                  widths: Sequence[int] | None = None) -> torch.Tensor:
    """One bf16 pass over a calibration batch -> per-tensor activation
    scales [n] (float32), ``max(amax, 1e-8) / 127``."""
    _, amax = functional_forward(model, calib_images, widths, collect_amax=True)
    return torch.clamp(amax, min=1e-8) / 127.0


@torch.no_grad()
def quantize_cnn(model: FailureAwareCNN, calib_images: torch.Tensor,
                 widths: Sequence[int] | None = None) -> QuantizedCNN:
    """Post-training quantisation: int8 kernels and calibrated activation
    scales, on the model's device."""
    widths = tuple(model.widths if widths is None else widths)
    act_scales = calibrate_cnn(model, calib_images, widths)
    qweights, wscales = [], []
    for conv in list(model.convs)[1: 3 * len(widths)]:  # Conv_0 (the stem) stays in floating point
        kernel = conv.weight.to(torch.float32)
        s_w = torch.clamp(kernel.abs().amax(dim=(1, 2, 3)), min=1e-8) / 127.0
        qweights.append(torch.clamp(torch.round(kernel / s_w[:, None, None, None]), -127, 127).to(torch.int8))
        wscales.append(s_w)
    return QuantizedCNN(tuple(qweights), tuple(wscales), act_scales, model, widths)


@torch.no_grad()
def quantized_forward(q: QuantizedCNN, x: torch.Tensor, int8_algo: str = "conv") -> torch.Tensor:
    """The int8 inference forward: NHWC images -> float32 logits."""
    return functional_forward(q.fp, x, q.widths, quant=q, int8_algo=int8_algo)


def _flat_tree(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat_tree(v, path) if isinstance(v, Mapping) else {path: np.asarray(v, np.float32)})
    return out


def from_flax_quantized(q) -> QuantizedCNN:
    """The port's :class:`QuantizedCNN`, on the CPU, from ``fav_tpu``'s (any
    object with its fields, arrays that numpy reads): the int8 HWIO kernels
    become OIHW, the scales are copied, and the float tree
    (``fp["params"]``) goes through ``flax_to_torch`` into a bf16 vgg
    ``FailureAwareCNN`` of the same widths, dense width and class count."""
    params = _flat_tree(q.fp["params"])
    widths = tuple(int(w) for w in q.widths)
    model = FailureAwareCNN(num_classes=params["Dense_1/kernel"].shape[1], widths=widths,
                            dense_width=params["Dense_0/kernel"].shape[1])
    model.load_state_dict(flax_to_torch(params), strict=True)
    qweights = tuple(torch.from_numpy(np.asarray(w, np.int8).transpose(3, 2, 0, 1).copy()) for w in q.qweights)
    wscales = tuple(torch.from_numpy(np.asarray(s, np.float32).copy()) for s in q.wscales)
    act_scales = torch.from_numpy(np.asarray(q.act_scales, np.float32).copy())
    return QuantizedCNN(qweights, wscales, act_scales, model.eval(), widths)
