"""The failure-aware CNN (vgg arch) as a PyTorch module.

Counterpart of ``fav_tpu/models/cnn.py:51-111`` and ``create_model``. Images
come in NHWC float32 as in the JAX package and are permuted to NCHW inside.
What differs from PyTorch's defaults, and is matched here:

* flax ``SAME`` padding with stride 2 on an even size pads (0, 1), not
  (1, 1): 32 -> 16 -> 8 -> 4 (``same_pad_stride2``);
* GroupNorm has ``min(32, width)`` groups and eps 1e-6;
* ``standardize_image`` uses the population std (ddof 0);
* compute is in ``compute_dtype`` (bf16 by default) with float32
  parameters cast per call, rounding where flax rounds: a conv or Dense
  product is rounded before its bias is added, GroupNorm works in float32
  and rounds once; the last Dense runs in float32;
* dropout runs only in train mode (``forward(x, train=True, generator=g)``,
  flax's ``apply(train=True)``), where flax puts it: after each stage's
  stride-2 conv and ReLU and after the dense ReLU. It is flax's form,
  ``where(mask, h / keep_prob, 0)`` in the compute dtype, ``keep_prob``
  rounded to that dtype as flax's weak-typed scalar is, and the mask
  ``uniform < keep_prob`` is drawn from the generator passed in, never
  from torch's global one. Eval mode, the default, does not draw;
* :func:`init_params` draws flax's initialisation law: ``lecun_normal``
  for Conv and Dense kernels, zero biases, GroupNorm scale 1 and bias 0.

Convolutions go to ``F.conv2d`` (cuDNN on the card), as the JAX package
leaves them to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fav_tpu_torch.config import ModelParams

__all__ = ["FailureAwareCNN", "create_model", "init_params", "same_pad_stride2", "standardize_image"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}

GROUPNORM_EPS = 1e-6  # flax's default; torch's is 1e-5


def standardize_image(x: torch.Tensor) -> torch.Tensor:
    """Per-image ``(x - mean) / max(std, 1e-3)`` over (H, W, C) in float32."""
    xf = x.to(torch.float32)
    dims = (-3, -2, -1)
    m = xf.mean(dim=dims, keepdim=True)
    s = xf.std(dim=dims, keepdim=True, correction=0)
    return (xf - m) / torch.clamp(s, min=1e-3)


def same_pad_stride2(size: int, kernel: int = 3) -> tuple[int, int]:
    """(low, high) padding of flax/XLA ``SAME`` for a stride-2 window:
    (0, 1) for a 3-wide kernel on an even size."""
    out = -(-size // 2)
    total = max((out - 1) * 2 + kernel - size, 0)
    return total // 2, total - total // 2


class FailureAwareCNN(nn.Module):
    """VGG-style CNN: per width, [conv-GN-relu] x 2 then a stride-2 conv and
    relu; global average pool, Dense-relu, Dense. Parameter names follow the
    flax tree: ``convs.k`` is ``Conv_k``, ``norms.k`` is ``GroupNorm_k`` and
    ``dense.k`` is ``Dense_k``."""

    def __init__(
        self,
        num_classes: int = 10,
        widths: Sequence[int] = (64, 128, 256),
        dense_width: int = 256,
        dropout_rate: float = 0.1,
        compute_dtype: str = "bfloat16",
        standardize_input: bool = False,
        in_channels: int = 3,
    ):
        super().__init__()
        if not 0.0 <= dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must lie in [0, 1), got {dropout_rate}")
        self.widths = tuple(widths)
        self.dropout_rate = float(dropout_rate)
        self.compute_dtype = _DTYPES[compute_dtype]
        self.standardize_input = standardize_input
        convs, norms = [], []
        cin = in_channels
        for width in self.widths:
            for _ in range(2):
                convs.append(nn.Conv2d(cin, width, 3))
                norms.append(nn.GroupNorm(min(32, width), width, eps=GROUPNORM_EPS))
                cin = width
            convs.append(nn.Conv2d(width, width, 3, stride=2))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)
        self.dense = nn.ModuleList([nn.Linear(cin, dense_width), nn.Linear(dense_width, num_classes)])

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """NHWC images -> float32 logits. ``train`` turns dropout on, its
        masks drawn from ``generator`` (required then, unless the rate is 0)."""
        dt = self.compute_dtype
        if self.standardize_input:
            x = standardize_image(x)
        h = x.to(dt).permute(0, 3, 1, 2)
        convs, norms = iter(self.convs), iter(self.norms)
        for _ in self.widths:
            for _ in range(2):
                h = _conv(h, next(convs), dt, padding=1)
                h = F.relu(_group_norm(h, next(norms)))
            conv = next(convs)
            ph, pw = same_pad_stride2(h.shape[-2]), same_pad_stride2(h.shape[-1])
            h = F.relu(_conv(F.pad(h, (pw[0], pw[1], ph[0], ph[1])), conv, dt, stride=2))
            h = self._dropout(h, train, generator)
        h = h.mean(dim=(-2, -1))  # global average pool
        d0, d1 = self.dense
        h = F.relu(F.linear(h, d0.weight.to(dt)) + d0.bias.to(dt))
        h = self._dropout(h, train, generator)
        # logits in float32: softmax / temperature math needs the precision
        return F.linear(h.to(torch.float32), d1.weight, d1.bias)

    def _dropout(self, h: torch.Tensor, train: bool, generator: torch.Generator | None) -> torch.Tensor:
        if not train or self.dropout_rate == 0.0:
            return h
        if generator is None:
            raise ValueError("train-mode dropout draws its masks from an explicit generator; pass generator=")
        keep_prob = 1.0 - self.dropout_rate
        # flax: bernoulli(p=keep_prob) is a float32 uniform below keep_prob;
        # h / keep_prob divides by keep_prob rounded to h's dtype
        mask = torch.rand(h.shape, generator=generator, device=h.device, dtype=torch.float32) < keep_prob
        keep = torch.tensor(keep_prob, dtype=h.dtype, device=h.device)
        return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))


def _conv(h: torch.Tensor, conv: nn.Conv2d, dt: torch.dtype, **kw) -> torch.Tensor:
    """flax ``Conv`` in ``dt``: the product is rounded to ``dt`` and the bias
    added after, in ``dt``, as flax adds it."""
    return F.conv2d(h, conv.weight.to(dt), None, **kw) + conv.bias.to(dt)[:, None, None]


def _group_norm(h: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """flax ``GroupNorm``: statistics, scale and bias in float32 over the
    ``dt`` input, one rounding back to ``dt`` at the end."""
    y = F.group_norm(h.to(torch.float32), norm.num_groups, norm.weight, norm.bias, norm.eps)
    return y.to(h.dtype)


def create_model(params: ModelParams | None = None) -> FailureAwareCNN:
    p = params or ModelParams()
    if p.arch != "vgg":
        raise NotImplementedError(
            f"arch {p.arch!r} is not ported yet: ROADMAP.md Queue 1 item 4 (ResNetSmall, ViT)")
    return FailureAwareCNN(
        num_classes=p.num_classes,
        widths=tuple(p.widths),
        dense_width=p.dense_width,
        dropout_rate=p.dropout_rate,
        compute_dtype=p.compute_dtype,
        standardize_input=p.standardize_input,
        in_channels=p.channels,
    )


# flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal"), whose
# standard deviation is divided by that of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """Truncated normal on [-2σ, 2σ], σ = sqrt(1 / fan_in) / 0.8796..., by
    the inverse CDF of a uniform on [erf(-√2), erf(√2)] as ``jax.random``
    draws it."""
    lo, hi = math.erf(-math.sqrt(2.0)), math.erf(math.sqrt(2.0))
    u = torch.rand(weight.shape, generator=generator, device=weight.device, dtype=torch.float32)
    z = torch.clamp(math.sqrt(2.0) * torch.erfinv(lo + (hi - lo) * u), -2.0, 2.0)
    weight.copy_(z * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))


@torch.no_grad()
def init_params(model: FailureAwareCNN, generator: torch.Generator) -> FailureAwareCNN:
    """Draw ``model``'s parameters in place by flax's initialisation law,
    from ``generator`` (on the model's device): Conv and Dense kernels
    ``lecun_normal`` (fan_in = 3·3·C_in or the Dense input width), biases 0,
    GroupNorm scale 1 and bias 0. torch's default kaiming-uniform is another
    training law. Returns ``model``."""
    for conv in model.convs:
        _lecun_normal_(conv.weight, conv.in_channels * conv.kernel_size[0] * conv.kernel_size[1], generator)
        conv.bias.zero_()
    for dense in model.dense:
        _lecun_normal_(dense.weight, dense.in_features, generator)
        dense.bias.zero_()
    for norm in model.norms:
        norm.weight.fill_(1.0)
        norm.bias.zero_()
    return model
