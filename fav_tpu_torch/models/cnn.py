"""The classifier families and the conv autoencoder as PyTorch modules.

Counterpart of ``fav_tpu/models/cnn.py``: ``FailureAwareCNN`` (the vgg arch,
:51-111), ``ResidualBlock`` and ``ResNetSmall`` (:114-168),
``ConvAutoencoder`` (:171-202), ``create_model`` (which builds the ViT of
``models/vit.py`` for ``arch="vit"``) and ``create_autoencoder``
(:205-240). Images come in NHWC float32 as in the JAX package and are
permuted to NCHW inside. What differs from PyTorch's defaults, and is
matched here:

* flax ``SAME`` padding with stride 2 on an even size pads (0, 1), not
  (1, 1): 32 -> 16 -> 8 -> 4 (``same_pad_stride2``); a 1x1 stride-2 conv
  pads 0;
* flax ``ConvTranspose`` (``transpose_kernel=False``, ``SAME``, stride 2)
  correlates its unflipped kernel with the input dilated to 2H - 1 and
  padded (2, 1): ``F.conv_transpose2d`` with the flipped kernel, whose
  padding is (2, 2), and its last row and column dropped
  (``_conv_transpose_same``);
* GroupNorm has ``min(32, width)`` groups and eps 1e-6 (in a residual
  block, the first norm's groups follow the block's input width); a
  training step's forward runs inside :func:`training_norms`;
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
  from torch's global one. Eval mode, the default, does not draw. A test
  may hand in ``masks``, an iterator of the keep masks to use in order
  (flax's own, replayed), and a data shard a callable ``masks(shape)``
  that returns the uniforms of its rows of the whole batch's draw
  (``models/train.py:row_masks``); ResNetSmall drops out once per stage;
* :func:`init_params` draws flax's initialisation law: ``lecun_normal``
  for Conv, ConvTranspose, Dense and DenseGeneral kernels, zero biases,
  GroupNorm and LayerNorm scale 1 and bias 0, the ViT's ``cls`` 0 and
  ``pos_embed`` normal(0.02);
* the penultimate features flax sows into ``intermediates`` come out of
  ``features_and_logits`` beside the logits.

Convolutions go to ``F.conv2d`` (cuDNN on the card), as the JAX package
leaves them to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fav_tpu_torch.config import ModelParams

__all__ = ["FailureAwareCNN", "ResidualBlock", "ResNetSmall", "ConvAutoencoder", "create_model", "create_autoencoder",
           "dropout", "init_params", "same_pad_stride2", "standardize_image", "training_norms"]

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

    def forward(self, x: torch.Tensor, train: bool = False, generator: torch.Generator | None = None,
                masks=None, replicas: int = 1) -> torch.Tensor:
        """NHWC images -> float32 logits. ``train`` turns dropout on, its
        masks drawn from ``generator`` (required then, unless the rate is 0)
        or taken from ``masks``. ``replicas`` (the MC-dropout replicas folded
        into the batch) changes nothing here: every mask is per element."""
        return self.features_and_logits(x, train, generator, masks)[1]

    def features_and_logits(self, x: torch.Tensor, train: bool = False, generator: torch.Generator | None = None,
                            masks=None, replicas: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
        """``(features, logits)``, both float32: the penultimate features
        (after the dense ReLU and its dropout) that flax sows as
        ``intermediates/features`` (``fav_tpu/models/cnn.py:109``), and the
        logits ``forward`` returns, computed from them."""
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
            h = self._dropout(h, train, generator, masks)
        h = h.mean(dim=(-2, -1))  # global average pool
        d0, d1 = self.dense
        h = F.relu(F.linear(h, d0.weight.to(dt)) + d0.bias.to(dt))
        h = self._dropout(h, train, generator, masks)
        # logits in float32: softmax / temperature math needs the precision
        features = h.to(torch.float32)
        return features, F.linear(features, d1.weight, d1.bias)

    def _dropout(self, h: torch.Tensor, train: bool, generator: torch.Generator | None, masks=None) -> torch.Tensor:
        return dropout(h, self.dropout_rate, train, generator, masks)


def dropout(h: torch.Tensor, rate: float, train: bool, generator: torch.Generator | None, masks=None) -> torch.Tensor:
    """flax ``nn.Dropout`` in ``h``'s dtype: ``where(keep, h / keep_prob, 0)``,
    ``keep_prob`` rounded to that dtype as flax's weak-typed scalar is, the
    keep mask ``uniform < keep_prob`` drawn from ``generator`` (never from
    torch's global one), or the next of ``masks`` where a test replays
    flax's own, or ``masks(h.shape) < keep_prob`` where ``masks`` is a
    callable giving uniforms. The identity outside train mode or at rate 0."""
    if not train or rate == 0.0:
        return h
    keep_prob = 1.0 - rate
    if callable(masks):
        mask = masks(h.shape) < keep_prob
    elif masks is not None:
        mask = next(masks).to(device=h.device, dtype=torch.bool)
    elif generator is None:
        raise ValueError("train-mode dropout draws its masks from an explicit generator; pass generator=")
    else:
        mask = torch.rand(h.shape, generator=generator, device=h.device, dtype=torch.float32) < keep_prob
    keep = torch.tensor(keep_prob, dtype=h.dtype, device=h.device)
    return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))


def _conv(h: torch.Tensor, conv: nn.Conv2d, dt: torch.dtype, **kw) -> torch.Tensor:
    """flax ``Conv`` in ``dt``: the product is rounded to ``dt`` and the bias
    added after, in ``dt``, as flax adds it."""
    return F.conv2d(h, conv.weight.to(dt), None, **kw) + conv.bias.to(dt)[:, None, None]


_TRAINING_NORMS = contextvars.ContextVar("training_norms", default=False)


@contextlib.contextmanager
def training_norms():
    """GroupNorm for a training step's forward: the activation in the
    contiguous layout. torch's CPU kernels take a channels-last
    activation's moments in one pass (1.6e-5 off float64 where the
    contiguous kernel is 6.7e-7) and put a float32 gradient leaf of an
    ensemble member 2% from float64 (``tests/test_torch_trainers.py``),
    where flax's and the contiguous kernel's stay within 1e-5. On the card
    ``group_norm`` makes its input contiguous anyway. Forwards outside a
    training step keep the input's layout, as before."""
    token = _TRAINING_NORMS.set(True)
    try:
        yield
    finally:
        _TRAINING_NORMS.reset(token)


def _group_norm(h: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """flax ``GroupNorm``: statistics, scale and bias in float32 over the
    ``dt`` input, one rounding back to ``dt`` at the end (contiguous inside
    :func:`training_norms`)."""
    x = h.to(torch.float32)
    if _TRAINING_NORMS.get():
        x = x.contiguous()
    return F.group_norm(x, norm.num_groups, norm.weight, norm.bias, norm.eps).to(h.dtype)


def _conv_same(h: torch.Tensor, conv: nn.Conv2d, dt: torch.dtype, stride: int = 1) -> torch.Tensor:
    """flax ``Conv`` with ``SAME`` padding at stride 1 or 2."""
    k = conv.kernel_size[0]
    if stride == 1:
        return _conv(h, conv, dt, padding=k // 2)
    ph, pw = same_pad_stride2(h.shape[-2], k), same_pad_stride2(h.shape[-1], k)
    return _conv(F.pad(h, (pw[0], pw[1], ph[0], ph[1])), conv, dt, stride=2)


def _conv_transpose_same(h: torch.Tensor, conv: nn.Conv2d, dt: torch.dtype) -> torch.Tensor:
    """flax ``ConvTranspose`` (3x3, stride 2, ``SAME``, ``transpose_kernel=
    False``) in ``dt``: ``conv.weight`` is flax's kernel as OIHW, correlated
    with the input dilated to 2H - 1 and padded (2, 1). ``conv_transpose2d``
    of the flipped kernel is that correlation padded (2, 2), one row and
    column longer: they are dropped. The bias is added after the rounded
    product, as flax adds it."""
    oh, ow = 2 * h.shape[-2], 2 * h.shape[-1]
    w = conv.weight.to(dt).transpose(0, 1).flip(-2, -1)
    y = F.conv_transpose2d(h, w, stride=2)[..., :oh, :ow]
    return y + conv.bias.to(dt)[:, None, None]


class ResidualBlock(nn.Module):
    """Pre-activation residual block: GN-relu, then the 1x1 skip (where the
    stride or width changes) and the 3x3 conv from the activation, GN-relu,
    3x3 conv, plus the skip. flax creates the skip conv first, so it is
    ``convs.0`` (``Conv_0``) when present."""

    def __init__(self, in_channels: int, width: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.has_skip = stride != 1 or in_channels != width
        convs = [nn.Conv2d(in_channels, width, 1, stride=stride)] if self.has_skip else []
        convs += [nn.Conv2d(in_channels, width, 3, stride=stride), nn.Conv2d(width, width, 3)]
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList([nn.GroupNorm(min(32, in_channels), in_channels, eps=GROUPNORM_EPS),
                                    nn.GroupNorm(min(32, width), width, eps=GROUPNORM_EPS)])

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """NCHW in ``dt`` -> NCHW in ``dt``."""
        h = F.relu(_group_norm(x, self.norms[0]))
        convs = iter(self.convs)
        skip = _conv_same(h, next(convs), dt, self.stride) if self.has_skip else x
        h = _conv_same(h, next(convs), dt, self.stride)
        h = F.relu(_group_norm(h, self.norms[1]))
        return skip + _conv_same(h, next(convs), dt)


class ResNetSmall(nn.Module):
    """Pre-activation ResNet for 32x32 inputs (``fav_tpu/models/cnn.py:137``):
    a 3x3 conv, ``blocks_per_stage`` residual blocks per width (the first
    of every stage but the first at stride 2), dropout after each stage,
    GN-relu, global average pool, Dense. ``blocks.k`` is
    ``ResidualBlock_k``; the features are the pooled activations."""

    def __init__(
        self,
        num_classes: int = 10,
        widths: Sequence[int] = (64, 128, 256),
        blocks_per_stage: int = 2,
        dropout_rate: float = 0.1,
        compute_dtype: str = "bfloat16",
        standardize_input: bool = False,
        in_channels: int = 3,
    ):
        super().__init__()
        if not 0.0 <= dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must lie in [0, 1), got {dropout_rate}")
        self.widths = tuple(widths)
        self.blocks_per_stage = blocks_per_stage
        self.dropout_rate = float(dropout_rate)
        self.compute_dtype = _DTYPES[compute_dtype]
        self.standardize_input = standardize_input
        self.convs = nn.ModuleList([nn.Conv2d(in_channels, self.widths[0], 3)])
        blocks, cin = [], self.widths[0]
        for stage, width in enumerate(self.widths):
            for block in range(blocks_per_stage):
                blocks.append(ResidualBlock(cin, width, 2 if stage > 0 and block == 0 else 1))
                cin = width
        self.blocks = nn.ModuleList(blocks)
        self.norms = nn.ModuleList([nn.GroupNorm(min(32, cin), cin, eps=GROUPNORM_EPS)])
        self.dense = nn.ModuleList([nn.Linear(cin, num_classes)])

    def forward(self, x: torch.Tensor, train: bool = False, generator: torch.Generator | None = None,
                masks=None, replicas: int = 1) -> torch.Tensor:
        """NHWC images -> float32 logits (``FailureAwareCNN.forward``'s contract)."""
        return self.features_and_logits(x, train, generator, masks)[1]

    def features_and_logits(self, x: torch.Tensor, train: bool = False, generator: torch.Generator | None = None,
                            masks=None, replicas: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
        """``(features, logits)``, both float32: the pooled activations flax
        sows after the GAP, and the logits of the float32 Dense over them."""
        dt = self.compute_dtype
        if self.standardize_input:
            x = standardize_image(x)
        h = _conv_same(x.to(dt).permute(0, 3, 1, 2), self.convs[0], dt)
        blocks = iter(self.blocks)
        for _ in self.widths:
            for _ in range(self.blocks_per_stage):
                h = next(blocks)(h, dt)
            h = dropout(h, self.dropout_rate, train, generator, masks)
        h = F.relu(_group_norm(h, self.norms[0]))
        features = h.mean(dim=(-2, -1)).to(torch.float32)
        d = self.dense[0]
        return features, F.linear(features, d.weight, d.bias)


class ConvAutoencoder(nn.Module):
    """Strided conv autoencoder, 32x32x3 -> 4x4xlatent -> 32x32x3
    (``fav_tpu/models/cnn.py:171``): stride-2 convs over ``widths``, a
    latent conv, stride-2 transposed convs back over the widths reversed,
    a float32 conv to the input's channels and a sigmoid. ``convs`` are
    ``Conv_0..4`` (the last is the output conv), ``deconvs`` are
    ``ConvTranspose_0..2``. Per-image reconstruction MSE is the anomaly
    (:meth:`reconstruction_error`)."""

    def __init__(self, widths: Sequence[int] = (32, 64, 128), latent: int = 128, compute_dtype: str = "bfloat16",
                 in_channels: int = 3):
        super().__init__()
        self.widths = tuple(widths)
        self.latent = int(latent)
        self.compute_dtype = _DTYPES[compute_dtype]
        convs, cin = [], in_channels
        for width in self.widths:
            convs.append(nn.Conv2d(cin, width, 3))
            cin = width
        convs.append(nn.Conv2d(cin, self.latent, 3))
        deconvs, cin = [], self.latent
        for width in reversed(self.widths):
            deconvs.append(nn.Conv2d(cin, width, 3))
            cin = width
        convs.append(nn.Conv2d(cin, in_channels, 3))
        self.convs = nn.ModuleList(convs)
        self.deconvs = nn.ModuleList(deconvs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> float32 reconstructions in (0, 1), NHWC."""
        dt = self.compute_dtype
        h = x.to(dt).permute(0, 3, 1, 2)
        n = len(self.widths)
        for conv in self.convs[:n]:
            h = F.relu(_conv_same(h, conv, dt, stride=2))
        h = F.relu(_conv_same(h, self.convs[n], dt))
        for deconv in self.deconvs:
            h = F.relu(_conv_transpose_same(h, deconv, dt))
        out = self.convs[-1]
        # the output conv computes in float32 (flax's dtype=jnp.float32)
        h = F.conv2d(h.to(torch.float32), out.weight, out.bias, padding=1)
        return torch.sigmoid(h).permute(0, 2, 3, 1)

    @staticmethod
    def reconstruction_error(recon: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Per-image MSE over (H, W, C), the reference's anomaly scalar."""
        return ((recon - x.to(recon.dtype)) ** 2).mean(dim=(-3, -2, -1))


def create_model(params: ModelParams | None = None) -> nn.Module:
    """The classifier of ``params.arch``: ``vit`` (``models/vit.py``),
    ``resnet``, or ``FailureAwareCNN`` for any other arch, as in ``fav_tpu``."""
    p = params or ModelParams()
    if p.arch == "vit":
        from fav_tpu_torch.models.vit import VisionTransformer

        return VisionTransformer(
            num_classes=p.num_classes,
            dim=p.vit_dim,
            depth=p.vit_depth,
            heads=p.vit_heads,
            mlp_dim=2 * p.vit_dim,
            dropout_rate=p.dropout_rate,
            compute_dtype=p.compute_dtype,
            standardize_input=p.standardize_input,
            image_size=p.image_size,
            in_channels=p.channels,
        )
    if p.arch == "resnet":
        return ResNetSmall(
            num_classes=p.num_classes,
            widths=tuple(p.widths),
            dropout_rate=p.dropout_rate,
            compute_dtype=p.compute_dtype,
            standardize_input=p.standardize_input,
            in_channels=p.channels,
        )
    return FailureAwareCNN(
        num_classes=p.num_classes,
        widths=tuple(p.widths),
        dense_width=p.dense_width,
        dropout_rate=p.dropout_rate,
        compute_dtype=p.compute_dtype,
        standardize_input=p.standardize_input,
        in_channels=p.channels,
    )


def create_autoencoder(params: ModelParams | None = None) -> ConvAutoencoder:
    p = params or ModelParams()
    return ConvAutoencoder(compute_dtype=p.compute_dtype, in_channels=p.channels)


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
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw ``model``'s parameters in place by flax's initialisation law,
    from ``generator`` (on the model's device), module by module in
    registration order: Conv and ConvTranspose kernels ``lecun_normal``
    (fan_in = kh·kw·C_in), Dense kernels over their input width,
    DenseGeneral kernels (the ViT's attention, ``fan_in`` attribute) over
    their flattened input dims, biases 0, GroupNorm and LayerNorm scale 1
    and bias 0; the ViT's ``cls`` 0 and ``pos_embed`` normal(0.02).
    torch's default kaiming-uniform is another training law. Returns
    ``model``."""
    for module in model.modules():
        if isinstance(module, nn.Conv2d):
            _lecun_normal_(module.weight, module.in_channels * module.kernel_size[0] * module.kernel_size[1], generator)
        elif isinstance(module, nn.Linear):
            _lecun_normal_(module.weight, module.in_features, generator)
        elif hasattr(module, "fan_in"):
            _lecun_normal_(module.weight, module.fan_in, generator)
        elif isinstance(module, (nn.GroupNorm, nn.LayerNorm)):
            module.weight.fill_(1.0)
        else:
            continue
        module.bias.zero_()
    if hasattr(model, "pos_embed"):
        model.cls.zero_()
        model.pos_embed.copy_(0.02 * torch.randn(model.pos_embed.shape, generator=generator,
                                                 device=model.pos_embed.device))
    return model
