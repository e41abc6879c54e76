"""The compact Vision Transformer, the third classifier family
(``fav_tpu/models/vit.py:36-108``), as a PyTorch module.

32x32 images become 8x8 patches (a 4x4 conv at stride 4), a CLS token and
a learned position embedding are added, ``depth`` pre-norm blocks of
multi-head self-attention and a GELU MLP follow, then a LayerNorm, and the
CLS token goes through a float32 Dense head. Parameter names follow the
flax tree (``utils/checkpoint.py`` maps them): ``patchify``, ``cls``,
``pos_embed``, ``block_i.lns.k`` (``block_i/LayerNorm_k``),
``block_i.attns.0.{query,key,value,out}`` (``block_i/
MultiHeadDotProductAttention_0/...``, kernels kept in flax's
[dim, heads, head_dim] and [heads, head_dim, dim] shapes),
``block_i.mlp_in``, ``block_i.mlp_out``, ``lns.0`` and ``head``.

The forward rounds where flax 0.12.3 rounds in the compute dtype (bf16 by
default):

* each Dense and DenseGeneral product is rounded before its bias is added;
* LayerNorm computes its statistics in float32 as E[x^2] - E[x]^2 (flax's
  fast variance), eps 1e-6, and rounds once;
* the query is divided by sqrt(head_dim), rounded to the compute dtype,
  before the product with the key;
* the softmax runs on the rounded scores (``force_fp32_for_softmax`` is
  off): ``jax.nn.softmax`` is one jitted program, computed in float32 and
  rounded once;
* attention dropout multiplies by ``keep / keep_prob`` in the compute
  dtype, its mask broadcast over the batch and the heads
  (``broadcast_dropout=True``): one [L, L] mask per MC-dropout replica
  folded into the batch (``replicas``);
* ``nn.gelu`` is the tanh approximation.

``scaled_dot_product_attention`` is not used: it scales and normalises in
its own precision and would loosen the bf16 parity. The JAX package runs
attention under XLA, outside any Pallas kernel, so plain products and a
softmax (cuBLAS on the card) are its counterpart.

Tensor parallelism over a mesh's ``model`` axis (``tp_shard_vit_params``,
``fav_tpu/models/vit.py:111-146``), in the Megatron layout: the query, key
and value projections and ``mlp_in`` are column-parallel (a rank holds its
heads, or its share of the MLP width), ``out`` and ``mlp_out`` row-parallel
(its share of their inputs); everything else is whole on every rank.
:func:`tensor_parallel_vit` builds a rank's module, a ViT of ``heads / T``
heads and ``mlp_dim / T`` hidden units over its shard, whose row-parallel
products are summed over the ``model`` group, one all-reduce after
``out`` and one after ``mlp_out`` a block, before their bias. A rank's
partial product is taken in float32 from the compute-dtype operands and
the sum rounded once to the compute dtype, where the whole product rounds
once: in float32 the two differ only in the order of the sum.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from fav_tpu_torch.models.cnn import _DTYPES, _conv, dropout, standardize_image

__all__ = ["VisionTransformer", "LAYERNORM_EPS", "tp_shard_vit_params", "tensor_parallel_vit"]

LAYERNORM_EPS = 1e-6  # flax's default; torch's is 1e-5


class _DenseGeneral(nn.Module):
    """flax ``DenseGeneral`` with its kernel in flax's shape: ``in_shape +
    out_shape`` (the query, key and value: [dim, heads, head_dim]; the
    output projection: [heads, head_dim, dim]); ``fan_in`` is the product
    of the input dims, as flax's initialiser flattens them."""

    def __init__(self, in_shape: tuple[int, ...], out_shape: tuple[int, ...]):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.fan_in = math.prod(self.in_shape)
        self.weight = nn.Parameter(torch.zeros(self.in_shape + self.out_shape))
        self.bias = nn.Parameter(torch.zeros(self.out_shape))

    def forward(self, x: torch.Tensor, dt: torch.dtype, reduce=None) -> torch.Tensor:
        """Contract the trailing ``in_shape`` dims of ``x`` in ``dt``; with
        ``reduce``, a row-parallel share summed over the ranks first."""
        lead = x.shape[:x.ndim - len(self.in_shape)]
        w = self.weight.to(dt).reshape(self.fan_in, -1)
        y = _product(x.reshape(*lead, self.fan_in), w, dt, reduce, lambda a, b: a @ b)
        return y.reshape(*lead, *self.out_shape) + self.bias.to(dt)


def _product(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype, reduce, op) -> torch.Tensor:
    """``op(x, w)`` in ``dt``; with ``reduce``, this rank's share in float32,
    summed over the ``model`` group and rounded once to ``dt``."""
    if reduce is None:
        return op(x, w)
    return reduce(op(x.to(torch.float32), w.to(torch.float32))).to(dt)


class _Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, qkv features =
    dim)."""

    def __init__(self, dim: int, heads: int, dropout_rate: float, shards: int = 1):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not a multiple of heads {heads}")
        head_dim = dim // heads
        heads //= shards  # a tensor-parallel rank's heads
        self.dropout_rate = dropout_rate
        self.query = _DenseGeneral((dim,), (heads, head_dim))
        self.key = _DenseGeneral((dim,), (heads, head_dim))
        self.value = _DenseGeneral((dim,), (heads, head_dim))
        self.out = _DenseGeneral((heads, head_dim), (dim,))

    def forward(self, x: torch.Tensor, dt: torch.dtype, train: bool, generator: torch.Generator | None,
                replicas: int, reduce=None) -> torch.Tensor:
        q, k, v = self.query(x, dt), self.key(x, dt), self.value(x, dt)  # [B, L, H, D]
        depth = torch.tensor(math.sqrt(q.shape[-1]), dtype=dt, device=x.device)
        q = (q / depth).permute(0, 2, 1, 3)
        scores = q @ k.permute(0, 2, 3, 1)  # [B, H, L, L]
        weights = torch.softmax(scores.to(torch.float32), dim=-1).to(dt)
        if train and self.dropout_rate > 0.0:
            if generator is None:
                raise ValueError("train-mode dropout draws its masks from an explicit generator; pass generator=")
            keep_prob = 1.0 - self.dropout_rate
            b, h, lq, lk = weights.shape
            keep = torch.rand((replicas, 1, 1, lq, lk), generator=generator, device=x.device) < keep_prob
            multiplier = keep.to(dt) / torch.tensor(keep_prob, dtype=dt, device=x.device)
            weights = (weights.reshape(replicas, b // replicas, h, lq, lk) * multiplier).reshape(b, h, lq, lk)
        y = (weights @ v.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)  # [B, L, H, D]
        return self.out(y, dt, reduce)


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """flax ``LayerNorm``: float32 statistics by the fast variance, scale and
    bias in float32, one rounding back to ``x``'s dtype."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + norm.eps) * norm.weight
    return ((xf - mean) * mul + norm.bias).to(x.dtype)


class _Block(nn.Module):
    """Pre-norm transformer block: x + attn(LN(x)), then x + MLP(LN(x))."""

    def __init__(self, dim: int, heads: int, mlp_dim: int, dropout_rate: float, shards: int = 1):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.lns = nn.ModuleList([nn.LayerNorm(dim, eps=LAYERNORM_EPS) for _ in range(2)])
        self.attns = nn.ModuleList([_Attention(dim, heads, dropout_rate, shards)])
        self.mlp_in = nn.Linear(dim, mlp_dim // shards)
        self.mlp_out = nn.Linear(mlp_dim // shards, dim)

    def forward(self, x: torch.Tensor, dt: torch.dtype, train: bool, generator: torch.Generator | None, masks,
                replicas: int, reduce=None) -> torch.Tensor:
        h = self.attns[0](_layer_norm(x, self.lns[0]), dt, train, generator, replicas, reduce)
        x = x + dropout(h, self.dropout_rate, train, generator, masks)
        h = F.linear(_layer_norm(x, self.lns[1]), self.mlp_in.weight.to(dt)) + self.mlp_in.bias.to(dt)
        h = F.gelu(h, approximate="tanh")
        h = _product(h, self.mlp_out.weight.to(dt), dt, reduce, F.linear) + self.mlp_out.bias.to(dt)
        return x + dropout(h, self.dropout_rate, train, generator, masks)


class VisionTransformer(nn.Module):
    """ViT for 32x32 inputs: patchify (conv stride = patch) -> CLS token ->
    transformer blocks -> LayerNorm -> float32 logits head. Same surface
    as ``FailureAwareCNN``: ``forward(x, train=, generator=, masks=,
    replicas=)`` and ``features_and_logits`` (the CLS token after the final
    LayerNorm)."""

    def __init__(
        self,
        num_classes: int = 10,
        patch: int = 4,
        dim: int = 128,
        depth: int = 4,
        heads: int = 4,
        mlp_dim: int = 256,
        dropout_rate: float = 0.1,
        compute_dtype: str = "bfloat16",
        standardize_input: bool = False,
        image_size: int = 32,
        in_channels: int = 3,
        model_shards: int = 1,
    ):
        super().__init__()
        if not 0.0 <= dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must lie in [0, 1), got {dropout_rate}")
        if heads % model_shards or mlp_dim % model_shards:
            raise ValueError(f"{heads} heads and an MLP of {mlp_dim} do not split over a model axis of "
                             f"{model_shards}")
        self.dim, self.depth = dim, depth
        self.model_shards = model_shards
        self.model_reduce = None  # the sum over the model group (tensor_parallel_vit)
        self.dropout_rate = float(dropout_rate)
        self.compute_dtype = _DTYPES[compute_dtype]
        self.standardize_input = standardize_input
        self.patchify = nn.Conv2d(in_channels, dim, patch, stride=patch)
        tokens = (image_size // patch) ** 2 + 1
        self.cls = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, dim))
        for i in range(depth):
            self.add_module(f"block_{i}", _Block(dim, heads, mlp_dim, self.dropout_rate, model_shards))
        self.lns = nn.ModuleList([nn.LayerNorm(dim, eps=LAYERNORM_EPS)])
        self.head = nn.Linear(dim, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False, generator: torch.Generator | None = None,
                masks=None, replicas: int = 1) -> torch.Tensor:
        """NHWC images -> float32 logits. ``train`` turns dropout on, its
        masks drawn from ``generator`` (or, but for attention dropout, taken
        from ``masks``); ``replicas`` MC-dropout replicas folded into the
        batch each draw their own attention mask."""
        return self.features_and_logits(x, train, generator, masks, replicas)[1]

    def features_and_logits(self, x: torch.Tensor, train: bool = False, generator: torch.Generator | None = None,
                            masks=None, replicas: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
        """``(features, logits)``, both float32: the CLS token after the final
        LayerNorm (flax's sown features) and the head's logits."""
        dt = self.compute_dtype
        if self.standardize_input:
            x = standardize_image(x)
        b = x.shape[0]
        if b % replicas:
            raise ValueError(f"a batch of {b} does not fold {replicas} replicas")
        h = _conv(x.to(dt).permute(0, 3, 1, 2), self.patchify, dt, stride=self.patchify.stride)
        h = h.permute(0, 2, 3, 1).reshape(b, -1, self.dim)  # [B, tokens, dim], row-major patches
        h = torch.cat([self.cls.to(dt).expand(b, 1, self.dim), h], dim=1) + self.pos_embed.to(dt)
        h = dropout(h, self.dropout_rate, train, generator, masks)
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, dt, train, generator, masks, replicas, self.model_reduce)
        features = _layer_norm(h, self.lns[0])[:, 0].to(torch.float32)
        return features, F.linear(features, self.head.weight, self.head.bias)


_COLUMN = (".attns.0.query.", ".attns.0.key.", ".attns.0.value.")


def tp_shard_vit_params(mesh, state_dict: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """This rank's shard of a :class:`VisionTransformer` state dict over the
    mesh's ``model`` axis (T ranks, this one the t-th): the query, key and
    value kernels [dim, H, D] and biases [H, D] keep heads t H/T ..; ``out``
    [H, D, dim] keeps the same heads of its input; ``mlp_in`` keeps rows t
    M/T .. of its [M, dim] weight and of its bias, ``mlp_out`` those columns
    of its [dim, M] weight; every other tensor, ``out``'s and ``mlp_out``'s
    biases among them, is whole. It loads into ``VisionTransformer(...,
    model_shards=T)``. Raises where the heads or the MLP width do not
    divide T."""
    t, shards = mesh.index("model"), mesh.size("model")
    heads = state_dict["block_0.attns.0.query.weight"].shape[1]
    mlp = state_dict["block_0.mlp_in.weight"].shape[0]
    if heads % shards or mlp % shards:
        raise ValueError(f"{heads} heads and an MLP of {mlp} do not split over a model axis of {shards}")
    h, m = heads // shards, mlp // shards
    out = {}
    for k, v in state_dict.items():
        if any(c in k for c in _COLUMN):
            v = v[:, t * h:(t + 1) * h] if k.endswith("weight") else v[t * h:(t + 1) * h]
        elif ".attns.0.out.weight" in k:
            v = v[t * h:(t + 1) * h]
        elif ".mlp_in." in k:
            v = v[t * m:(t + 1) * m]
        elif k.endswith(".mlp_out.weight"):
            v = v[:, t * m:(t + 1) * m]
        out[k] = v.contiguous()
    return out


def tensor_parallel_vit(model: VisionTransformer, mesh) -> VisionTransformer:
    """This rank's tensor-parallel copy of ``model`` over the mesh's
    ``model`` axis: its shard (:func:`tp_shard_vit_params`) in a ViT of its
    heads and MLP width, whose forward sums each row-parallel product over
    the ``model`` group (every rank of the group runs it on the same
    images). The result equals ``model``'s forward up to the order of those
    sums and, in bf16, the float32 partial products' single rounding."""
    shards = mesh.size("model")
    blocks = [getattr(model, f"block_{i}") for i in range(model.depth)]
    attn = blocks[0].attns[0]
    heads = attn.query.out_shape[0]
    local = VisionTransformer(
        num_classes=model.head.out_features, patch=model.patchify.stride[0], dim=model.dim, depth=model.depth,
        heads=heads, mlp_dim=blocks[0].mlp_in.out_features, dropout_rate=model.dropout_rate,
        compute_dtype=str(model.compute_dtype).removeprefix("torch."), standardize_input=model.standardize_input,
        image_size=int(round((model.pos_embed.shape[1] - 1) ** 0.5)) * model.patchify.stride[0],
        in_channels=model.patchify.in_channels, model_shards=shards)
    local.load_state_dict(tp_shard_vit_params(mesh, model.state_dict()), strict=True)
    local.to(model.pos_embed.device)
    group = mesh.group("model")

    def reduce(t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    local.model_reduce = reduce  # also on a model axis of 1: the same arithmetic at every size
    return local.train(model.training)
