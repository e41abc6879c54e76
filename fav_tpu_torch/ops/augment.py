"""AugMix for corruption-robust training: the plain PyTorch versions of the
shear passes, the batched chain ops, the Dirichlet mix and the
Jensen-Shannon consistency loss.

Counterpart of ``fav_tpu/ops/augment.py``. Every op is batch-first with a
per-image magnitude and is the identity at magnitude 0, so "a random subset
of ops per chain" is a gate on each magnitude. The geometry (rotate, shear,
translate) runs as three scanline shear passes (rows, columns, rows: the
Paeth decomposition of ``_affine_scanline`` :102): on the card through
K9a/K9b (``ops/augment_cuda.py``), on the CPU or with ``plain=True``
through :func:`shift_rows` and :func:`shift_cols`, which compute the same
``(1 - f) * a + f * b`` of the two nearest source pixels, so both routes
give the same bits.

AugMix is split into a draw step and a deterministic transform, as the
port's random families are: :func:`augmix_draws` makes every random number
of a call from an explicit ``torch.Generator``, :func:`augmix_apply` is the
pure transform, and :func:`augmix` composes the two. ``torch.Generator``
cannot replay ``jax.random``'s threefry streams, so the parity tests feed
:func:`augmix_apply` the draws ``fav_tpu`` made. Only ``alpha=1`` (the
recipe's value, with closed forms for the Dirichlet and Beta draws) and
the base op pool are ported; ``alpha != 1`` needs a gamma sampler on an
explicit generator, and the ``freq``, ``occlude``, ``bars`` and ``bf16``
options wait with the rest of ROADMAP.md Queue 1 item 9.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from fav_tpu_torch.device import resolve_device

__all__ = [
    "NUM_OPS",
    "AugMixDraws",
    "shift_rows",
    "shift_cols",
    "shift_bounds",
    "affine_scanline",
    "posterize",
    "solarize",
    "autocontrast",
    "augmix_draws",
    "augmix_apply",
    "augmix",
    "js_consistency",
]

# magnitude-1 ceilings of the geometry ops (fav_tpu/ops/augment.py:57-60)
MAX_ROT = math.pi / 6.0  # ±30°
MAX_SHEAR = 0.3
MAX_TRANSLATE = 0.25  # fraction of the image side
# rotate, shear x, shear y, translate x, translate y, posterize, solarize, autocontrast
NUM_OPS = 8
_TINY = float(np.finfo(np.float32).tiny)


def _shift(x: torch.Tensor, delta: torch.Tensor, max_shift: int, axis: int) -> torch.Tensor:
    """The shift of NHWC ``x`` along ``axis`` (2: columns within a row, 1:
    rows within a column) by ``delta`` per (image, row) or (image, column)."""
    b, h, w, c = x.shape
    m = int(max_shift)
    delta = torch.clamp(delta, -m, m - 1)
    lo = torch.floor(delta)
    n = x.shape[axis]
    pos = torch.arange(n, device=x.device)
    if axis == 2:  # delta (B, H): rows
        base = pos.view(1, 1, w) + lo.long().view(b, h, 1)
        frac = (delta - lo).to(x.dtype).view(b, h, 1, 1)
    else:  # delta (B, W): columns
        base = pos.view(1, h, 1) + lo.long().view(b, 1, w)
        frac = (delta - lo).to(x.dtype).view(b, 1, w, 1)
    i0 = base.clamp(0, n - 1).unsqueeze(-1).expand(b, h, w, c)
    i1 = (base + 1).clamp(0, n - 1).unsqueeze(-1).expand(b, h, w, c)
    return (1.0 - frac) * torch.gather(x, axis, i0) + frac * torch.gather(x, axis, i1)


def shift_rows(x: torch.Tensor, delta: torch.Tensor, max_shift: int) -> torch.Tensor:
    """The plain version of K9a, ``_shift_rows`` (:63): ``out[b, y, x] =
    x[b, y, x + delta[b, y]]`` with linear interpolation between the two
    nearest columns and clamped edges; ``delta`` (B, H) is clipped to
    [-max_shift, max_shift - 1]."""
    return _shift(x, delta, max_shift, 2)


def shift_cols(x: torch.Tensor, delta: torch.Tensor, max_shift: int) -> torch.Tensor:
    """The plain version of K9b, ``_shift_cols`` (:118): ``out[b, y, x] =
    x[b, y + delta[b, x], x]``, ``delta`` (B, W)."""
    return _shift(x, delta, max_shift, 1)


def shift_bounds(h: int, w: int) -> tuple[int, int]:
    """The static shift bounds (row pass, column pass) of the magnitude-1
    ceilings: (18, 22) at 32x32."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    mx = int(math.ceil((math.tan(MAX_ROT / 2) + MAX_SHEAR) * max(cy, 1.0) + MAX_TRANSLATE * w)) + 1
    my = int(math.ceil((math.sin(MAX_ROT) + MAX_SHEAR) * max(cx, 1.0) + MAX_TRANSLATE * h)) + 1
    return mx, my


def affine_scanline(x: torch.Tensor, theta: torch.Tensor, shear_x: torch.Tensor, shear_y: torch.Tensor,
                    tx: torch.Tensor, ty: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Batched rotate, shear and translate of float32 NHWC ``x`` by three
    scanline passes: shear_x(-tan θ/2) ∘ shear_y(sin θ) ∘ shear_x(-tan θ/2),
    the shear and translate knobs folded into the passes. The knobs are [B];
    all at 0 give ``x`` exactly. On the card the passes are K9a, K9b, K9a
    unless ``plain`` asks for the plain versions; on the CPU the plain
    versions run."""
    b, h, w, c = x.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = (torch.arange(h, dtype=torch.float32, device=x.device) - cy).view(1, h)
    xs = (torch.arange(w, dtype=torch.float32, device=x.device) - cx).view(1, w)
    t_half = torch.tan(theta / 2.0).view(b, 1)
    s_th = torch.sin(theta).view(b, 1)
    mx, my = shift_bounds(h, w)
    if plain or x.device.type == "cpu":
        rows, cols = shift_rows, shift_cols
    else:
        from fav_tpu_torch.ops.augment_cuda import shear_cols as cols
        from fav_tpu_torch.ops.augment_cuda import shear_rows as rows
    out = rows(x, (-t_half + shear_x.view(b, 1)) * ys + tx.view(b, 1), mx)
    out = cols(out, (s_th + shear_y.view(b, 1)) * xs + ty.view(b, 1), my)
    return rows(out, -t_half * ys, mx)


def _per_image(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.view(-1, 1, 1, 1).to(x.dtype)


def posterize(x: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    """256 levels at magnitude 0 down to 4 at magnitude 1; rounds half to even."""
    levels = _per_image(torch.round(256.0 - 252.0 * mag), x)
    return torch.round(x * (levels - 1.0)) / (levels - 1.0)


def solarize(x: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    """Inverts values strictly above 1 - 0.7 mag (nothing at magnitude 0)."""
    thresh = _per_image(1.0 - 0.7 * mag, x)
    return torch.where(x > thresh, 1.0 - x, x)


def autocontrast(x: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    """Moves each image toward its per-channel min-max stretch over (H, W) by ``mag``."""
    lo = torch.amin(x, dim=(1, 2), keepdim=True)
    hi = torch.amax(x, dim=(1, 2), keepdim=True)
    stretched = (x - lo) / torch.clamp(hi - lo, min=1e-6)
    return x + _per_image(mag, x) * (stretched - x)


class AugMixDraws(NamedTuple):
    """Every random number of one :func:`augmix` call over B images and
    ``width`` chains. The chain rows are chain-major: row ``k * B + i`` is
    chain ``k`` of image ``i``. Knobs are signed and scaled as
    ``_affine_scanline`` takes them (radians, shear, pixels); the pointwise
    magnitudes are in [0, 1]; a gated-off op has 0."""

    ws: torch.Tensor  # [B, width] Dirichlet(1) mixing weights
    blend: torch.Tensor  # [B] Beta(1, 1) weight of the original
    theta: torch.Tensor  # [width * B]
    shear_x: torch.Tensor
    shear_y: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor
    posterize: torch.Tensor
    solarize: torch.Tensor
    autocontrast: torch.Tensor


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"augmix: {what} is not ported yet (ROADMAP.md Queue 1 item 9)")


def augmix_draws(generator: torch.Generator, b: int, width: int = 3, max_depth: int = 3, alpha: float = 1.0,
                 image_size: tuple[int, int] = (32, 32)) -> AugMixDraws:
    """The draws of :func:`augmix` for ``b`` images of ``image_size`` (H, W),
    on the generator's device, by ``fav_tpu``'s laws (``augment.py:465-506``
    and ``_chain`` :310-348): Dirichlet(1) weights as normalised
    exponentials, a U(0, 1) blend, each op gated with p = (1 + max_depth) /
    2 / NUM_OPS, U(0, 1) magnitudes and a fair sign per geometry knob."""
    if alpha != 1.0:
        raise _not_ported(f"alpha={alpha} (needs a gamma sampler on an explicit generator)")
    dev = generator.device
    h, w = image_size
    n = width * b

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev, dtype=torch.float32)

    e = -torch.log(torch.clamp(rand(b, width), min=_TINY))  # u in [tiny, 1): e > 0
    ws = e / e.sum(dim=-1, keepdim=True)
    blend = rand(b)
    gate_p = (1.0 + max_depth) / 2.0 / NUM_OPS
    gates = (rand(NUM_OPS, n) < gate_p).to(torch.float32)
    mags = rand(NUM_OPS, n) * gates
    signs = torch.where(rand(5, n) < 0.5, 1.0, -1.0)
    signed = signs * mags[:5]
    return AugMixDraws(
        ws=ws, blend=blend,
        theta=signed[0] * MAX_ROT, shear_x=signed[1] * MAX_SHEAR, shear_y=signed[2] * MAX_SHEAR,
        tx=signed[3] * MAX_TRANSLATE * w, ty=signed[4] * MAX_TRANSLATE * h,
        posterize=mags[5], solarize=mags[6], autocontrast=mags[7],
    )


def augmix_apply(images: torch.Tensor, draws: AugMixDraws, plain: bool = False) -> torch.Tensor:
    """The deterministic AugMix transform of float32 NHWC ``images`` under
    ``draws``: replicate to ``width`` chains, one batched affine (K9a/K9b on
    the card unless ``plain``), posterize, solarize and autocontrast, the
    Dirichlet mix of the chains and the blend with the original, clipped to
    [0, 1]."""
    x = images.to(torch.float32)
    b = x.shape[0]
    width = draws.ws.shape[1]
    chains = affine_scanline(x.repeat(width, 1, 1, 1), draws.theta, draws.shear_x, draws.shear_y,
                             draws.tx, draws.ty, plain=plain)
    chains = autocontrast(solarize(posterize(chains, draws.posterize), draws.solarize), draws.autocontrast)
    chains = chains.view(width, *x.shape)
    mix = draws.ws[:, 0].view(b, 1, 1, 1) * chains[0]
    for k in range(1, width):
        mix = mix + draws.ws[:, k].view(b, 1, 1, 1) * chains[k]
    blend = draws.blend.view(b, 1, 1, 1)
    return torch.clamp(blend * x + (1.0 - blend) * mix, 0.0, 1.0)


def augmix(generator: torch.Generator, images, width: int = 3, max_depth: int = 3, alpha: float = 1.0,
           freq: bool = False, occlude: bool = False, bars: bool = False, bf16: bool = False,
           plain: bool = False) -> torch.Tensor:
    """AugMix a [B, H, W, C] batch: :func:`augmix_draws` from ``generator``,
    then :func:`augmix_apply`. A tensor stays on its device; anything else
    goes to the card. ``generator`` must lie on that device."""
    for name, on in (("freq", freq), ("occlude", occlude), ("bars", bars), ("bf16", bf16)):
        if on:
            raise _not_ported(f"{name}=True")
    if isinstance(images, torch.Tensor):
        dev = resolve_device(images.device)
    else:
        dev = resolve_device(None)
        images = torch.as_tensor(np.asarray(images, dtype=np.float32), device=dev)
    if generator.device.type != dev.type:
        raise ValueError(f"augmix: the generator lies on {generator.device}, the images on {dev}")
    b, h, w, _ = images.shape
    draws = augmix_draws(generator, b, width, max_depth, alpha, (h, w))
    return augmix_apply(images, draws, plain=plain)


def js_consistency(logits_clean: torch.Tensor, logits_a: torch.Tensor, logits_b: torch.Tensor) -> torch.Tensor:
    """Jensen-Shannon divergence across the three predictive distributions
    (the AugMix consistency loss), probabilities clipped to [1e-7, 1] before
    their logs."""
    p = [torch.softmax(z, dim=-1) for z in (logits_clean, logits_a, logits_b)]
    m = torch.clamp((p[0] + p[1] + p[2]) / 3.0, 1e-7, 1.0)
    logm = torch.log(m)
    kl = [torch.sum(q * (torch.log(torch.clamp(q, 1e-7, 1.0)) - logm), dim=-1) for q in p]
    return torch.mean((kl[0] + kl[1] + kl[2]) / 3.0)
