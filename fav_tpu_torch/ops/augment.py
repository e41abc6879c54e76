"""AugMix for corruption-robust training: the plain PyTorch versions of the
shear passes, the batched chain ops, the Dirichlet mix and the
Jensen-Shannon consistency loss.

Counterpart of ``fav_tpu/ops/augment.py``. Every op is batch-first with a
per-image magnitude and is the identity at magnitude 0, so "a random subset
of ops per chain" is a gate on each magnitude. The geometry (rotate, shear,
translate) runs as three scanline shear passes (rows, columns, rows: the
Paeth decomposition of ``_affine_scanline`` :102): on the card through
K9a/K9b (``ops/augment_cuda.py``, float32 or bfloat16), on the CPU or with
``plain=True`` through :func:`shift_rows` and :func:`shift_cols`, which
compute the same ``(1 - f) * a + f * b`` of the two nearest source pixels
with the same roundings, so both routes give the same bits.

AugMix is split into a draw step and a deterministic transform, as the
port's random families are: :func:`augmix_draws` makes every random number
of a call from an explicit ``torch.Generator``, :func:`augmix_apply` is the
pure transform, and :func:`augmix` composes the two. ``torch.Generator``
cannot replay ``jax.random``'s threefry streams, so the parity tests feed
:func:`augmix_apply` the draws ``fav_tpu`` made; the port follows the
reference's laws, not its key schedule. Every option of ``augmix`` is
here: ``alpha != 1`` (Dirichlet and Beta as normalised gamma draws), the
``freq`` (spectral band gains), ``occlude`` (two rectangles) and ``bars``
(three rotated bars) ops, which join the op pool and the gate's
denominator, and ``bf16``, which runs the chain in bfloat16 while the
draws, the shift arithmetic and the mixing tail stay float32.
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
    "freq_band",
    "occlude",
    "occlude_bars",
    "num_ops",
    "augmix_draws",
    "shard_draws",
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
    """Batched rotate, shear and translate of NHWC ``x`` (float32 or bfloat16) by three
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


def _axis(n: int, device) -> torch.Tensor:
    """``arange(n) / (n - 1)`` in float32, divided by a 0-dim tensor so that
    CUDA does not take the reciprocal's product."""
    return torch.arange(n, dtype=torch.float32, device=device) / torch.tensor(float(n - 1), device=device)


def freq_band(x: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """``_freq_band`` (:181): the image's radial spectral octaves (edges 0,
    1/8, 1/4, 1/2 of Nyquist and beyond) scaled by ``gains`` [B, 4], the DC
    term kept; float32 FFTs, clipped to [0, 1], back in ``x``'s dtype."""
    b, h, w, c = x.shape
    dev = x.device
    f = torch.fft.rfft2(x.to(torch.float32), dim=(1, 2))  # [B, H, W//2+1, C]
    ar = torch.arange(h, device=dev)
    fy = torch.minimum(ar, h - ar).to(torch.float32) / (h / 2)
    fx = torch.arange(w // 2 + 1, device=dev).to(torch.float32) / (w / 2)
    r = torch.sqrt(fy[:, None] ** 2 + fx[None, :] ** 2)
    edges = torch.tensor([0.125, 0.25, 0.5, 10.0], device=dev)
    band = (r[None] >= edges[:, None, None]).sum(dim=0).clamp(0, 3)  # [H, W//2+1] in 0..3
    field = gains[:, band]  # [B, H, W//2+1]
    field = torch.where(r[None] == 0.0, torch.ones((), device=dev), field)
    out = torch.fft.irfft2(f * field[..., None], s=(h, w), dim=(1, 2))
    return torch.clamp(out, 0.0, 1.0).to(x.dtype)


def _fill(x: torch.Tensor, mask: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None], value.to(x.dtype).view(-1, 1, 1, 1), x)


def occlude(x: torch.Tensor, ctr: torch.Tensor, half: torch.Tensor, fill: torch.Tensor) -> torch.Tensor:
    """``_occlude`` (:216): each rectangle ``r`` (centre ``ctr[:, r]`` (y, x)
    and half-extents ``half[:, r]`` as fractions of the side, [B, R, 2])
    replaced by the constant ``fill[:, r]``; strict ``<``, so half-extents
    of 0 change nothing."""
    b, h, w, _ = x.shape
    ys = _axis(h, x.device).view(1, 1, h)
    xs = _axis(w, x.device).view(1, 1, w)
    in_y = (ys - ctr[:, :, 0:1]).abs() < half[:, :, 0:1]  # [B, R, H]
    in_x = (xs - ctr[:, :, 1:2]).abs() < half[:, :, 1:2]  # [B, R, W]
    for r in range(ctr.shape[1]):
        x = _fill(x, in_y[:, r, :, None] & in_x[:, r, None, :], fill[:, r])
    return x


def occlude_bars(x: torch.Tensor, ctr: torch.Tensor, angle: torch.Tensor, half_len: torch.Tensor,
                 half_wid: torch.Tensor, fill: torch.Tensor) -> torch.Tensor:
    """``_occlude_bars`` (:254): each bar ``r`` (centre ``ctr[:, r]`` (y, x),
    [B, R, 2]; ``angle``, ``half_len``, ``half_wid`` and ``fill`` [B, R]) a
    rotated rectangle replaced by its constant; strict ``<``."""
    b, h, w, _ = x.shape
    ys = _axis(h, x.device).view(1, 1, h, 1)
    xs = _axis(w, x.device).view(1, 1, 1, w)
    dy = ys - ctr[:, :, 0, None, None]  # [B, R, H, 1]
    dx = xs - ctr[:, :, 1, None, None]  # [B, R, 1, W]
    c = torch.cos(angle)[:, :, None, None]
    s = torch.sin(angle)[:, :, None, None]
    along = dx * c + dy * s  # [B, R, H, W]
    across = dy * c - dx * s
    for r in range(ctr.shape[1]):
        m = (along[:, r].abs() < half_len[:, r, None, None]) & (across[:, r].abs() < half_wid[:, r, None, None])
        x = _fill(x, m, fill[:, r])
    return x


class AugMixDraws(NamedTuple):
    """Every random number of one :func:`augmix` call over B images and
    ``width`` chains. The chain rows are chain-major: row ``k * B + i`` is
    chain ``k`` of image ``i``. Knobs are signed and scaled as
    ``_affine_scanline`` takes them (radians, shear, pixels); the pointwise
    magnitudes are in [0, 1]; a gated-off op has 0. The options' fields are
    None where the option is off; their extents already carry the op's
    magnitude (0 where gated off)."""

    ws: torch.Tensor  # [B, width] Dirichlet(alpha) mixing weights
    blend: torch.Tensor  # [B] Beta(alpha, alpha) weight of the original
    theta: torch.Tensor  # [width * B]
    shear_x: torch.Tensor
    shear_y: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor
    posterize: torch.Tensor
    solarize: torch.Tensor
    autocontrast: torch.Tensor
    freq_gains: torch.Tensor | None = None  # [n, 4] exp(U(-1, 1) mag log 4)
    occ_ctr: torch.Tensor | None = None  # [n, 2, 2] U(0, 1) (y, x)
    occ_half: torch.Tensor | None = None  # [n, 2, 2] U(0, 1) 0.3 mag
    occ_fill: torch.Tensor | None = None  # [n, 2] U(0, 1)
    bar_ctr: torch.Tensor | None = None  # [n, 3, 2] U(0, 1) (y, x)
    bar_angle: torch.Tensor | None = None  # [n, 3] U(0, pi)
    bar_len: torch.Tensor | None = None  # [n, 3] U(0, 1) 0.45 mag
    bar_wid: torch.Tensor | None = None  # [n, 3] U(0, 1) 0.08 mag
    bar_fill: torch.Tensor | None = None  # [n, 3] U(0, 1)


def num_ops(freq: bool = False, occlude: bool = False, bars: bool = False) -> int:
    """The op pool's size: the base ops and each option that is on."""
    return NUM_OPS + int(freq) + int(occlude) + int(bars)


def augmix_draws(generator: torch.Generator, b: int, width: int = 3, max_depth: int = 3, alpha: float = 1.0,
                 image_size: tuple[int, int] = (32, 32), freq: bool = False, occlude: bool = False,
                 bars: bool = False) -> AugMixDraws:
    """The draws of :func:`augmix` for ``b`` images of ``image_size`` (H, W),
    on the generator's device, by ``fav_tpu``'s laws (``augment.py:465-506``
    and ``_chain`` :310-361): Dirichlet(alpha) weights and a Beta(alpha,
    alpha) blend (at alpha 1 normalised exponentials and a U(0, 1); else
    normalised gamma draws), each op gated with p = (1 + max_depth) / 2 /
    the pool's size, U(0, 1) magnitudes and a fair sign per geometry knob;
    then the options' own draws (``_freq_band`` :205-208, ``_occlude``
    :238-243, ``_occlude_bars`` :277-285)."""
    dev = generator.device
    h, w = image_size
    n = width * b

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev, dtype=torch.float32)

    def gamma(*shape):
        return torch._standard_gamma(torch.full(shape, float(alpha), device=dev), generator=generator)

    if alpha == 1.0:
        e = -torch.log(torch.clamp(rand(b, width), min=_TINY))  # u in [tiny, 1): e > 0
        ws = e / e.sum(dim=-1, keepdim=True)
        blend = rand(b)
    else:
        g = gamma(b, width)
        ws = g / g.sum(dim=-1, keepdim=True)
        pair = gamma(2, b)
        blend = pair[0] / (pair[0] + pair[1])
    n_ops = num_ops(freq, occlude, bars)
    gate_p = (1.0 + max_depth) / 2.0 / n_ops
    gates = (rand(n_ops, n) < gate_p).to(torch.float32)
    mags = rand(n_ops, n) * gates
    signs = torch.where(rand(5, n) < 0.5, 1.0, -1.0)
    signed = signs * mags[:5]
    extra = {}
    nxt = NUM_OPS
    if freq:
        extra["freq_gains"] = torch.exp((rand(n, 4) * 2.0 - 1.0) * mags[nxt][:, None] * math.log(4.0))
        nxt += 1
    if occlude:
        extra.update(occ_ctr=rand(n, 2, 2), occ_half=rand(n, 2, 2) * (0.30 * mags[nxt])[:, None, None],
                     occ_fill=rand(n, 2))
        nxt += 1
    if bars:
        extra.update(bar_ctr=rand(n, 3, 2), bar_angle=rand(n, 3) * math.pi,
                     bar_len=rand(n, 3) * (0.45 * mags[nxt])[:, None],
                     bar_wid=rand(n, 3) * (0.08 * mags[nxt])[:, None], bar_fill=rand(n, 3))
    return AugMixDraws(
        ws=ws, blend=blend,
        theta=signed[0] * MAX_ROT, shear_x=signed[1] * MAX_SHEAR, shear_y=signed[2] * MAX_SHEAR,
        tx=signed[3] * MAX_TRANSLATE * w, ty=signed[4] * MAX_TRANSLATE * h,
        posterize=mags[5], solarize=mags[6], autocontrast=mags[7], **extra,
    )


def shard_draws(draws: AugMixDraws, rows: slice) -> AugMixDraws:
    """The draws of images ``rows`` of a batch: what :func:`augmix_apply`
    takes for those images alone, so that a data shard augments its rows as
    the whole batch's call does (every op is per image)."""
    b = draws.blend.shape[0]
    width = draws.ws.shape[1]

    def cut(v):
        if v is None:
            return None
        if v.shape[0] == b:
            return v[rows]
        return v.view(width, b, *v.shape[1:])[:, rows].reshape(-1, *v.shape[1:])  # chain-major rows

    return AugMixDraws(*(cut(v) for v in draws))


def augmix_apply(images: torch.Tensor, draws: AugMixDraws, plain: bool = False, bf16: bool = False) -> torch.Tensor:
    """The deterministic AugMix transform of NHWC ``images`` under ``draws``:
    replicate to ``width`` chains, one batched affine (K9a/K9b on the card
    unless ``plain``), posterize, solarize and autocontrast, then the
    options the draws hold (freq, occlude, bars, in ``_chain``'s order), the
    Dirichlet mix of the chains and the blend with the original, clipped to
    [0, 1]. ``bf16`` runs the chains in bfloat16 (the mix stays float32);
    the result has the input's dtype."""
    x = images.to(torch.float32)
    b = x.shape[0]
    width = draws.ws.shape[1]
    rep = x.to(torch.bfloat16 if bf16 else torch.float32).repeat(width, 1, 1, 1)
    chains = affine_scanline(rep, draws.theta, draws.shear_x, draws.shear_y, draws.tx, draws.ty, plain=plain)
    chains = autocontrast(solarize(posterize(chains, draws.posterize), draws.solarize), draws.autocontrast)
    if draws.freq_gains is not None:
        chains = freq_band(chains, draws.freq_gains)
    if draws.occ_ctr is not None:
        chains = occlude(chains, draws.occ_ctr, draws.occ_half, draws.occ_fill)
    if draws.bar_ctr is not None:
        chains = occlude_bars(chains, draws.bar_ctr, draws.bar_angle, draws.bar_len, draws.bar_wid, draws.bar_fill)
    chains = chains.to(torch.float32).view(width, *x.shape)
    mix = draws.ws[:, 0].view(b, 1, 1, 1) * chains[0]
    for k in range(1, width):
        mix = mix + draws.ws[:, k].view(b, 1, 1, 1) * chains[k]
    blend = draws.blend.view(b, 1, 1, 1)
    return torch.clamp(blend * x + (1.0 - blend) * mix, 0.0, 1.0).to(images.dtype)


def augmix(generator: torch.Generator, images, width: int = 3, max_depth: int = 3, alpha: float = 1.0,
           freq: bool = False, occlude: bool = False, bars: bool = False, bf16: bool = False,
           plain: bool = False) -> torch.Tensor:
    """AugMix a [B, H, W, C] batch: :func:`augmix_draws` from ``generator``,
    then :func:`augmix_apply`. A tensor stays on its device; anything else
    goes to the card. ``generator`` must lie on that device."""
    if isinstance(images, torch.Tensor):
        dev = resolve_device(images.device)
    else:
        dev = resolve_device(None)
        images = torch.as_tensor(np.asarray(images, dtype=np.float32), device=dev)
    if generator.device.type != dev.type:
        raise ValueError(f"augmix: the generator lies on {generator.device}, the images on {dev}")
    b, h, w, _ = images.shape
    draws = augmix_draws(generator, b, width, max_depth, alpha, (h, w), freq, occlude, bars)
    return augmix_apply(images, draws, plain=plain, bf16=bf16)


def js_consistency(logits_clean: torch.Tensor, logits_a: torch.Tensor, logits_b: torch.Tensor) -> torch.Tensor:
    """Jensen-Shannon divergence across the three predictive distributions
    (the AugMix consistency loss), probabilities clipped to [1e-7, 1] before
    their logs."""
    p = [torch.softmax(z, dim=-1) for z in (logits_clean, logits_a, logits_b)]
    m = torch.clamp((p[0] + p[1] + p[2]) / 3.0, 1e-7, 1.0)
    logm = torch.log(m)
    kl = [torch.sum(q * (torch.log(torch.clamp(q, 1e-7, 1.0)) - logm), dim=-1) for q in p]
    return torch.mean((kl[0] + kl[1] + kl[2]) / 3.0)
