"""Counter-based uniform draws shared by the CUDA kernels and their plain versions.

The TPU kernels draw from the TPU's hardware PRNG
(``fav_tpu/ops/corruptions_pallas.py:73-90``), whose bits no other device
reproduces. The port uses Philox4x32-10 (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", SC'11), written twice: in CUDA in
``csrc/corruptions.cu`` and here in plain PyTorch. Both give bit-identical
words, so a kernel is held to its plain version element by element.

Stream layout. A seed ``s`` (``0 <= s < 2**64``) is the key
``(s & 0xffffffff, s >> 32)``. Element ``e`` of a flat tensor takes draw
``d`` from word ``e % 4`` of ``philox(counter=(g & 0xffffffff, g >> 32, d, 0))``
with ``g = e // 4``: one Philox call feeds four neighbouring elements, which
is what a CUDA thread holding one float4 computes.

uint32 arithmetic is emulated in int64 tensors; the 32x32 -> 64-bit product
that Philox needs is split into 16-bit halves so no intermediate leaves
int64's range.
"""

from __future__ import annotations

import torch

__all__ = ["philox4x32", "seed_key", "random_words", "uniform01", "bits_to_uniform"]

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
PHILOX_ROUNDS = 10
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of the 64-bit product ``m * b``; ``m`` a
    constant below 2**32, ``b`` int64 values below 2**32."""
    p_lo = m * (b & 0xFFFF)  # < 2**48
    p_hi = m * (b >> 16)  # < 2**48; product = p_hi * 2**16 + p_lo
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32(
    counter: tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
    key: tuple[int, int],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Philox4x32-10 on int64 tensors holding uint32 values."""
    c0, c1, c2, c3 = counter
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK32
            k1 = (k1 + PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def seed_key(seed: int) -> tuple[int, int]:
    """The Philox key (low word, high word) of a seed in [0, 2**64)."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must lie in [0, 2**64), got {seed}")
    return seed & _MASK32, seed >> 32


def random_words(seed: int, n: int, draw: int = 0, device=None) -> torch.Tensor:
    """The ``n`` uint32 words (as int64) of draw ``draw`` for a flat tensor
    of ``n`` elements, in the stream layout of the module docstring."""
    groups = (n + 3) // 4
    g = torch.arange(groups, dtype=torch.int64, device=device)
    const = torch.full_like(g, int(draw) & _MASK32)
    words = philox4x32((g & _MASK32, g >> 32, const, torch.zeros_like(g)), seed_key(seed))
    return torch.stack(words, dim=1).reshape(-1)[:n]


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 in (0, 1]: the top 24 bits, offset by half a
    step so that 0 never occurs and ``log(u)`` stays finite, as
    ``corruptions_pallas.py:73-82`` maps them (the greatest word, 1 - 2**-25,
    rounds to 1.0)."""
    top24 = (bits >> 8).to(torch.float32)
    return top24 * (1.0 / (1 << 24)) + (0.5 / (1 << 24))


def uniform01(seed: int, n: int, draw: int = 0, device=None) -> torch.Tensor:
    """``n`` float32 uniforms in (0, 1] of draw ``draw`` under ``seed``."""
    return bits_to_uniform(random_words(seed, n, draw, device))
