"""The evaluation grid's L1 pass: the signal analyzer over a corrupted batch.

Counterpart of ``fav_tpu/parallel/sweep.py:_l1_rows`` (:75-92); the rest of
the sweep is not ported yet.
"""

from __future__ import annotations

import torch

from fav_tpu_torch.config import AnalyzerParams
from fav_tpu_torch.ops.signal import analyze_frame, init_analyzer_carry

__all__ = ["l1_rows"]

# the reference analyzer constants, as the grid uses them
_L1_PARAMS = AnalyzerParams()


def l1_rows(corrupted: torch.Tensor, plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The L1 analyzer over one cell's corrupted batch: float32 RGB in
    [0, 1], [B, H, W, C] -> per-sample ``(status int32 [B], anomaly float32
    [B])``.

    Each image becomes a BGR uint8 frame, ``round(x 255)`` (half to even,
    as ``jnp.round``), analyzed with a fresh carry: no temporal context, so
    FROZEN cannot fire and the rows depend only on the batch. On the card
    the statistics come from one K7 launch, unless ``plain`` asks for the
    plain versions."""
    frames = torch.round(corrupted.flip(-1) * 255.0).to(torch.uint8)
    carry = init_analyzer_carry(corrupted.shape[-3], corrupted.shape[-2], corrupted.shape[:-3],
                                device=corrupted.device)
    _, m = analyze_frame(_L1_PARAMS, carry, frames, plain=plain)
    return m.status, m.anomaly_score
