"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. With no
card and no explicit ``"cpu"`` they raise: nothing carries on quietly on
the host.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device is returned only when one is
    available; otherwise this raises ``RuntimeError``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fav_tpu_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
