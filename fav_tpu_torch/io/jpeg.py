"""JPEG encoding for the browser stream.

Parity target: ``platform/backend/main.py:97-100`` — base64 JPEG at quality
40 attached to the WS state as ``video_frame``. Encoder priority:

1. the native C++ encoder (:mod:`fav_tpu_torch.native`) when its shared
   library builds — keeps the hot 30 Hz path off the Python heap,
2. cv2's ``imencode`` (what the reference uses),
3. Pillow as a last resort.
"""

from __future__ import annotations

import base64
from typing import Optional

import numpy as np

from fav_tpu_torch.config import VideoParams

try:
    import cv2  # type: ignore

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    cv2 = None
    _HAS_CV2 = False

__all__ = ["encode_jpeg", "frame_to_base64_jpeg", "last_encoder"]

_last_encoder: Optional[str] = None


def last_encoder() -> Optional[str]:
    """Which encoder produced the last JPEG: ``"native"``, ``"cv2"``,
    ``"pillow"``, or None before the first (or when every one failed)."""
    return _last_encoder


def _native(frame_bgr: np.ndarray, quality: int) -> Optional[bytes]:
    from fav_tpu_torch.native import jpeg_encode_bgr  # noqa: PLC0415

    try:
        return jpeg_encode_bgr(frame_bgr, quality)
    except RuntimeError:  # libjpeg or g++ missing: the library did not build
        return None


def _cv2(frame_bgr: np.ndarray, quality: int) -> Optional[bytes]:
    if not _HAS_CV2:
        return None
    ok, buf = cv2.imencode(".jpg", frame_bgr, [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    return buf.tobytes() if ok else None


def _pillow(frame_bgr: np.ndarray, quality: int) -> Optional[bytes]:
    try:
        import io

        from PIL import Image

        img = Image.fromarray(np.ascontiguousarray(frame_bgr[..., ::-1]))  # BGR -> RGB
        out = io.BytesIO()
        img.save(out, format="JPEG", quality=quality)
        return out.getvalue()
    except Exception:
        return None


_ENCODERS = (("native", _native), ("cv2", _cv2), ("pillow", _pillow))


def encode_jpeg(frame_bgr: np.ndarray, quality: int = 40) -> Optional[bytes]:
    """The first encoder of native, cv2, Pillow that returns bytes."""
    global _last_encoder
    for name, encoder in _ENCODERS:
        data = encoder(frame_bgr, quality)
        if data:
            _last_encoder = name
            return data
    _last_encoder = None
    return None


def frame_to_base64_jpeg(frame_bgr: np.ndarray, quality: int | None = None) -> Optional[str]:
    """Reference-exact wire format (main.py:97-100)."""
    q = VideoParams().jpeg_quality if quality is None else quality
    data = encode_jpeg(frame_bgr, q)
    return base64.b64encode(data).decode() if data else None
