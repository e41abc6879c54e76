"""Native host layer: the C++ JPEG codec and area resize through ctypes.

The port's counterpart of ``fav_tpu/native``, with the same functions and
C interface. Two libraries, each built by ``g++`` at first use into
``build/native/`` under the repository root (``<name>-<hash>.so``, the hash
over the source, the flags and the machine), never beside the source:

* ``resize_area.cpp``: ``fav_resize_area_u8``, the INTER_AREA box resize
  that makes every live frame the CNN's 32x32 input. It needs no libjpeg,
  so it builds wherever ``g++`` runs.
* ``jpegio.cpp``: the libjpeg encode (direct BGR input) for the 30 Hz
  browser stream and the decode for uploads, linked with ``-ljpeg``.

Nothing builds at import. The server builds both when it is created
(:func:`prebuild`), so that no live frame waits for ``g++``: a build holds
a lock that every encode and resize would queue behind. A library that
cannot build raises ``RuntimeError`` from the call that needs it, once
built or not; ``fav_tpu_torch.io.jpeg`` then encodes with cv2 or Pillow,
as ``fav_tpu``'s does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["jpeg_encode_bgr", "jpeg_decode_bgr", "resize_area", "lib_path", "build_dir", "prebuild", "SRC_DIR"]

SRC_DIR = Path(__file__).resolve().parent / "src"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
_LINK = {"resize_area": (), "jpegio": ("-ljpeg",)}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_errors: dict[str, str] = {}


def build_dir() -> Path:
    return SRC_DIR.parents[2] / "build" / "native"


def lib_path(name: str) -> Path:
    """Where ``src/<name>.cpp`` builds to."""
    src = SRC_DIR / f"{name}.cpp"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(CXX_FLAGS + _LINK[name]).encode())
    h.update(platform.machine().encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def _build(name: str, lib: Path) -> None:
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, str(SRC_DIR / f"{name}.cpp"), *_LINK[name], "-o", str(tmp)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not build {name}.cpp: {e}") from e
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ could not build {name}.cpp:\n{out.stderr.strip()}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing


def _load(name: str) -> ctypes.CDLL:
    """The loaded library of ``src/<name>.cpp``, built on first use; a
    failed build is remembered and raised again without a second try."""
    lib = _libs.get(name)
    if lib is not None:  # the hot path: no lock once loaded
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if name in _errors:
            raise RuntimeError(_errors[name])
        try:
            path = lib_path(name)
            if not path.exists():
                _build(name, path)
            lib = ctypes.CDLL(str(path))
        except (RuntimeError, OSError) as e:
            _errors[name] = str(e)
            raise RuntimeError(_errors[name]) from e
        if name == "resize_area":
            lib.fav_resize_area_u8.restype = ctypes.c_int
            lib.fav_resize_area_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ]
        else:
            lib.fav_jpeg_encode_bgr.restype = ctypes.c_int
            lib.fav_jpeg_encode_bgr.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_ulong),
            ]
            lib.fav_jpeg_decode_bgr.restype = ctypes.c_int
            lib.fav_jpeg_decode_bgr.argtypes = [
                ctypes.c_void_p, ctypes.c_ulong, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ]
            lib.fav_free.restype = None
            lib.fav_free.argtypes = [ctypes.c_void_p]
        _libs[name] = lib
        return lib


def prebuild() -> dict[str, str]:
    """Build and load both libraries now; returns each one's path, or the
    reason it did not build (libjpeg's headers may be missing)."""
    out = {}
    for name in _LINK:
        try:
            _load(name)
            out[name] = str(lib_path(name))
        except RuntimeError as e:
            out[name] = f"not built: {str(e).splitlines()[0]}"
    return out


def jpeg_encode_bgr(frame: np.ndarray, quality: int = 40) -> bytes | None:
    """BGR uint8 HxWx3 -> JPEG bytes (reference wire format, main.py:97-100)."""
    lib = _load("jpegio")
    frame = np.ascontiguousarray(frame, dtype=np.uint8)
    if frame.ndim != 3 or frame.shape[2] != 3:
        return None
    h, w = frame.shape[:2]
    out = ctypes.c_void_p()
    size = ctypes.c_ulong()
    rc = lib.fav_jpeg_encode_bgr(
        frame.ctypes.data_as(ctypes.c_void_p), w, h, w * 3, int(quality),
        ctypes.byref(out), ctypes.byref(size),
    )
    if rc != 0 or not out:
        return None
    try:
        return ctypes.string_at(out, size.value)
    finally:
        lib.fav_free(out)


def jpeg_decode_bgr(data: bytes) -> np.ndarray | None:
    """JPEG bytes -> BGR uint8 HxWx3 array."""
    lib = _load("jpegio")
    buf = np.frombuffer(data, np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.fav_jpeg_decode_bgr(
        buf.ctypes.data_as(ctypes.c_void_p), len(data), None, ctypes.byref(w), ctypes.byref(h),
    )
    if rc != 0 or w.value <= 0 or h.value <= 0:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.fav_jpeg_decode_bgr(
        buf.ctypes.data_as(ctypes.c_void_p), len(data),
        out.ctypes.data_as(ctypes.c_void_p), ctypes.byref(w), ctypes.byref(h),
    )
    return out if rc == 0 else None


def resize_area(frame: np.ndarray, width: int, height: int) -> np.ndarray:
    """INTER_AREA-style box resize (reference video_source.py:143-148)."""
    lib = _load("resize_area")
    frame = np.ascontiguousarray(frame, dtype=np.uint8)
    ch = frame.shape[2] if frame.ndim == 3 else 1
    out = np.empty((height, width, ch) if frame.ndim == 3 else (height, width), np.uint8)
    rc = lib.fav_resize_area_u8(
        frame.ctypes.data_as(ctypes.c_void_p), frame.shape[1], frame.shape[0], ch,
        out.ctypes.data_as(ctypes.c_void_p), width, height,
    )
    if rc != 0:
        raise ValueError("resize failed")
    return out
