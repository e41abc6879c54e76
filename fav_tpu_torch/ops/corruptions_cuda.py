"""Wrappers of CUDA kernels K1-K4 and the router of the slice's five families.

Counterpart of ``fav_tpu/ops/corruptions_pallas.py`` (``_grid_call`` :157,
the wrappers :191-253, ``fast_corruption_fn`` :749-793). Every family is
``fn(seed, x, severity)`` over float32 batch-first images (NHWC at the
main path). A wrapper checks its input and then:

* on a CPU tensor runs the plain version of ``ops/corruptions.py``;
* on a CUDA tensor launches its kernel on PyTorch's current stream, raises
  if the launcher reports an error, and adds one to the kernel's launch
  count. There is no fallback: a kernel that does not build or launch
  raises.

The sources are ``csrc/corruptions.cu``; ``ops/_build.py`` compiles them at
the first launch.
"""

from __future__ import annotations

import ctypes

import torch

from fav_tpu_torch.ops import corruptions as plain
from fav_tpu_torch.ops._build import load_library
from fav_tpu_torch.ops.random import seed_key

__all__ = [
    "KERNELS",
    "PHOTOMETRIC_MAX_D",
    "launch_counts",
    "reset_launch_counts",
    "gaussian_noise",
    "shot_noise",
    "impulse_noise",
    "brightness",
    "contrast",
    "corruption_fn",
]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_U32 = ctypes.c_uint32
_F32 = ctypes.c_float
_I32 = ctypes.c_int

# K4 holds one image in shared memory: d floats plus 32 bytes of its own,
# inside the 48 KB a block gets without opting in to more.
PHOTOMETRIC_MAX_D = 11 * 1024


class CudaKernel:
    """One C launcher of a library in ``csrc``: its ctypes binding, made at
    the first launch, and the number of launches since the last reset."""

    def __init__(self, library: str, symbol: str, argtypes: list):
        self.library = library
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def _bind(self):
        lib = load_library(self.library)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.fav_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._error_string = err
        self._fn = fn

    def launch(self, device: torch.device, *args) -> None:
        if self._fn is None:
            self._bind()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = self._fn(*args, stream)
        if rc != 0:
            msg = self._error_string(rc).decode()
            raise RuntimeError(f"{self.symbol} failed to launch: {msg} (cudaError {rc})")
        self.launches += 1


KERNELS = {
    # K1, replaces corruptions_pallas.py:_gaussian_kernel
    "gaussian_noise": CudaKernel("corruptions", "fav_gaussian_noise",
                                 [_P, _P, _I64, _U32, _U32, _F32, _P]),
    # K2, replaces _shot_kernel
    "shot_noise": CudaKernel("corruptions", "fav_shot_noise",
                             [_P, _P, _I64, _U32, _U32, _F32, _I32, _P, _P]),
    # K3, replaces _impulse_kernel
    "impulse_noise": CudaKernel("corruptions", "fav_impulse_noise",
                                [_P, _P, _I64, _U32, _U32, _F32, _F32, _P]),
    # K4, replaces _photometric_kernel (brightness and contrast)
    "photometric": CudaKernel("corruptions", "fav_photometric",
                              [_P, _P, _I32, _I32, _F32, _F32, _P]),
}


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _on_cpu(x: torch.Tensor, name: str) -> bool:
    """Validates ``x`` and says whether it takes the plain version."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32 images, got {x.dtype}")
    if x.ndim < 2 or x.shape[0] < 1:
        raise ValueError(f"{name}: expected batch-first images (B, ...), got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return False


def gaussian_noise(seed: int, x: torch.Tensor, severity: int = 3) -> torch.Tensor:
    """K1: ``clip(x + sigma z)``, z from Box-Muller on Philox draws 0 and 1."""
    if _on_cpu(x, "gaussian_noise"):
        return plain.gaussian_noise_plain(seed, x, severity)
    sigma = plain.sev_param(plain.GAUSSIAN_SIGMA, severity)
    out = torch.empty_like(x)
    KERNELS["gaussian_noise"].launch(
        x.device, x.data_ptr(), out.data_ptr(), x.numel(), *seed_key(seed), sigma)
    return out


def impulse_noise(seed: int, x: torch.Tensor, severity: int = 3) -> torch.Tensor:
    """K3: salt and pepper from Philox draw 0."""
    if _on_cpu(x, "impulse_noise"):
        return plain.impulse_noise_plain(seed, x, severity)
    salt, pepper = plain.impulse_thresholds(severity)
    out = torch.empty_like(x)
    KERNELS["impulse_noise"].launch(
        x.device, x.data_ptr(), out.data_ptr(), x.numel(), *seed_key(seed), salt, pepper)
    return out


_log_k_tables: dict[tuple[torch.device, int], torch.Tensor] = {}


def _log_k_table(device: torch.device, k_max: int) -> torch.Tensor:
    """``float32(log k)``, k < k_max, on the device, made once per (device, k_max)."""
    key = (device, k_max)
    if key not in _log_k_tables:
        _log_k_tables[key] = torch.tensor(plain.shot_log_k(k_max), dtype=torch.float32, device=device)
    return _log_k_tables[key]


def shot_noise(seed: int, x: torch.Tensor, severity: int = 3) -> torch.Tensor:
    """K2: Poisson(x c) / c by the log-space inverse CDF on Philox draw 0."""
    if _on_cpu(x, "shot_noise"):
        return plain.shot_noise_plain(seed, x, severity)
    c = plain.sev_param(plain.SHOT_C, severity)
    k_max = plain.shot_k_max(severity)
    log_k = _log_k_table(x.device, k_max)
    out = torch.empty_like(x)
    KERNELS["shot_noise"].launch(
        x.device, x.data_ptr(), out.data_ptr(), x.numel(), *seed_key(seed), c, k_max,
        log_k.data_ptr())
    return out


def _photometric(x: torch.Tensor, bright: float, contrast_c: float) -> torch.Tensor:
    b = x.shape[0]
    d = x.numel() // b
    if d > PHOTOMETRIC_MAX_D:
        raise ValueError(f"photometric kernel holds at most {PHOTOMETRIC_MAX_D} values per image, got {d}")
    out = torch.empty_like(x)
    KERNELS["photometric"].launch(x.device, x.data_ptr(), out.data_ptr(), b, d, bright, contrast_c)
    return out


def brightness(seed: int, x: torch.Tensor, severity: int = 3) -> torch.Tensor:
    """K4 with contrast 1: ``clip(x + b)`` (the seed is unused)."""
    if _on_cpu(x, "brightness"):
        return plain.brightness_plain(seed, x, severity)
    return _photometric(x, plain.sev_param(plain.BRIGHTNESS_C, severity), 1.0)


def contrast(seed: int, x: torch.Tensor, severity: int = 3) -> torch.Tensor:
    """K4 with brightness 0: ``clip((x - mu) c + mu)`` (the seed is unused)."""
    if _on_cpu(x, "contrast"):
        return plain.contrast_plain(seed, x, severity)
    return _photometric(x, 0.0, plain.sev_param(plain.CONTRAST_C, severity))


_ROUTES = {
    "gaussian_noise": gaussian_noise,
    "shot_noise": shot_noise,
    "impulse_noise": impulse_noise,
    "brightness": brightness,
    "contrast": contrast,
}


def corruption_fn(name: str):
    """The routed family ``fn(seed, x, severity)``: a kernel wrapper for the
    five families of the slice; ``NotImplementedError`` naming the ROADMAP
    item for the ten others."""
    if name in _ROUTES:
        return _ROUTES[name]
    raise plain.not_ported(name)
