"""Wrappers of CUDA kernels K1-K6, K5p, K6p and K8 and the Philox uniform helper, the
router of all fifteen corruption families, and the launch-count registry
of every kernel of the port (K7's wrapper is in ``ops/signal_cuda.py``,
K9a's and K9b's in ``ops/augment_cuda.py``).

Counterpart of ``fav_tpu/ops/corruptions_pallas.py`` (``_grid_call`` :157,
the wrappers :191-253, ``glass_blur_pallas`` :421,
``elastic_transform_pallas`` :518, the matmul forms :616-746 and
``fast_corruption_fn`` :749-793). Every family is ``fn(seed, x, severity)``
over float32 batch-first images (NHWC at the main path), routed as
``fast_corruption_fn`` routes it on the TPU:

* gaussian, shot and impulse noise, brightness and contrast: K1-K4;
* glass blur: band-product blur, K5's resample cascade, blur and clip;
* elastic transform: fields from Philox uniforms by band products, then K6;
* with ``packed=True`` (``glass_blur_pallas`` and ``elastic_transform_pallas``'s
  ``packed``, off by default as there), glass and elastic take the
  lane-packed kernels K5p and K6p wherever ``packed_group`` gives G > 1,
  and K5 and K6 otherwise, as the TPU route does;
* defocus, motion and zoom blur, snow, frost, fog, pixelate and JPEG: the
  band-matrix products of ``ops/corruptions.py`` (cuBLAS on the card), the
  random fields of motion, snow, frost and fog drawn on the card by the
  Philox helper.

The drawing wrappers (K1-K3, ``uniform``, and the families built on them)
take ``row``, the absolute index of ``x``'s first image in the batch it is
a shard of; the kernels then start their Philox counters there (``base`` in
``csrc/corruptions.cu``) and a shard draws exactly its rows of the whole
batch's field (``ops/corruptions.py``, "Shards").

A kernel wrapper checks its input and then:

* on a CPU tensor runs the plain version of ``ops/corruptions.py``;
* on a CUDA tensor launches its kernel on PyTorch's current stream, raises
  if the launcher reports an error, and adds one to the kernel's launch
  count. There is no fallback: a kernel that does not build or launch
  raises.

``corrupt_normalize`` (K8, ``corrupt_normalize_pallas`` :221) is the fused
noise, brightness, contrast and normalisation pass of an input pipeline; no
path of ``fav_tpu`` calls it.

The sources are ``csrc/corruptions.cu`` (K1-K4, K8 and the helper),
``csrc/glass.cu`` (K5, K5p), ``csrc/elastic.cu`` (K6, K6p), ``csrc/frame_stats.cu``
(K7) and ``csrc/shear.cu`` (K9a, K9b); ``ops/_build.py`` compiles them at
the first launch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from fav_tpu_torch.ops import corruptions as plain
from fav_tpu_torch.ops._build import load_library
from fav_tpu_torch.ops.random import counter_offset, seed_key

__all__ = [
    "KERNELS",
    "PHOTOMETRIC_MAX_D",
    "SHARED_MEMORY_LIMIT",
    "OPT_IN_SHARED_MEMORY_LIMIT",
    "NormGeometry",
    "PackedWarpGeometry",
    "ShotGeometry",
    "corrupt_normalize_geometry",
    "elastic_packed_geometry",
    "glass_packed_shared_bytes",
    "glass_shared_bytes",
    "shot_geometry",
    "multiprocessors",
    "launch_counts",
    "reset_launch_counts",
    "uniform",
    "gaussian_noise",
    "shot_noise",
    "impulse_noise",
    "brightness",
    "contrast",
    "glass_resample",
    "glass_blur",
    "elastic_warp",
    "elastic_transform",
    "grid_corruption_fn",
    "corrupt_normalize",
    "corruption_fn",
]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_U32 = ctypes.c_uint32
_F32 = ctypes.c_float
_I32 = ctypes.c_int

# K4 holds one image in shared memory: d floats plus 32 bytes of its own,
# inside the 48 KB a block gets without opting in to more. K8 holds an image
# in registers and keeps the same limit (corrupt_normalize_geometry).
PHOTOMETRIC_MAX_D = 11 * 1024
# K8's float4 groups a thread holds: at most 4 (kNormGroups in
# csrc/corruptions.cu), 3 with noise, where a group's normals cost more
# than its load and a shorter chain a thread ran faster on the card.
K8_GROUPS = {False: 4, True: 3}
# K5 and K6 hold one image per block in dynamic shared memory, within the
# same 48 KB.
SHARED_MEMORY_LIMIT = 48 * 1024
# K5p holds a group of G images per block, K6p two; their launchers opt in
# above 48 KB, up to what a Hopper block can have.
OPT_IN_SHARED_MEMORY_LIMIT = 227 * 1024
# An H100 SM's shared memory, of which each resident block also takes 1 KB.
SM_SHARED_MEMORY = 228 * 1024
# K6p's persistent grid: up to two blocks an SM.
K6P_BLOCKS_PER_SM = 2
# K2's block and chunk (kShotWarps, kShotChunk, kShotTerms in
# csrc/corruptions.cu): warps a block, elements a warp stages and queues
# at once, and terms a lane runs between two hand-outs of the queue.
SHOT_WARPS = 8
SHOT_CHUNK = 512
SHOT_TERMS = 4


class ShotGeometry(NamedTuple):
    """K2's launch: ``blocks`` blocks of ``SHOT_WARPS`` warps, each with
    ``shared_bytes`` of shared memory (the launcher derives the same)."""
    shared_bytes: int
    blocks: int


def shot_geometry(n: int, k_max: int) -> ShotGeometry:
    """K2's grid for ``n`` elements and ``k_max`` terms: a chunk of
    ``SHOT_CHUNK`` elements a warp. A block holds the log k table
    (k_max + SHOT_TERMS floats) and the result table (k_max + 1 floats),
    each rounded up to 4 floats, and u, lam and log lam of each warp's
    chunk. Raises where a block does not fit."""
    if n < 1 or k_max < 1:
        raise ValueError(f"shot_noise: {n} elements and {k_max} terms")
    tables = (k_max + SHOT_TERMS + 3) // 4 * 4 + (k_max + 1 + 3) // 4 * 4
    shared = 4 * (tables + SHOT_WARPS * 3 * SHOT_CHUNK)
    _shared_memory("shot_noise", shared, OPT_IN_SHARED_MEMORY_LIMIT, f"a block's tables for k_max={k_max} and chunks")
    return ShotGeometry(shared, -(-n // (SHOT_WARPS * SHOT_CHUNK)))


def glass_shared_bytes(h: int, w: int, c: int, passes: int) -> int:
    """K5's shared memory a block (csrc/glass.cu, one image): a 16-byte
    barrier, the input and output tiles of round4(H W C + 3) floats each
    (an image at its 16-byte phase) and one code byte a pixel a pass."""
    return 16 + 2 * ((h * w * c + 6) // 4 * 4) * 4 + passes * h * w


def glass_packed_shared_bytes(g: int, h: int, w: int, c: int, passes: int) -> int:
    """K5p's shared memory a block (csrc/glass.cu, one group of ``g``
    images): a 16-byte barrier, the group's tile of round4(G H W C + 3)
    floats (the group at its 16-byte phase), one code byte a pixel a pass
    (rounded up to 16 bytes) and a 16-bit source index a pixel; no output
    tile. Raises past what a Hopper block can have."""
    n = g * h * w
    need = 16 + ((n * c + 6) // 4 * 4) * 4 + (passes * n + 15) // 16 * 16 + 2 * n
    _shared_memory("glass_resample", need, OPT_IN_SHARED_MEMORY_LIMIT, f"a group of {g} {h}x{w}x{c} images")
    return need


class NormGeometry(NamedTuple):
    """K8's launch: one block of ``threads`` threads an image, each holding
    at most ``groups_per_thread`` of the image's float4 groups."""
    threads: int
    groups_per_thread: int


def corrupt_normalize_geometry(d: int, noise: bool) -> NormGeometry:
    """K8's block for images of ``d`` floats: the Philox groups of four
    that an image's span covers (d / 4, or one more where d is not a
    multiple of 4 and the span straddles groups at both ends), spread over
    whole warps at most ``K8_GROUPS[noise]`` a thread. Raises past
    ``PHOTOMETRIC_MAX_D``."""
    if not 1 <= d <= PHOTOMETRIC_MAX_D:
        raise ValueError(f"corrupt_normalize holds 1 to {PHOTOMETRIC_MAX_D} values per image, got {d}")
    groups = (d + 2) // 4 + 1 if d % 4 else d // 4
    threads = -(-groups // (32 * K8_GROUPS[noise])) * 32
    return NormGeometry(threads, -(-groups // threads))


class PackedWarpGeometry(NamedTuple):
    """K6p's launch: ``blocks`` blocks, each with ``shared_bytes`` of
    shared memory, which hold three tiles of ``stage_floats`` floats and
    the barriers (the launcher derives the same bytes)."""
    stage_floats: int
    shared_bytes: int
    blocks: int


def elastic_packed_geometry(batch: int, g: int, h: int, w: int, c: int, sms: int) -> PackedWarpGeometry:
    """K6p's geometry for ``batch // g`` groups of ``g`` (H, W, C) images on
    a card of ``sms`` SMs: a tile holds a group unpadded, G H W C floats
    and three more for its 16-byte phase, rounded to 16 bytes; a block
    holds the kernel's fixed ring of two input tiles and one output tile
    (csrc/elastic.cu) and 16 bytes of barriers; at most one block a
    group. Raises where it does not fit."""
    if g < 1 or batch < 1 or batch % g:
        raise ValueError(f"elastic_warp: groups of {g} do not divide a batch of {batch}")
    stage_floats = (g * h * w * c + 3 + 3) // 4 * 4
    shared = 16 + 3 * stage_floats * 4
    _shared_memory("elastic_warp", shared, OPT_IN_SHARED_MEMORY_LIMIT,
                   f"3 tiles of a group of {g} {h}x{w}x{c} images")
    per_sm = max(1, min(K6P_BLOCKS_PER_SM, SM_SHARED_MEMORY // (shared + 1024)))
    return PackedWarpGeometry(stage_floats, shared, min(batch // g, per_sm * sms))


@functools.lru_cache(maxsize=None)
def multiprocessors(device: torch.device) -> int:
    """The SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


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
                                 [_P, _P, _I64, _I64, _U32, _U32, _F32, _P]),
    # K2, replaces _shot_kernel
    "shot_noise": CudaKernel("corruptions", "fav_shot_noise",
                             [_P, _P, _I64, _I64, _U32, _U32, _F32, _I32, _P, _I32, _P]),
    # K3, replaces _impulse_kernel
    "impulse_noise": CudaKernel("corruptions", "fav_impulse_noise",
                                [_P, _P, _I64, _I64, _U32, _U32, _F32, _F32, _P]),
    # K4, replaces _photometric_kernel (brightness and contrast)
    "photometric": CudaKernel("corruptions", "fav_photometric",
                              [_P, _P, _I32, _I32, _F32, _F32, _P]),
    # K5, replaces _glass_kernel
    "glass_resample": CudaKernel("glass", "fav_glass_resample",
                                 [_P, _P, _I32, _I32, _I32, _I32, _I32, _I32, _U32, _U32, _P]),
    # K5p, replaces _glass_kernel_packed
    "glass_resample_packed": CudaKernel("glass", "fav_glass_resample_packed",
                                        [_P, _P, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _U32, _U32, _P]),
    # K6, replaces _elastic_kernel
    "elastic_warp": CudaKernel("elastic", "fav_elastic_warp",
                               [_P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _P]),
    # K6p, replaces _elastic_kernel_packed
    "elastic_warp_packed": CudaKernel("elastic", "fav_elastic_warp_packed",
                                      [_P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _P]),
    # K7, replaces signal_pallas.py:_frame_stats_kernel; wrapper in ops/signal_cuda.py
    "frame_stats": CudaKernel("frame_stats", "fav_frame_stats",
                              [_P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _P]),
    # K8, replaces corruptions_pallas.py:_corrupt_normalize_kernel
    "corrupt_normalize": CudaKernel("corruptions", "fav_corrupt_normalize",
                                    [_P, _P, _I32, _I32, _I32, _U32, _U32, _F32, _F32, _F32, _F32, _F32, _P]),
    # K9a and K9b, replace augment_pallas.py:_shear_rows_kernel and _shear_cols_kernel;
    # wrappers in ops/augment_cuda.py
    "shear_rows": CudaKernel("shear", "fav_shear_rows", [_P, _P, _P, _I32, _I32, _I32, _I32, _I32, _P]),
    "shear_cols": CudaKernel("shear", "fav_shear_cols", [_P, _P, _P, _I32, _I32, _I32, _I32, _I32, _P]),
    # the same two over bfloat16 images (augmix(..., bf16=True)), counted apart
    "shear_rows_bf16": CudaKernel("shear", "fav_shear_rows_bf16",
                                  [_P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _P]),
    "shear_cols_bf16": CudaKernel("shear", "fav_shear_cols_bf16",
                                  [_P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32, _P]),
    # helper, no TPU counterpart: the Philox uniforms of ops/random.py on the card
    "philox_uniform": CudaKernel("corruptions", "fav_philox_uniform", [_P, _I64, _I64, _U32, _U32, _U32, _P]),
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


def _base(row: int, per_row: int) -> int:
    """The counter base, in groups of four, of a draw whose first image is
    image ``row`` of its batch, an image taking ``per_row`` elements."""
    return counter_offset(row, per_row) // 4


def gaussian_noise(seed: int, x: torch.Tensor, severity: int = 3, row: int = 0) -> torch.Tensor:
    """K1: ``clip(x + sigma z)``, z from Box-Muller on Philox draws 0 and 1."""
    if _on_cpu(x, "gaussian_noise"):
        return plain.gaussian_noise_plain(seed, x, severity, row)
    sigma = plain.sev_param(plain.GAUSSIAN_SIGMA, severity)
    out = torch.empty_like(x)
    KERNELS["gaussian_noise"].launch(
        x.device, x.data_ptr(), out.data_ptr(), x.numel(), _base(row, x[0].numel()), *seed_key(seed), sigma)
    return out


def impulse_noise(seed: int, x: torch.Tensor, severity: int = 3, row: int = 0) -> torch.Tensor:
    """K3: salt and pepper from Philox draw 0."""
    if _on_cpu(x, "impulse_noise"):
        return plain.impulse_noise_plain(seed, x, severity, row)
    salt, pepper = plain.impulse_thresholds(severity)
    out = torch.empty_like(x)
    KERNELS["impulse_noise"].launch(
        x.device, x.data_ptr(), out.data_ptr(), x.numel(), _base(row, x[0].numel()), *seed_key(seed), salt, pepper)
    return out


_log_k_tables: dict[tuple[torch.device, int], torch.Tensor] = {}


def _log_k_table(device: torch.device, k_max: int) -> torch.Tensor:
    """``float32(log k)``, k < k_max, on the device, made once per (device, k_max)."""
    key = (device, k_max)
    if key not in _log_k_tables:
        _log_k_tables[key] = torch.tensor(plain.shot_log_k(k_max), dtype=torch.float32, device=device)
    return _log_k_tables[key]


def shot_noise(seed: int, x: torch.Tensor, severity: int = 3, row: int = 0) -> torch.Tensor:
    """K2: Poisson(x c) / c by the log-space inverse CDF on Philox draw 0."""
    if _on_cpu(x, "shot_noise"):
        return plain.shot_noise_plain(seed, x, severity, row)
    c = plain.sev_param(plain.SHOT_C, severity)
    k_max = plain.shot_k_max(severity)
    log_k = _log_k_table(x.device, k_max)
    geo = shot_geometry(x.numel(), k_max)
    out = torch.empty_like(x)
    KERNELS["shot_noise"].launch(
        x.device, x.data_ptr(), out.data_ptr(), x.numel(), _base(row, x[0].numel()), *seed_key(seed), c, k_max,
        log_k.data_ptr(), geo.blocks)
    return out


def _photometric(x: torch.Tensor, bright: float, contrast_c: float) -> torch.Tensor:
    b = x.shape[0]
    d = x.numel() // b
    if d > PHOTOMETRIC_MAX_D:
        raise ValueError(f"photometric kernel holds at most {PHOTOMETRIC_MAX_D} values per image, got {d}")
    out = torch.empty_like(x)
    KERNELS["photometric"].launch(x.device, x.data_ptr(), out.data_ptr(), b, d, bright, contrast_c)
    return out


def brightness(seed: int, x: torch.Tensor, severity: int = 3, row: int = 0) -> torch.Tensor:
    """K4 with contrast 1: ``clip(x + b)`` (the seed is unused)."""
    if _on_cpu(x, "brightness"):
        return plain.brightness_plain(seed, x, severity)
    return _photometric(x, plain.sev_param(plain.BRIGHTNESS_C, severity), 1.0)


def contrast(seed: int, x: torch.Tensor, severity: int = 3, row: int = 0) -> torch.Tensor:
    """K4 with brightness 0: ``clip((x - mu) c + mu)`` (the seed is unused)."""
    if _on_cpu(x, "contrast"):
        return plain.contrast_plain(seed, x, severity)
    return _photometric(x, 0.0, plain.sev_param(plain.CONTRAST_C, severity))


def corrupt_normalize(seed: int, x: torch.Tensor, sigma: float = 0.0, bright: float = 0.0,
                      contrast: float = 1.0, mean: float = 0.0, scale: float = 1.0) -> torch.Tensor:
    """K8: ``(clip((x - mu) contrast + mu + bright + sigma z) - mean) scale``,
    mu the per-image mean, z from Box-Muller on Philox draws 0 and 1 (K1's
    normals); with ``sigma`` 0 no draws are made."""
    if _on_cpu(x, "corrupt_normalize"):
        return plain.corrupt_normalize_plain(seed, x, sigma, bright, contrast, mean, scale)
    b = x.shape[0]
    d = x.numel() // b
    geo = corrupt_normalize_geometry(d, sigma > 0.0)
    out = torch.empty_like(x)
    KERNELS["corrupt_normalize"].launch(x.device, x.data_ptr(), out.data_ptr(), b, d, geo.threads, *seed_key(seed),
                                        sigma, bright, contrast, mean, scale)
    return out


def uniform(seed: int, shape, draw: int, device, row: int = 0) -> torch.Tensor:
    """Draw ``draw`` of ``seed`` as float32 uniforms in (0, 1] of ``shape``:
    on the card written by the Philox helper kernel, bit-equal to
    ``ops/random.py``'s ``uniform01``; on the CPU ``uniform01`` itself.
    ``row`` > 0 takes the rows ``row ..`` of a field whose outermost axis is
    the batch."""
    device = torch.device(device)
    if device.type == "cpu":
        return plain.uniform_field(seed, shape, draw, device, row)
    shape = tuple(shape)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    KERNELS["philox_uniform"].launch(device, out.data_ptr(), out.numel(), _base(row, math.prod(shape[1:])), int(draw),
                                     *seed_key(seed))
    return out


def _on_cpu_nhwc(x: torch.Tensor, name: str) -> bool:
    """``_on_cpu`` for the spatial families, which take (B, H, W, C) images."""
    cpu = _on_cpu(x, name)
    if x.ndim != 4:
        raise ValueError(f"{name}: expected NHWC images (B, H, W, C), got shape {tuple(x.shape)}")
    return cpu


def _shared_memory(name: str, need: int, limit: int, what: str) -> None:
    if need > limit:
        raise ValueError(f"{name}: {what} needs {need} bytes of shared memory (limit {limit})")


def glass_resample(seed: int, x: torch.Tensor, m: int, iters: int, packed: bool = False) -> torch.Tensor:
    """K5: ``iters`` rounds of the row then column random resample of NHWC
    ``x``, offsets in [-m, m] from Philox draws 0 .. 2 iters - 1. With
    ``packed`` and G = ``packed_group(B, W)`` > 1, K5p on groups of G images
    (the same draws, the same result)."""
    cpu = _on_cpu_nhwc(x, "glass_resample")
    if not 0 <= int(m) <= 127:  # the kernels keep each code, 0 .. 2m, in a byte
        raise ValueError(f"glass_resample: offset bound m={m} outside 0..127")
    b, h, w, c = x.shape
    g = plain.packed_group(b, w) if packed else 1
    if cpu:
        if g > 1:
            return plain.glass_resample_packed_plain(seed, x, m, iters)
        return plain.glass_resample_plain(seed, x, m, iters)
    passes = 2 * int(iters)
    out = torch.empty_like(x)
    if g > 1:
        glass_packed_shared_bytes(g, h, w, c, passes)
        KERNELS["glass_resample_packed"].launch(x.device, x.data_ptr(), out.data_ptr(), b, g, h, w, c, int(m),
                                                passes, *seed_key(seed))
        return out
    _shared_memory("glass_resample", glass_shared_bytes(h, w, c, passes), SHARED_MEMORY_LIMIT,
                   f"a {h}x{w}x{c} image")
    KERNELS["glass_resample"].launch(x.device, x.data_ptr(), out.data_ptr(), b, h, w, c, int(m), passes,
                                     *seed_key(seed))
    return out


def glass_blur(seed: int, x: torch.Tensor, severity: int = 3, packed: bool = False) -> torch.Tensor:
    """Band-product blur, K5 (K5p with ``packed``), blur and clip (``glass_blur_pallas``)."""
    _on_cpu_nhwc(x, "glass_blur")
    return plain.glass_blur_with(x, severity, lambda y, m, iters: glass_resample(seed, y, m, iters, packed))


def elastic_warp(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, severity: int = 3,
                 packed: bool = False) -> torch.Tensor:
    """K6: the tent-sum bilinear warp of NHWC ``x`` to the clamped sample
    coordinates ``(ys, xs)``, each (B, H, W). With ``packed`` and G =
    ``packed_group(B, W + 2(m + 1))`` > 1, K6p on groups of G images (the
    same result)."""
    cpu = _on_cpu_nhwc(x, "elastic_warp")
    b, h, w, c = x.shape
    for name, f in (("ys", ys), ("xs", xs)):
        if not isinstance(f, torch.Tensor) or f.dtype != torch.float32 or f.shape != (b, h, w):
            raise ValueError(f"elastic_warp: {name} must be float32 of shape {(b, h, w)}")
        if f.device != x.device or not f.is_contiguous():
            raise ValueError(f"elastic_warp: {name} must be contiguous on {x.device}")
    m = plain.elastic_margin(severity)
    p = m + 1
    g = plain.packed_group(b, w + 2 * p) if packed else 1
    if cpu:
        if g > 1:
            return plain.elastic_from_fields_packed(x, ys, xs, severity, g)
        return plain.elastic_from_fields(x, ys, xs, severity)
    out = torch.empty_like(x)
    if g > 1:
        geo = elastic_packed_geometry(b, g, h, w, c, multiprocessors(x.device))
        KERNELS["elastic_warp_packed"].launch(x.device, x.data_ptr(), ys.data_ptr(), xs.data_ptr(), out.data_ptr(),
                                              b, g, h, w, c, m, geo.blocks)
        return out
    _shared_memory("elastic_warp", h * w * c * 4, SHARED_MEMORY_LIMIT, f"a {h}x{w}x{c} image")
    KERNELS["elastic_warp"].launch(x.device, x.data_ptr(), ys.data_ptr(), xs.data_ptr(), out.data_ptr(),
                                   b, h, w, c, m)
    return out


def elastic_transform(seed: int, x: torch.Tensor, severity: int = 3, packed: bool = False,
                      row: int = 0) -> torch.Tensor:
    """Fields from Philox draws 0 and 1 (``ops/corruptions.py``), then K6 (K6p with ``packed``)."""
    _on_cpu_nhwc(x, "elastic_transform")
    ys, xs = plain.elastic_fields(seed, x, severity, uniform=uniform, row=row)
    return elastic_warp(x, ys, xs, severity, packed)


def _band_family(name: str, fn):
    """A band-matrix family, its input checked; draw families take their
    fields from ``uniform``."""
    def routed(seed: int, x: torch.Tensor, severity: int = 3, row: int = 0) -> torch.Tensor:
        _on_cpu_nhwc(x, name)
        return fn(seed, x, severity, row=row)

    routed.__name__ = name
    return routed


_ROUTES = {
    "gaussian_noise": gaussian_noise,
    "shot_noise": shot_noise,
    "impulse_noise": impulse_noise,
    "defocus_blur": _band_family("defocus_blur", plain.corruption_fn("defocus_blur")),
    "glass_blur": glass_blur,
    "motion_blur": _band_family("motion_blur", functools.partial(plain.motion_blur_plain, uniform=uniform)),
    "zoom_blur": _band_family("zoom_blur", plain.corruption_fn("zoom_blur")),
    "snow": _band_family("snow", functools.partial(plain.snow_plain, uniform=uniform)),
    "frost": _band_family("frost", functools.partial(plain.frost_plain, uniform=uniform)),
    "fog": _band_family("fog", functools.partial(plain.fog_plain, uniform=uniform)),
    "brightness": brightness,
    "contrast": contrast,
    "elastic_transform": elastic_transform,
    "pixelate": _band_family("pixelate", plain.corruption_fn("pixelate")),
    "jpeg_compression": _band_family("jpeg_compression", plain.corruption_fn("jpeg_compression")),
}


def corruption_fn(name: str):
    """The routed family ``fn(seed, x, severity)``, as ``fast_corruption_fn``
    routes it; glass and elastic also take ``packed=`` (default False), as
    there. An unknown name raises ``NotImplementedError``."""
    if name not in _ROUTES:
        raise NotImplementedError(f"unknown corruption {name!r}")
    return _ROUTES[name]


_GRID_GLASS = _band_family("glass_blur", functools.partial(plain.grid_glass_blur_plain, uniform=uniform))


def grid_corruption_fn(name: str):
    """The family ``fn(seed, x, severity)`` as the evaluation grid takes it
    (``fav_tpu/parallel/sweep.py`` corrupts with the jnp oracle): glass as
    the oracle's 2-D local resample (``plain.grid_glass_blur_plain``, its
    draws from the Philox helper on the card), every other family as
    :func:`corruption_fn` routes it, whose forms compute the oracle's law."""
    return _GRID_GLASS if name == "glass_blur" else corruption_fn(name)
