"""Build the port's CUDA sources with plain ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, ``build/torch_kernels/<name>-<hash>.so`` under the repository
root (or under ``$FAV_TORCH_BUILD_DIR``). The hash covers the source and the
flags, so an edited source builds anew and an unchanged one is reused. All
missing libraries are compiled at once, one ``nvcc`` process per source
started together. Nothing includes PyTorch's headers, so a source builds in
seconds rather than the minutes ``torch.utils.cpp_extension.load`` needs.

Nothing here runs at import: the first kernel launch builds and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["CSRC", "NVCC_FLAGS", "build_dir", "find_nvcc", "library_path", "build_all", "load_library"]

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills, kept in the .log beside the library
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("FAV_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parents[2] / "build" / "torch_kernels"


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else
    ``/usr/local/cuda/bin/nvcc``; raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH and /usr/local/cuda/bin): "
        "the CUDA kernels of fav_tpu_torch cannot be built on this machine"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path(source: Path) -> Path:
    """Where ``source`` builds to: its name and a hash of its bytes, of the
    headers beside it and of the flags."""
    h = hashlib.sha256()
    for p in [source, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all in parallel.
    Returns ``{name: library path}``; raises with nvcc's output on failure."""
    out = {src.stem: library_path(src) for src in _sources()}
    todo = [(src, out[src.stem]) for src in _sources() if not out[src.stem].exists()]
    if not todo:
        return out
    nvcc = find_nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = []
    for src, lib in todo:
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        log = open(lib.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failures = []
    for src, lib, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
        else:
            tmp.unlink(missing_ok=True)
            failures.append(f"{src.name}: nvcc exited {rc}\n{lib.with_suffix('.log').read_text()}")
    if failures:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failures))
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            paths = build_all()
            if name not in paths:
                raise KeyError(f"no CUDA source csrc/{name}.cu")
            lib = ctypes.CDLL(str(paths[name]))
            _loaded[name] = lib
        return lib
