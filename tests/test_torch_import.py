"""The port stands alone: no JAX, no fav_tpu, no quiet fall back to the CPU.

* A fresh interpreter imports every module of ``fav_tpu_torch`` and
  ``chip_smoke`` (without running it) behind a meta-path hook that refuses
  ``jax*``, ``flax*``, ``optax*``, ``orbax*`` and ``fav_tpu``/``fav_tpu.*``:
  the machine with the card has none of them.
* An AST walk of the same files finds no such import, lazy ones included.
* ``chip_smoke.py`` exits non-zero and prints no result without a card, and
  also from a directory that holds nothing else of the repo.
* Entry points called without ``device="cpu"`` raise when there is no card.
* The build refuses clearly without nvcc and names sm_90a, and the C
  launchers the wrappers bind exist in the CUDA source with as many
  arguments as the bindings declare.
"""

from __future__ import annotations

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "fav_tpu_torch"
BLOCKED_ROOTS = ("jax", "jaxlib", "flax", "optax", "orbax", "fav_tpu")

_IMPORT_ALL = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "fav_tpu")

def blocked(name):
    root = name.split(".")[0]
    return root in BLOCKED or root.startswith(("jax_", "flax_", "orbax_"))

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"refused import of {name}")
        return None

for name in [m for m in sys.modules if blocked(m)]:
    del sys.modules[name]
sys.meta_path.insert(0, Refuse())

import fav_tpu_torch
names = ["fav_tpu_torch"]
for info in pkgutil.walk_packages(fav_tpu_torch.__path__, "fav_tpu_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
import chip_smoke
names.append("chip_smoke")
leaked = sorted(m for m in sys.modules if blocked(m))
assert not leaked, leaked
print(" ".join(names))
"""


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_every_module_imports_without_jax_or_fav_tpu():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    imported = set(out.stdout.split())
    expected = {"fav_tpu_torch." + ".".join(p.relative_to(PACKAGE).with_suffix("").parts)
                for p in PACKAGE.rglob("*.py") if p.name != "__init__.py"}
    assert expected <= imported, expected - imported
    assert "chip_smoke" in imported


def _port_sources() -> list[Path]:
    return sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_imports_jax_or_fav_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BLOCKED_ROOTS, f"{path.name}:{node.lineno} imports {name}"


def _run_smoke(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=_env(),
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _env()
    env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")


def test_entry_points_refuse_the_cpu_unless_asked():
    _no_card()
    from fav_tpu_torch.device import resolve_device
    from fav_tpu_torch.models.cnn import FailureAwareCNN
    from fav_tpu_torch.pipeline import entry, make_megastep
    from fav_tpu_torch.utils.checkpoint import load_student

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        entry()
    with pytest.raises(RuntimeError):
        load_student("student_nano")
    with pytest.raises(RuntimeError):
        make_megastep(FailureAwareCNN(widths=(8,), dense_width=8))
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_build_needs_nvcc(monkeypatch, tmp_path):
    from fav_tpu_torch.ops import _build

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("FAV_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


def test_build_targets_sm90a_without_fast_math():
    from fav_tpu_torch.ops import _build

    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "-shared" in flags
    for src in _build.CSRC.glob("*.cu*"):
        assert "torch/extension.h" not in src.read_text(), src.name


def test_library_path_is_keyed_by_the_source(monkeypatch, tmp_path):
    from fav_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setenv("FAV_TORCH_BUILD_DIR", str(tmp_path / "out"))
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _build.library_path(src)
    assert first.parent == tmp_path / "out" and first.name.startswith("k-") and first.suffix == ".so"
    assert _build.library_path(src) == first
    src.write_text("// two\n")
    assert _build.library_path(src) != first


def test_launchers_match_their_bindings():
    """Each bound symbol is an extern "C" launcher of its library's source,
    taking the bound arguments plus the stream, and returning an error code;
    every library exports the error-string function the binding reads."""
    from fav_tpu_torch.ops import corruptions_cuda

    assert {k.library for k in corruptions_cuda.KERNELS.values()} == {"corruptions", "glass", "elastic"}
    for kernel in corruptions_cuda.KERNELS.values():
        source = (PACKAGE / "ops" / "csrc" / f"{kernel.library}.cu").read_text()
        extern = source[source.index('extern "C" {'):]
        m = re.search(rf"int {kernel.symbol}\(([^)]*)\)", extern)
        assert m, kernel.symbol
        params = [p.strip() for p in m.group(1).split(",")]
        assert len(params) == len(kernel.argtypes), kernel.symbol
        assert params[-1] == "void* stream"
        assert "const char* fav_cuda_error_string(int code)" in extern
        assert "--use_fast_math" not in source.replace("(no --use_fast_math)", "")


def test_nothing_launches_at_import():
    from fav_tpu_torch.ops import _build, corruptions_cuda

    # on a CPU-only machine nothing is ever built, loaded or bound
    assert all(k._fn is None for k in corruptions_cuda.KERNELS.values())
    assert not _build._loaded
