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

import numpy as np
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


# the repo-root tools/ are JAX scripts: the port has its own under fav_tpu_torch/tools
ROOT_TOOLS = {"tools"} | {p.stem for p in (REPO / "tools").glob("*.py")}


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
            assert name.split(".")[0] not in ROOT_TOOLS, f"{path.name}:{node.lineno} imports the repo-root {name}"


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
    # the training path: data or a generator on the CPU, or device="cpu", is asking for it
    from fav_tpu_torch.data.cifar import synthetic_cifar10
    from fav_tpu_torch.models import pretrain
    from fav_tpu_torch.models.train import make_train_megastep, train_classifier
    from fav_tpu_torch.ops.augment import augmix

    with pytest.raises(RuntimeError):
        train_classifier(FailureAwareCNN(widths=(8,), dense_width=8), synthetic_cifar10(16, 8), num_steps=1)
    with pytest.raises(RuntimeError):
        make_train_megastep(augmix=True)
    with pytest.raises(RuntimeError):
        augmix(torch.Generator(), np.zeros((2, 32, 32, 3), np.float32))
    with pytest.raises(RuntimeError):
        pretrain.main(["--steps", "1"])
    # the fit tool
    from fav_tpu_torch.tools import fit_maha

    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_maha.main(["--checkpoint", str(PACKAGE / "weights" / "student_nano"), "--fit-images", "10"])
    assert augmix(torch.Generator(), torch.zeros(2, 32, 32, 3)).device.type == "cpu"
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


# the checkpoint tools and the quickstart, each with arguments that would run
# ("{tmp}" a temporary directory holding a copy of student_nano without its
# conformal threshold, so the backfill has work)
CKPT_ENTRY_POINTS = {
    "tools.stack_ensemble": ["classifier", "classifier_freq", "--out", "{tmp}/stacked"],
    "tools.refit_temperature": ["--checkpoint", "classifier", "--views", "1"],
    "tools.defense_in_depth": ["--draws", "0", "--num-images", "4"],
    "tools.diagnose_weather": ["--num-images", "4"],
    "tools.train_occl_members": ["--steps", "1", "--seeds", "1", "--outdir", "{tmp}"],
    "tools.train_student_members": ["--steps", "1", "--seeds", "1", "--outdir", "{tmp}"],
    "tools.backfill_conformal": ["{tmp}/nano"],
    "quickstart": ["--steps", "1"],
}


@pytest.mark.parametrize("module", sorted(CKPT_ENTRY_POINTS))
def test_checkpoint_tools_refuse_the_cpu_unless_asked(module, tmp_path):
    """Each new entry point, given work and no ``--device cpu``, raises
    before it reads a dataset or writes anything."""
    import importlib
    import json

    _no_card()
    for ext in (".npz", ".metadata.json"):
        shutil.copy(PACKAGE / "weights" / f"student_nano{ext}", tmp_path / f"nano{ext}")
    meta = json.loads((tmp_path / "nano.metadata.json").read_text())
    del meta["conformal_qhat"]
    (tmp_path / "nano.metadata.json").write_text(json.dumps(meta))
    before = sorted(p.name for p in tmp_path.iterdir())
    main = importlib.import_module(f"fav_tpu_torch.{module}").main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([a.replace("{tmp}", str(tmp_path)) for a in CKPT_ENTRY_POINTS[module]])
    assert sorted(p.name for p in tmp_path.iterdir()) == before


def test_parallel_modules_import_alone_and_init_world_needs_a_card():
    """``parallel/dist.py``, ``mesh.py`` and ``dryrun.py`` import in a fresh
    interpreter without JAX (the walk above imports them with the rest);
    ``init_world`` with no card and no CPU asked for raises and joins no
    world: it never falls back from NCCL to gloo."""
    code = _IMPORT_ALL.split("import fav_tpu_torch\n")[0] + (
        "import torch.distributed as dist\n"
        "from fav_tpu_torch.parallel import dist as pd, dryrun, mesh\n"
        "try:\n    pd.init_world(init_method='file:///nonexistent/store')\nexcept RuntimeError as e:\n"
        "    assert \"device='cpu'\" in str(e), e\nelse:\n    raise SystemExit('init_world did not raise')\n"
        "assert not dist.is_initialized() and pd.current_world() is None\n"
        "assert not [m for m in sys.modules if blocked(m)]\nprint('ok')\n")
    _no_card()
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.split() == ["ok"], out.stderr


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

    assert {k.library for k in corruptions_cuda.KERNELS.values()} == {"corruptions", "glass", "elastic", "frame_stats",
                                                                      "shear"}
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


def test_native_builds_under_build_and_never_in_the_source_tree():
    """The resize and JPEG libraries build with g++ into build/native/ of
    the repository at first use (or at prebuild), never beside their
    sources; importing the package builds nothing."""
    out = subprocess.run([sys.executable, "-c", "import fav_tpu_torch.serving.app, fav_tpu_torch.native as n; "
                          "print(len(n._libs), len(n._errors))"],
                         cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.split() == ["0", "0"], out.stderr
    from fav_tpu_torch import native

    before = sorted(p for p in PACKAGE.rglob("*") if "__pycache__" not in p.parts)
    built = native.prebuild()
    assert native.build_dir() == REPO / "build" / "native"
    for name in ("resize_area", "jpegio"):
        path = native.lib_path(name)
        assert path.parent == REPO / "build" / "native" and path.name.startswith(name + "-")
        if not built[name].startswith("not built"):
            assert path.is_file() and built[name] == str(path)
    assert not built["resize_area"].startswith("not built"), built  # needs g++ only, never libjpeg
    assert sorted(p for p in PACKAGE.rglob("*") if "__pycache__" not in p.parts) == before
    assert not [p for p in PACKAGE.rglob("*") if p.suffix in (".so", ".o")]
    assert "-ljpeg" not in " ".join(native.CXX_FLAGS + native._LINK["resize_area"])
