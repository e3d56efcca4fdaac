"""The port stands alone: mvs_tpu_torch, chip_smoke.py and chip_ab.py import
neither JAX nor mvs_tpu, pick the card unless told otherwise, and build
their kernels for sm_90a through the C interfaces the wrappers declare."""

import ast
import importlib
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import mvs_tpu_torch
from mvs_tpu_torch.ops import _build
from mvs_tpu_torch.utils.platform import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "mvs_tpu_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "chip_ab.py"]


def test_import_pulls_in_no_jax_or_mvs_tpu():
    code = (
        "import importlib, pkgutil, sys, mvs_tpu_torch\n"
        "for m in pkgutil.walk_packages(mvs_tpu_torch.__path__, "
        "'mvs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'mvs_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_mvs_tpu_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "mvs_tpu"), (
                f"{path.name}:{node.lineno} imports {name}")


def test_every_module_imports_without_pil_cv2_or_yaml():
    """The card's machine may lack PIL, cv2 and PyYAML: the port imports
    PIL or cv2 only when a JPEG is read, and never PyYAML."""
    code = (
        "import importlib, pkgutil, sys\n"
        "for name in ('PIL', 'cv2', 'yaml'):\n"
        "    sys.modules[name] = None\n"
        "import mvs_tpu_torch\n"
        "for m in pkgutil.walk_packages(mvs_tpu_torch.__path__, "
        "'mvs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from mvs_tpu_torch.utils.config import load_config\n"
        "assert load_config(None, ['data.batch_size=2']).data.batch_size == 2\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_every_module_imports_without_cuda():
    names = [m.name for m in pkgutil.walk_packages(mvs_tpu_torch.__path__,
                                                   "mvs_tpu_torch.")]
    assert {"mvs_tpu_torch.ops.warp_variance", "mvs_tpu_torch.native",
            "mvs_tpu_torch.parallel.collectives",
            "mvs_tpu_torch.parallel.distributed"} <= set(names)
    for name in names:
        importlib.import_module(name)


def test_resolve_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_nvcc_command_targets_sm90a():
    cmd = _build.nvcc_command("csrc/x.cu", "build/libx.so")
    assert cmd[0] == "nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-shared", "-O3", "-std=c++17"} <= set(cmd)
    assert cmd[-3:] == ["-o", "build/libx.so", "csrc/x.cu"]
    # Builds land in the git-ignored build directory at the repo root.
    assert _build.BUILD_DIR == ROOT / "build" / "mvs_tpu_torch"
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()


@pytest.mark.parametrize("module,source", [
    ("mvs_tpu_torch.ops.warp_variance", "warp_variance"),
    ("mvs_tpu_torch.ops.conv3d", "conv3d_affine"),
    ("mvs_tpu_torch.ops.group_correlation", "group_correlation"),
])
def test_ctypes_signature_matches_c_entry(module, source):
    """Each argtype the wrapper declares matches the extern "C" parameter of
    the same position (a pointer for void*, an int for int)."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    signatures = importlib.import_module(module)._SIGNATURES
    for fn, (argtypes, restype) in signatures.items():
        m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
        assert m, f"{fn} not found in {source}.cu"
        params = [p.strip() for p in m.group(1).split(",")]
        kinds = ["ptr" if "*" in p else "int" for p in params]
        declared = ["ptr" if t.__name__ == "c_void_p" else "int"
                    for t in argtypes]
        assert declared == kinds, (fn, params)
        assert restype.__name__ == "c_int"


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """An edit to a csrc header gives every source that includes it, even
    through another header, a new library name: no stale build loads."""
    for name in _build.SOURCES:
        assert [p.name for p in _build.source_files(name)] == [
            f"{name}.cu", "mvs_common.cuh"]
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint f();\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.source_files("k")] == ["k.cu", "a.cuh",
                                                           "b.cuh"]
    before = _build._library_path("k")
    (tmp_path / "b.cuh").write_text("// v2\n")
    assert _build._library_path("k") != before
