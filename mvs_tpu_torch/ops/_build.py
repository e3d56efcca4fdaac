"""Build the CUDA sources under ``mvs_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``build/mvs_tpu_torch/`` at the repository root and loaded with ``ctypes``;
no PyTorch headers are compiled, so a build takes seconds. The library's
file name carries a hash of its source, of every ``csrc`` header it includes
(directly or through another header) and of the flags, so an edited source
or shared header is rebuilt and a stale library is never loaded. Importing
this module needs neither CUDA nor ``nvcc``: nothing is built until a kernel
is first called (or ``build`` is called).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "nvcc_command", "source_files", "build",
           "load", "check"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mvs_tpu_torch"
SOURCES = ("warp_variance", "conv3d_affine", "group_correlation")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_command(source, output, nvcc: str = "nvcc") -> list[str]:
    """The nvcc command line that builds `source` into the library `output`."""
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in filter(None, (home, "/usr/local/cuda")):
        cand = Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> list[Path]:
    """csrc/<name>.cu and every csrc header it includes, transitively."""
    files, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        todo += [path.parent / inc.decode()
                 for inc in _INCLUDE.findall(path.read_bytes())]
    return files


def _library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in source_files(name):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile the named sources that have no current library, all at once.

    Starts one nvcc per source, waits for all, and raises RuntimeError with
    the compiler's output if any fails. Returns seconds spent per source
    built.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [(n, _library_path(n)) for n in names]
    todo = [(n, p) for n, p in todo if not p.exists()]
    if not todo:
        return {}
    nvcc = _find_nvcc()
    t0 = time.perf_counter()
    procs = []
    for name, path in todo:
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        procs.append((name, path, tmp, subprocess.Popen(
            nvcc_command(CSRC / f"{name}.cu", tmp, nvcc),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    seconds, failures = {}, []
    for name, path, tmp, proc in procs:
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, path)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return seconds


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed.

    signatures: {function: (argtypes, restype)}, declared on first load.
    """
    lib = _LIBS.get(name)
    if lib is None:
        path = _library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
