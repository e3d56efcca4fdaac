"""ctypes bindings for the port's native C++ KD-tree (native/kdtree.cpp).

The threaded KD-tree engine behind the DTU evaluation protocol (counterpart
of mvs_tpu.native): nearest-neighbour distances and the stochastic radius
decimation of reducePts_haa.m. Host code, no device kernel. The host C++
compiler (``$CXX``, else ``g++`` or ``c++``) builds ``kdtree.cpp`` at first
use into ``build/mvs_tpu_torch/`` at the repository root, under a name that
hashes the source and the flags; the flags target the generic x86-64 or
aarch64 baseline, so a library built on one host loads on another. Without
a compiler, ``available()`` is False and the callers fall back to scipy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

from mvs_tpu_torch.ops._build import BUILD_DIR

__all__ = ["load", "available", "build", "library_path", "nn_distances",
           "reduce_points_mask"]

SOURCE = Path(__file__).resolve().parent / "kdtree.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall")

_P_FLOAT = ctypes.POINTER(ctypes.c_float)
# {C entry of kdtree.cpp: (argtypes, restype)}; both return void.
_SIGNATURES = {
    "mvs_nn_distances": ([_P_FLOAT, ctypes.c_int64, _P_FLOAT, ctypes.c_int64,
                          _P_FLOAT], None),
    "mvs_reduce_points": ([_P_FLOAT, ctypes.c_int64,
                           ctypes.POINTER(ctypes.c_int32), ctypes.c_float,
                           ctypes.POINTER(ctypes.c_uint8)], None),
}

_lib = None  # None: not tried yet; False: could not be built
_LOCK = threading.Lock()


def _compiler() -> str | None:
    return (os.environ.get("CXX") or shutil.which("g++")
            or shutil.which("c++"))


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libmvs_kdtree-{digest.hexdigest()[:16]}.so"


def build() -> bool:
    """Compile kdtree.cpp into library_path(). Returns True on success; on
    a compiler error, warns with its output and returns False.

    Writes a per-process temporary file and renames it into place, so
    processes that build at once never load a half-written library."""
    cxx = _compiler()
    if cxx is None:
        return False
    path = library_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        warnings.warn(f"{cxx} could not build {SOURCE.name} (exit "
                      f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
        return False
    os.replace(tmp, path)
    return True


def load():
    """The loaded library, built first if needed; None if it cannot be
    built (tried once a process). A library that exists but does not load
    (built against another host's C++ runtime) is built again."""
    global _lib
    with _LOCK:
        if _lib is None:
            _lib = _load() or False
        return _lib or None


def _load():
    path = library_path()
    if not path.exists() and not build():
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        if not build():
            return None
        lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def available() -> bool:
    return load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_P_FLOAT)


def nn_distances(query: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Euclidean distance from each query point to its nearest target point
    (inf for every query when the target is empty)."""
    lib = load()
    query = np.ascontiguousarray(query, dtype=np.float32)
    target = np.ascontiguousarray(target, dtype=np.float32)
    if lib is None:
        from scipy.spatial import cKDTree

        return cKDTree(target).query(query, k=1, workers=-1)[0].astype(np.float32)
    out = np.empty(len(query), dtype=np.float32)
    lib.mvs_nn_distances(_fptr(query), len(query), _fptr(target), len(target),
                         _fptr(out))
    return out


def reduce_points_mask(pts: np.ndarray, dst: float,
                       seed: int | None = 0) -> np.ndarray:
    """Stochastic decimation keep-mask (reducePts_haa semantics): the same
    visit order, and so the same mask, as dtu_eval.reduce_points at the same
    seed."""
    lib = load()
    pts = np.ascontiguousarray(pts, dtype=np.float32)
    n = len(pts)
    if lib is None:
        from mvs_tpu_torch.dtu_eval.protocol import reduce_points

        return reduce_points(pts, dst, seed=seed, use_native=False)
    rng = np.random.default_rng(seed)
    order = (rng.permutation(n) if seed is not None
             else np.random.permutation(n)).astype(np.int32)
    keep = np.empty(n, dtype=np.uint8)
    lib.mvs_reduce_points(
        _fptr(pts), n, order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_float(dst), keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return keep.astype(bool)
