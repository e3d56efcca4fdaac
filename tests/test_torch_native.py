"""The port's native KD-tree (mvs_tpu_torch.native) against mvs_tpu.native,
scipy and the Python decimation: the cases of tests/test_native.py, the
evaluation protocol with the native path on and off, the ctypes
declarations against kdtree.cpp, and the build (its own library under
build/mvs_tpu_torch, named by a hash, safe to build from processes at once).
Skips only where the host has no C++ compiler.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy.spatial import cKDTree

import mvs_tpu.native as jax_native
from mvs_tpu.dtu_eval import evaluate_scan as jax_evaluate_scan
from mvs_tpu.dtu_eval import reduce_points as jax_reduce_points
from mvs_tpu_torch import native
from mvs_tpu_torch.dtu_eval import evaluate_scan, reduce_points

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def lib():
    if native._compiler() is None:
        pytest.skip("no C++ compiler on this host")
    assert native.available(), "kdtree.cpp did not build"
    return native.load()


def test_nn_distances_matches_scipy_and_jax(lib):
    rng = np.random.default_rng(0)
    target = rng.uniform(0, 100, (20000, 3)).astype(np.float32)
    query = rng.uniform(-10, 110, (5000, 3)).astype(np.float32)
    got = native.nn_distances(query, target)
    assert got.dtype == np.float32
    want = cKDTree(target).query(query, k=1, workers=-1)[0]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, jax_native.nn_distances(query, target),
                               rtol=1e-4, atol=1e-4)


def test_nn_distances_empty_target(lib):
    out = native.nn_distances(np.zeros((3, 3), np.float32),
                              np.zeros((0, 3), np.float32))
    assert out.shape == (3,) and np.isinf(out).all()


def test_reduce_points_semantics(lib):
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 10, (3000, 3)).astype(np.float32)
    keep = native.reduce_points_mask(pts, dst=1.0, seed=0)
    kept = pts[keep]
    d, _ = cKDTree(kept).query(kept, k=2, workers=-1)
    assert d[:, 1].min() >= 1.0 - 1e-5
    assert 0 < keep.sum() < len(pts)
    # Maximality: every removed point has a kept point within dst.
    d_removed, _ = cKDTree(kept).query(pts[~keep], k=1, workers=-1)
    assert d_removed.max() <= 1.0 + 1e-5


@pytest.mark.parametrize("seed,dst", [(7, 0.5), (3, 0.8)])
def test_reduce_points_matches_python_reference(lib, seed, dst):
    """Same seed => identical greedy visit order => identical keep mask, in
    the port's native and Python paths, mvs_tpu's Python path and its
    native library."""
    rng = np.random.default_rng(2 + seed)
    pts = rng.uniform(0, 5, (800, 3)).astype(np.float32)
    mask = native.reduce_points_mask(pts, dst=dst, seed=seed)
    assert mask.dtype == bool
    np.testing.assert_array_equal(mask, reduce_points(pts, dst, seed=seed,
                                                      use_native=False))
    np.testing.assert_array_equal(mask, reduce_points(pts, dst, seed=seed))
    np.testing.assert_array_equal(
        mask, jax_reduce_points(pts, dst, seed=seed, use_native=False))
    np.testing.assert_array_equal(
        mask, jax_native.reduce_points_mask(pts, dst, seed=seed))


def _clouds(seed):
    """A bumpy GT surface over 40x30 and a noisy, holed reconstruction with
    far outliers."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform([0, 0], [40, 30], (6000, 2))
    stl = np.column_stack([xy, 2 * np.sin(xy[:, 0] / 5) + np.cos(xy[:, 1] / 7)])
    data = stl[rng.random(len(stl)) < 0.7]
    data = data + rng.normal(0, 0.2, data.shape)
    data = np.concatenate([data, rng.uniform(-60, 100, (50, 3))])
    return data.astype(np.float32), stl.astype(np.float32)


FIELDS = ("acc_mean", "acc_median", "acc_var", "comp_mean", "comp_median",
          "comp_var")


@pytest.mark.parametrize("decimate", [False, True])
@pytest.mark.parametrize("use_native", [True, False])
def test_evaluate_scan_matches_jax(lib, monkeypatch, use_native, decimate):
    """Native on: both protocols run their f32 KD-trees (the port's built
    without host-specific flags, mvs_tpu's with -march=native, so the last
    bit of a distance may differ: 1e-6 relative). Off: both run scipy's f64
    arithmetic, 1e-9."""
    if not use_native:
        monkeypatch.setattr(jax_native, "available", lambda: False)
    data, stl = _clouds(4)
    got = evaluate_scan(data, stl, decimate_data=decimate,
                        use_native=use_native)
    want = jax_evaluate_scan(data, stl, decimate_data=decimate)
    assert (got.n_data, got.n_stl) == (want.n_data, want.n_stl)
    rel = 1e-6 if use_native else 1e-9
    for field in FIELDS:
        assert getattr(got, field) == pytest.approx(getattr(want, field),
                                                    rel=rel), field


def test_evaluate_scan_native_agrees_with_scipy(lib):
    """The port's two branches on one cloud: the same decimation, and
    distances that differ by f32 rounding only."""
    data, stl = _clouds(5)
    fast = evaluate_scan(data, stl)
    slow = evaluate_scan(data, stl, use_native=False)
    assert (fast.n_data, fast.n_stl) == (slow.n_data, slow.n_stl)
    for field in FIELDS:
        assert getattr(fast, field) == pytest.approx(getattr(slow, field),
                                                     rel=1e-5), field


def test_without_compiler_falls_back_to_scipy(monkeypatch, tmp_path):
    """No compiler and no library: available() is False, and the protocol
    gives scipy's results."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_compiler", lambda: None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    assert not native.available()
    data, stl = _clouds(6)
    np.testing.assert_array_equal(
        native.reduce_points_mask(data, 0.5, seed=1),
        reduce_points(data, 0.5, seed=1, use_native=False))
    dists = native.nn_distances(data, stl)
    np.testing.assert_allclose(dists, cKDTree(stl).query(data)[0], rtol=1e-6)
    got = evaluate_scan(data, stl)
    want = evaluate_scan(data, stl, use_native=False)
    assert got.overall == want.overall


def test_compile_error_warns_and_falls_back(lib, monkeypatch, tmp_path):
    """A source the compiler rejects: a warning with its output, no
    library, and the scipy path."""
    broken = tmp_path / "kdtree.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.warns(UserWarning, match="could not build kdtree.cpp"):
        assert not native.available()
    assert not any((tmp_path / "build").iterdir())
    data, stl = _clouds(7)
    assert evaluate_scan(data, stl).overall == evaluate_scan(
        data, stl, use_native=False).overall


_CTYPES = {"const float*": ctypes.POINTER(ctypes.c_float),
           "float*": ctypes.POINTER(ctypes.c_float),
           "const int32_t*": ctypes.POINTER(ctypes.c_int32),
           "uint8_t*": ctypes.POINTER(ctypes.c_uint8),
           "int64_t": ctypes.c_int64, "float": ctypes.c_float}


@pytest.mark.parametrize("fn", sorted(native._SIGNATURES))
def test_ctypes_signature_matches_kdtree_cpp(fn):
    """Each declared argtype is the ctypes type of the extern "C"
    parameter at the same position, and both entries return void."""
    text = native.SOURCE.read_text()
    m = re.search(r"\bvoid " + fn + r"\(([^)]*)\)", text)
    assert m, f"{fn} not found in kdtree.cpp"
    params = [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]
    params = [p.replace(" *", "*") for p in params]
    argtypes, restype = native._SIGNATURES[fn]
    assert [_CTYPES[p] for p in params] == argtypes, params
    assert restype is None


def test_library_is_the_ports_own():
    """Built under build/mvs_tpu_torch with a name that hashes the source
    and the flags, never mvs_tpu's native/libmvs_native.so, with no
    host-specific code generation."""
    path = native.library_path()
    assert path.parent == ROOT / "build" / "mvs_tpu_torch"
    assert path.name.startswith("libmvs_kdtree-")
    assert path != ROOT / "native" / "libmvs_native.so"
    assert not any(f.startswith(("-march", "-mtune", "-mcpu"))
                   for f in native.CXX_FLAGS)


def test_library_name_hashes_source_and_flags(monkeypatch, tmp_path):
    src = tmp_path / "kdtree.cpp"
    src.write_text(native.SOURCE.read_text())
    monkeypatch.setattr(native, "SOURCE", src)
    before = native.library_path()
    src.write_text(native.SOURCE.read_text() + "// edit\n")
    edited = native.library_path()
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert len({before, edited, native.library_path()}) == 3


def test_concurrent_builds(lib, tmp_path):
    """Six processes build into one empty directory at once: each renames
    its own finished file into place, so every one loads a whole library
    and computes the same distances."""
    code = (
        "import sys, numpy as np\n"
        "from pathlib import Path\n"
        "from mvs_tpu_torch import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "assert native.build() and native.available()\n"
        "rng = np.random.default_rng(0)\n"
        "t = rng.uniform(0, 1, (2000, 3)); q = rng.uniform(0, 1, (500, 3))\n"
        "print(float(native.nn_distances(q, t).sum()))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, outs
    assert len({out for out, _ in outs}) == 1
    assert [p.name for p in tmp_path.iterdir()] == [
        native.library_path().name]
