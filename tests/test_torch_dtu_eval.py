"""The port's DTU evaluation protocol against mvs_tpu's, on seeded clouds.

Both protocols run their native C++ KD-tree when it is built (f32
distances). These comparisons turn the native path off on both sides, so
both compute the same f64 scipy arithmetic and are held to 1e-9 relative;
test_torch_native.py holds the native paths.
"""

import numpy as np
import pytest
from scipy.io import savemat
from scipy.spatial import cKDTree

import mvs_tpu.native
import mvs_tpu_torch.native
from mvs_tpu.dtu_eval import aggregate_scans as jax_aggregate_scans
from mvs_tpu.dtu_eval import evaluate_scan as jax_evaluate_scan
from mvs_tpu.dtu_eval import load_ground_plane as jax_load_ground_plane
from mvs_tpu.dtu_eval import load_obs_mask as jax_load_obs_mask
from mvs_tpu.dtu_eval import reduce_points as jax_reduce_points
from mvs_tpu_torch.dtu_eval import (aggregate_scans, evaluate_scan,
                                    load_ground_plane, load_obs_mask,
                                    reduce_points)

REL = 1e-9


@pytest.fixture
def scipy_only(monkeypatch):
    monkeypatch.setattr(mvs_tpu.native, "available", lambda: False)
    monkeypatch.setattr(mvs_tpu_torch.native, "available", lambda: False)


def _clouds(seed):
    """A noisy surface z = sin-bumps over 40x30 mm (GT) and a reconstruction
    with noise, holes and far outliers."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform([0, 0], [40, 30], (6000, 2))
    stl = np.column_stack([xy, 2 * np.sin(xy[:, 0] / 5) + np.cos(xy[:, 1] / 7)])
    data = stl[rng.random(len(stl)) < 0.7] + rng.normal(0, 0.3, (1, 3))
    data = data + rng.normal(0, 0.2, data.shape)
    data = np.concatenate([data, rng.uniform(-60, 100, (50, 3))])
    return data.astype(np.float32), stl.astype(np.float32)


@pytest.mark.parametrize("seed,dst", [(0, 0.2), (3, 1.0), (7, 0.5)])
def test_reduce_points_matches_jax(scipy_only, seed, dst):
    data, _ = _clouds(seed)
    keep = reduce_points(data, dst, seed=seed)
    np.testing.assert_array_equal(
        keep, jax_reduce_points(data, dst, seed=seed, use_native=False))
    assert 0 < keep.sum() < len(data)


def _masks():
    bb = np.array([[-1.0, -1.0, -4.0], [41.0, 31.0, 4.0]])
    grid = np.zeros((21, 16, 4), np.uint8)
    grid[:15, :, :] = 1  # occupied for x < 29
    return (grid, bb, 2.0), np.array([0.2, 0.0, 1.0, -0.5])


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("with_plane", [False, True])
@pytest.mark.parametrize("decimate", [False, True])
def test_evaluate_scan_matches_jax(scipy_only, with_mask, with_plane,
                                   decimate):
    data, stl = _clouds(1)
    obs, plane = _masks()
    kw = dict(obs_mask=obs if with_mask else None,
              ground_plane=plane if with_plane else None,
              decimate_data=decimate)
    got = evaluate_scan(data, stl, **kw)
    want = jax_evaluate_scan(data, stl, **kw)
    assert (got.n_data, got.n_stl) == (want.n_data, want.n_stl)
    for field in ("acc_mean", "acc_median", "acc_var", "comp_mean",
                  "comp_median", "comp_var"):
        assert getattr(got, field) == pytest.approx(getattr(want, field),
                                                    rel=REL)
    assert got.overall == pytest.approx(want.overall, rel=REL)


def test_aggregate_scans_matches_jax(scipy_only):
    results, jax_results = [], []
    for seed in (1, 2):
        data, stl = _clouds(seed)
        results.append(evaluate_scan(data, stl, decimate_data=False))
        jax_results.append(jax_evaluate_scan(data, stl, decimate_data=False))
    got, want = aggregate_scans(results), jax_aggregate_scans(jax_results)
    assert got.keys() == want.keys() and got["num_scans"] == 2
    for key in ("mean_acc", "mean_comp", "overall"):
        assert got[key] == pytest.approx(want[key], rel=REL)


def test_mat_loaders_match_jax(tmp_path):
    (grid, bb, res), plane = _masks()
    savemat(tmp_path / "ObsMask1_10.mat", {"ObsMask": grid, "BB": bb,
                                           "Res": np.array([[res]])})
    savemat(tmp_path / "Plane1.mat", {"P": plane.reshape(4, 1)})
    got = load_obs_mask(tmp_path / "ObsMask1_10.mat")
    want = jax_load_obs_mask(tmp_path / "ObsMask1_10.mat")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] == res
    np.testing.assert_array_equal(load_ground_plane(tmp_path / "Plane1.mat"),
                                  jax_load_ground_plane(tmp_path
                                                        / "Plane1.mat"))


# The protocol behaviours of tests/test_fusion_eval.py, on the port.

def test_reduce_points_min_distance():
    pts = np.random.default_rng(0).uniform(0, 10, (2000, 3))
    keep = reduce_points(pts, dst=1.0)
    kept = pts[keep]
    d, _ = cKDTree(kept).query(kept, k=2, workers=-1)
    assert d[:, 1].min() >= 1.0
    assert keep.sum() < len(pts)


def test_evaluate_scan_perfect_match():
    stl = np.random.default_rng(1).uniform(0, 100, (5000, 3))
    res = evaluate_scan(stl.copy(), stl, decimate_data=False)
    assert res.acc_mean == pytest.approx(0.0, abs=1e-9)
    assert res.comp_mean == pytest.approx(0.0, abs=1e-9)
    assert res.overall == pytest.approx(0.0, abs=1e-9)


def test_evaluate_scan_known_offset():
    xs, ys = np.meshgrid(np.linspace(0, 50, 201), np.linspace(0, 50, 201))
    stl = np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)], axis=1)
    res = evaluate_scan(stl + np.array([0, 0, 1.0]), stl, decimate_data=False)
    assert res.acc_mean == pytest.approx(1.0, rel=1e-6)
    assert res.comp_mean == pytest.approx(1.0, rel=1e-6)


def test_evaluate_scan_outlier_cutoff_and_masks():
    stl = np.random.default_rng(2).uniform(0, 100, (3000, 3))
    data = np.concatenate([stl, np.full((100, 3), 1000.0)])
    assert evaluate_scan(data, stl, decimate_data=False).acc_mean < 0.5
    res = evaluate_scan(stl.copy(), stl, decimate_data=False,
                        ground_plane=np.array([0.0, 0.0, 1.0, -50.0]))
    assert res.n_stl == int((stl[:, 2] > 50).sum())
    grid = np.ones((10, 20, 20), np.uint8)  # covers x in [0, 50)
    res = evaluate_scan(stl.copy(), stl, decimate_data=False,
                        obs_mask=(grid, np.array([[0.0, 0, 0], [100, 100,
                                                                100]]), 5.0))
    assert res.n_data < len(stl)


def test_aggregate_scans():
    r = evaluate_scan(np.zeros((10, 3)), np.zeros((10, 3)),
                      decimate_data=False)
    agg = aggregate_scans([r, r])
    assert agg["overall"] == pytest.approx(0.0)
    assert agg["num_scans"] == 2
