"""DTU quantitative evaluation: accuracy / completeness in mm.

Re-implements the reference MATLAB protocol (Evaluation/dtu/):
  * stochastic 0.2 mm point decimation          (reducePts_haa.m)
  * data->STL distances  = accuracy             (PointCompareMain.m, MaxDistCP.m)
  * STL->data distances  = completeness
  * ObsMask voxel-grid filtering of data points; ground-plane filtering of
    STL points                                  (PointCompareMain.m:31-57)
  * 20 mm outlier cutoff, per-scan mean/median/var, cross-scan means
                                                (ComputeStat_web.m:30-88)

KD-tree nearest neighbours and the decimation run on the port's native C++
KD-tree (mvs_tpu_torch.native) when the host can build it, else on scipy's
cKDTree (the MATLAB code's chunked KDTreeSearcher is an out-of-core
workaround we don't need); use_native=False asks for scipy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.spatial import cKDTree

__all__ = ["reduce_points", "ScanEvalResult", "evaluate_scan", "aggregate_scans",
           "load_obs_mask", "load_ground_plane"]


def reduce_points(pts: np.ndarray, dst: float = 0.2, seed: int | None = 0,
                  chunk: int = 4_000_000, use_native: bool = True) -> np.ndarray:
    """Stochastic decimation: visit points in random order, keep a point iff no
    already-kept point lies within `dst`. Matches reducePts_haa.m (the
    reference uses MATLAB randperm; pass seed=None for nondeterministic order).

    pts: (N, 3). Returns a boolean keep-mask (N,). Uses the C++ KD-tree core
    (mvs_tpu_torch.native) when built; falls back to scipy.
    """
    if use_native:
        from mvs_tpu_torch import native

        if native.available():
            return native.reduce_points_mask(pts, dst, seed=seed)
    n = pts.shape[0]
    rng = np.random.default_rng(seed)
    order = rng.permutation(n) if seed is not None else np.random.permutation(n)
    keep = np.ones(n, dtype=bool)
    tree = cKDTree(pts)
    for start in range(0, n, chunk):
        idx_chunk = order[start:start + chunk]
        neighbor_lists = tree.query_ball_point(pts[idx_chunk], dst, workers=-1)
        for i, neighbors in zip(idx_chunk, neighbor_lists):
            if keep[i]:
                keep[neighbors] = False
                keep[i] = True
    return keep


@dataclasses.dataclass
class ScanEvalResult:
    acc_mean: float  # mean data->STL distance (mm), lower = more accurate
    acc_median: float
    comp_mean: float  # mean STL->data distance (mm), lower = more complete
    comp_median: float
    acc_var: float
    comp_var: float
    n_data: int
    n_stl: int

    @property
    def overall(self) -> float:
        return 0.5 * (self.acc_mean + self.comp_mean)


def _nn_distances(query: np.ndarray, target: np.ndarray,
                  use_native: bool = True) -> np.ndarray:
    if use_native:
        from mvs_tpu_torch import native

        if native.available():
            return native.nn_distances(query, target).astype(np.float64)
    dists, _ = cKDTree(target).query(query, k=1, workers=-1)
    return dists


def load_obs_mask(mat_path):
    """Load an ObsMaskN_10.mat file -> (mask voxel grid, BB (2,3), Res)."""
    from scipy.io import loadmat

    m = loadmat(mat_path)
    return m["ObsMask"], np.asarray(m["BB"], dtype=np.float64), float(m["Res"].squeeze())


def load_ground_plane(mat_path) -> np.ndarray:
    """Load a PlaneN.mat file -> P (4,) plane coefficients."""
    from scipy.io import loadmat

    return np.asarray(loadmat(mat_path)["P"], dtype=np.float64).reshape(4)


def _mask_data_points(pts: np.ndarray, obs_mask: np.ndarray, bb: np.ndarray,
                      res: float) -> np.ndarray:
    """True where a data point falls in an occupied ObsMask voxel
    (PointCompareMain.m:31-41; MATLAB 1-based rounding reproduced exactly)."""
    qv = np.round((pts - bb[0]) / res + 1).astype(np.int64)  # 1-based
    in_bounds = (
        (qv[:, 0] > 0) & (qv[:, 0] <= obs_mask.shape[0])
        & (qv[:, 1] > 0) & (qv[:, 1] <= obs_mask.shape[1])
        & (qv[:, 2] > 0) & (qv[:, 2] <= obs_mask.shape[2])
    )
    keep = np.zeros(len(pts), dtype=bool)
    ib = np.where(in_bounds)[0]
    keep[ib] = obs_mask[qv[ib, 0] - 1, qv[ib, 1] - 1, qv[ib, 2] - 1] > 0
    return keep


def evaluate_scan(
    data_pts: np.ndarray,  # (N, 3) reconstructed cloud
    stl_pts: np.ndarray,  # (M, 3) ground-truth structured-light cloud
    dst: float = 0.2,
    max_dist: float = 20.0,
    obs_mask=None,  # (mask grid, BB, Res) tuple from load_obs_mask
    ground_plane: np.ndarray | None = None,  # (4,) plane, STL kept where P·[x;1]>0
    decimate_data: bool = True,
    seed: int | None = 0,
    use_native: bool = True,  # False: scipy's KD-tree even where native builds
) -> ScanEvalResult:
    data = np.asarray(data_pts, dtype=np.float64)
    stl = np.asarray(stl_pts, dtype=np.float64)
    if decimate_data and len(data):
        data = data[reduce_points(data, dst, seed=seed, use_native=use_native)]
    # (The reference STL clouds ship pre-decimated at 0.2 mm.)

    both = len(data) and len(stl)
    d_data = _nn_distances(data, stl, use_native) if both else np.empty(0)
    d_stl = _nn_distances(stl, data, use_native) if both else np.empty(0)

    if obs_mask is not None and len(data):
        mask_grid, bb, res = obs_mask
        d_data = d_data[_mask_data_points(data, mask_grid, bb, res)]
    if ground_plane is not None and len(stl):
        above = stl @ ground_plane[:3] + ground_plane[3] > 0
        d_stl = d_stl[above]

    d_data = d_data[d_data < max_dist]
    d_stl = d_stl[d_stl < max_dist]

    def _stats(d):
        if len(d) == 0:
            return np.nan, np.nan, np.nan
        return float(np.mean(d)), float(np.median(d)), float(np.var(d))

    acc_mean, acc_med, acc_var = _stats(d_data)
    comp_mean, comp_med, comp_var = _stats(d_stl)
    return ScanEvalResult(
        acc_mean=acc_mean, acc_median=acc_med, acc_var=acc_var,
        comp_mean=comp_mean, comp_median=comp_med, comp_var=comp_var,
        n_data=len(d_data), n_stl=len(d_stl),
    )


def aggregate_scans(results: list[ScanEvalResult]) -> dict:
    """Cross-scan means, the headline DTU numbers (ComputeStat_web.m:80-88)."""
    acc = float(np.mean([r.acc_mean for r in results]))
    comp = float(np.mean([r.comp_mean for r in results]))
    return {
        "mean_acc": acc,
        "mean_comp": comp,
        "overall": 0.5 * (acc + comp),
        "num_scans": len(results),
    }
