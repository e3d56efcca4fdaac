from mvs_tpu_torch.dtu_eval.protocol import (
    ScanEvalResult, aggregate_scans, evaluate_scan, load_ground_plane,
    load_obs_mask, reduce_points,
)

__all__ = [
    "ScanEvalResult", "aggregate_scans", "evaluate_scan",
    "load_ground_plane", "load_obs_mask", "reduce_points",
]
