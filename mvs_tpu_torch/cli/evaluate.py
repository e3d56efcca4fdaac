"""DTU quantitative evaluation of fused point clouds.

    python -m mvs_tpu_torch.cli evaluate --out outputs/ --gt /path/to/dtu_eval_data

Runs the reimplemented MATLAB protocol (dtu_eval, a copy of
mvs_tpu.dtu_eval) over every <scan>/fused.ply, using the DTU GT layout: Points/stl/stlXXX_total.ply,
ObsMask/ObsMaskX_10.mat, ObsMask/PlaneX.mat. Prints per-scan acc/comp and the
cross-scan means (the headline numbers)."""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

from mvs_tpu_torch.dtu_eval import (
    aggregate_scans, evaluate_scan, load_ground_plane, load_obs_mask,
)
from mvs_tpu_torch.io.ply import read_ply

__all__ = ["main"]


def _scan_number(name: str) -> int | None:
    m = re.search(r"(\d+)", name)
    return int(m.group(1)) if m else None


def main(argv=None) -> dict | None:
    """Run the CLI; returns the report ({"aggregate", "per_scan"}), or None
    when no scan was evaluated."""
    p = argparse.ArgumentParser(prog="mvs_tpu_torch evaluate")
    p.add_argument("--out", default="outputs")
    p.add_argument("--gt", required=True, help="DTU eval data root")
    p.add_argument("--ply-name", default="fused.ply")
    p.add_argument("--report", default=None, help="write JSON report here")
    args = p.parse_args(argv)

    gt_root = Path(args.gt)
    out_root = Path(args.out)
    results, per_scan = [], {}
    for scan_dir in sorted(out_root.iterdir()):
        ply = scan_dir / args.ply_name
        num = _scan_number(scan_dir.name)
        if not ply.exists() or num is None:
            continue
        stl_path = gt_root / "Points" / "stl" / f"stl{num:03d}_total.ply"
        if not stl_path.exists():
            print(f"skip {scan_dir.name}: no GT at {stl_path}")
            continue
        data = read_ply(ply)["xyz"]
        stl = read_ply(stl_path)["xyz"]
        mask_path = gt_root / "ObsMask" / f"ObsMask{num}_10.mat"
        plane_path = gt_root / "ObsMask" / f"Plane{num}.mat"
        res = evaluate_scan(
            data, stl,
            obs_mask=load_obs_mask(mask_path) if mask_path.exists() else None,
            ground_plane=load_ground_plane(plane_path) if plane_path.exists() else None,
        )
        results.append(res)
        per_scan[scan_dir.name] = {
            "acc": res.acc_mean, "comp": res.comp_mean, "overall": res.overall,
        }
        print(f"{scan_dir.name}: acc {res.acc_mean:.4f} mm, "
              f"comp {res.comp_mean:.4f} mm, overall {res.overall:.4f} mm")

    if results:
        agg = aggregate_scans(results)
        print(f"\nmean acc {agg['mean_acc']:.4f} mm | "
              f"mean comp {agg['mean_comp']:.4f} mm | "
              f"overall {agg['overall']:.4f} mm over {agg['num_scans']} scans")
        report = {"aggregate": agg, "per_scan": per_scan}
        if args.report:
            with open(args.report, "w") as f:
                json.dump(report, f, indent=2)
        return report
    print("no scans evaluated")
    return None


if __name__ == "__main__":
    main()
