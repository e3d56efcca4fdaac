"""One family of the quality matrix on the CPU, from mvs_tpu or from the
port, printing its mean depth error and the constant-z0 floor.

    JAX_PLATFORMS=cpu python tests/matrix_reference.py jax cvp_mvsnet
    python tests/matrix_reference.py port cvp_mvsnet [--seed 1]

`jax` runs tests/test_e2e_matrix.py's own chain (cli train at
train.mesh_data=2 on two virtual CPU devices, then cli infer and
_depth_errors); `port` runs chip_smoke.py's phase-12 chain for the family
on the CPU (torch.cuda stubbed, the kernels' plain versions, no launch
checks, no full-width scans), at train.seed=--seed. These are the CPU
numbers chip_smoke.py's phase 12 is read against; a family takes 1-13 min
(mvs_tpu) or 0.5-2 min (the port) on a few cores.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_jax(family: str) -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=2")
    sys.path.insert(0, str(ROOT / "tests"))
    import test_e2e_matrix as matrix

    import chip_smoke  # the gates' model arguments and epochs, one table

    args, epochs, _, _ = chip_smoke.MATRIX[family]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        matrix.generate(tmp / "dtu", num_scans=2, num_views=matrix.VIEWS,
                        height=matrix.H, width=matrix.W, num_depth=16,
                        scene_type="objects", tilt=(0.08, 0.05))
        t0 = time.perf_counter()
        matrix._run_family(tmp / "dtu", tmp / "run", tmp / "out",
                           [f"model.name={family}", *args], [], epochs)
        err, const = matrix._depth_errors(tmp / "out")
    print(f"mvs_tpu {family}: err {err:.4f} const {const:.4f} "
          f"({time.perf_counter() - t0:.0f} s)")


def run_port(family: str, seed: int) -> None:
    import torch

    torch.cuda.synchronize = lambda *a, **k: None
    import chip_smoke as cs

    cs.check_launched = lambda *a: None
    cs.fail = lambda msg: print(f"gate missed: {msg}")
    cs.MATRIX = {family: cs.MATRIX[family]}
    cs.MATRIX_TRAIN = [*cs.MATRIX_TRAIN, f"train.seed={seed}"]
    cs.MATRIX_FULL = {}
    with tempfile.TemporaryDirectory() as tmp:
        row = cs.phase_matrix("cpu", Path(tmp))[family]["float32"]
    print(f"port {family} seed {seed}: err {row['err']:.4f} const "
          f"{row['const']:.4f}")


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("side", choices=("jax", "port"))
    p.add_argument("family", choices=("cas_mvsnet", "mvsnet", "cvp_mvsnet",
                                      "point_mvsnet", "aacvp_mvsnet"))
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    if args.side == "jax":
        run_jax(args.family)
    else:
        run_port(args.family, args.seed)


if __name__ == "__main__":
    main()
