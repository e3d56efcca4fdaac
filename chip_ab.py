"""Compare two checkouts of the port on one CUDA card, in turns.

    python3 chip_ab.py PARENT_DIR CHANGE_DIR NAME [NAME ...]

Each NAME is a function of the chip_smoke.py beside this file that takes the
device and returns {label: ms} (chip_smoke's `ab_` functions, e.g.
ab_group_levels ab_aacvp_f32_convs ab_pyramid_maps ab_cas_f32_map). The
script runs them for PARENT, CHANGE, CHANGE, PARENT, each run a fresh
process that imports DIR's mvs_tpu_torch, builds DIR's kernels and calls the
functions of this chip_smoke.py on them; then it prints one table, a row per
label and a column per run. A function measured so calls only what both
checkouts' packages have. Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def measure(tree: Path, names) -> dict:
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import mvs_tpu_torch
    if Path(mvs_tpu_torch.__file__).resolve().parent.parent != tree:
        raise SystemExit(f"imported {mvs_tpu_torch.__file__}, not {tree}'s")
    device = cs.resolve_device()
    cs._build.build()
    rows = {}
    for name in names:
        rows.update(getattr(cs, name)(device))
    return rows


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_ab: CUDA is not available", file=sys.stderr)
        return 2
    if argv[:1] == ["--measure"]:
        print(json.dumps(measure(Path(argv[1]).resolve(), argv[2:])),
              flush=True)
        return 0
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = (Path(a).resolve() for a in argv[:2])
    runs = []
    for label, tree in (("parent", parent), ("change", change),
                        ("change", change), ("parent", parent)):
        out = subprocess.run(
            [sys.executable, str(HERE / "chip_ab.py"), "--measure",
             str(tree), *argv[2:]], cwd=tree, capture_output=True, text=True)
        if out.returncode:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        runs.append((label, json.loads(out.stdout.splitlines()[-1])))
        print(f"{label} {tree}: {json.dumps(runs[-1][1])}", flush=True)
    print("| ms | " + " | ".join(label for label, _ in runs) + " |")
    print("|---|" + "---|" * len(runs))
    for key in runs[0][1]:
        print(f"| {key} | "
              + " | ".join(f"{rows[key]:.4f}" for _, rows in runs) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
