"""Export to the layout of the external fusibile / gipuma fusion binary
(counterpart of mvs_tpu.fusion.gipuma_bridge):

  <out>/images/%08d.jpg        the view's image (PNG data, see below)
  <out>/cams/%08d.jpg.P        3x4 projection K @ [R | t]
  <out>/2333_%08d/disp.dmb     depth, zeroed where the confidence is below
                               prob_threshold
  <out>/2333_%08d/normals.dmb  constant unit normals (1 / sqrt(3) each)

and find fusibile's consistencyCheck-*/final3d_model.ply afterwards. The
port's own fusion (fusion.fuse) replaces the binary; this keeps workflows
that run it working.

mvs_tpu saves the images as JPEG through PIL. The port writes them with its
own PNG codec (io.png), under the .jpg names that fusibile pairs with the
.P files: fusibile reads them through OpenCV, which decodes by content.
The .P and .dmb files are byte for byte mvs_tpu's.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from mvs_tpu_torch.io.dmb import write_dmb
from mvs_tpu_torch.io.png import write_png

__all__ = ["export_gipuma_scene", "find_fusibile_output"]


def export_gipuma_scene(out_dir, depths, confs, images, intrinsics, extrinsics,
                        view_ids=None, prob_threshold: float = 0.8):
    """depths / confs (V, H, W); images (V, H, W, 3) float in [0, 1] or
    None; intrinsics (V, 3, 3); extrinsics (V, 4, 4). Returns out_dir."""
    out = Path(out_dir)
    (out / "images").mkdir(parents=True, exist_ok=True)
    (out / "cams").mkdir(parents=True, exist_ok=True)
    v = len(depths)
    view_ids = list(view_ids) if view_ids is not None else list(range(v))

    fake_normal = np.full((1, 1, 3), 1.0 / np.sqrt(3.0), dtype=np.float32)
    for i, vid in enumerate(view_ids):
        name = f"{vid:08d}"
        depth = np.where(np.asarray(confs[i]) >= prob_threshold,
                         np.asarray(depths[i], np.float32), 0.0)
        sub = out / f"2333_{name}"
        write_dmb(sub / "disp.dmb", depth)
        h, w = depth.shape
        write_dmb(sub / "normals.dmb",
                  np.broadcast_to(fake_normal, (h, w, 3)).copy())

        p = intrinsics[i] @ np.asarray(extrinsics[i])[:3, :4]
        with open(out / "cams" / f"{name}.jpg.P", "w") as f:
            for row in p:
                f.write(" ".join(repr(float(x)) for x in row) + "\n")

        if images is not None:
            img = (np.clip(np.asarray(images[i]), 0, 1) * 255).astype(np.uint8)
            write_png(out / "images" / f"{name}.jpg", img)
    return out


def find_fusibile_output(out_dir) -> Path | None:
    """fusibile's last consistencyCheck*/final3d_model.ply under out_dir."""
    out = Path(out_dir)
    candidates = sorted(out.glob("consistencyCheck*/final3d_model.ply"))
    return candidates[-1] if candidates else None
