"""The port's gipuma / fusibile export (mvs_tpu_torch.io.dmb,
mvs_tpu_torch.fusion.gipuma_bridge) against mvs_tpu's on the CPU: the
.dmb codec round trip and its bytes, and an export whose layout is
mvs_tpu's file by file: the .dmb and .P files byte for byte, the images by
decoded pixels. mvs_tpu saves JPEG through PIL; the port writes PNG data
under the same .jpg names (fusibile reads them through OpenCV, which
decodes by content), whose pixels are exactly the uint8 image mvs_tpu
hands PIL, and within JPEG's loss (quality 98: mean under 1 level, the
largest under 16) of mvs_tpu's decoded file.
"""

import numpy as np
import pytest
from PIL import Image

from mvs_tpu.fusion import gipuma_bridge as jax_bridge
from mvs_tpu.io import dmb as jax_dmb
from mvs_tpu_torch.fusion.gipuma_bridge import (export_gipuma_scene,
                                                find_fusibile_output)
from mvs_tpu_torch.io.dmb import read_dmb, write_dmb
from mvs_tpu_torch.io.png import PNG_SIGNATURE, read_png
from mvs_tpu_torch.utils.synthetic import make_plane_scene


@pytest.mark.parametrize("shape", [(5, 7), (4, 6, 3), (3, 2, 1)])
def test_dmb_round_trip_and_bytes(tmp_path, shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    write_dmb(tmp_path / "port.dmb", x)
    jax_dmb.write_dmb(tmp_path / "jax.dmb", x)
    assert (tmp_path / "port.dmb").read_bytes() == \
        (tmp_path / "jax.dmb").read_bytes()
    back = read_dmb(tmp_path / "jax.dmb")
    np.testing.assert_array_equal(back, x[..., 0] if shape[-1] == 1 and
                                  len(shape) == 3 else x)
    np.testing.assert_array_equal(back,
                                  jax_dmb.read_dmb(tmp_path / "port.dmb"))


def test_dmb_refuses_other_types(tmp_path):
    np.array([2, 1, 1, 1], "<i4").tofile(tmp_path / "x.dmb")
    with pytest.raises(ValueError, match="unsupported dmb type 2"):
        read_dmb(tmp_path / "x.dmb")


def test_export_matches_jax_file_by_file(tmp_path):
    s = make_plane_scene(num_views=3, height=24, width=32, z0=10.0, seed=1,
                         tilt=(0.05, 0.02))
    rng = np.random.default_rng(2)
    confs = rng.uniform(0.5, 1.0, s.depths.shape).astype(np.float32)
    args = (s.depths, confs, s.images, s.intrinsics, s.extrinsics)
    export_gipuma_scene(tmp_path / "port", *args, view_ids=[3, 5, 9])
    jax_bridge.export_gipuma_scene(tmp_path / "jax", *args,
                                   view_ids=[3, 5, 9])
    files = {p.relative_to(tmp_path / "jax")
             for p in (tmp_path / "jax").rglob("*") if p.is_file()}
    assert files == {p.relative_to(tmp_path / "port")
                     for p in (tmp_path / "port").rglob("*") if p.is_file()}
    assert len(files) == 3 * 4
    for rel in sorted(files):
        got, want = tmp_path / "port" / rel, tmp_path / "jax" / rel
        if rel.parts[0] != "images":
            assert got.read_bytes() == want.read_bytes(), rel
            continue
        assert got.read_bytes()[:8] == PNG_SIGNATURE
        pixels = read_png(got)
        i = [3, 5, 9].index(int(rel.stem))
        exact = (np.clip(s.images[i], 0, 1) * 255).astype(np.uint8)
        np.testing.assert_array_equal(pixels, exact)
        with Image.open(want) as im:
            diff = np.abs(pixels.astype(int) - np.asarray(im).astype(int))
        assert diff.mean() < 1.0 and diff.max() < 16, (rel, diff.max())
    depth = read_dmb(tmp_path / "port" / "2333_00000005" / "disp.dmb")
    np.testing.assert_array_equal(depth, np.where(confs[1] >= 0.8,
                                                  s.depths[1], 0.0))


def test_find_fusibile_output(tmp_path):
    assert find_fusibile_output(tmp_path) is None
    for name in ("consistencyCheck-20240101", "consistencyCheck-20240102"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "final3d_model.ply").write_text("ply\n")
    assert find_fusibile_output(tmp_path) == \
        jax_bridge.find_fusibile_output(tmp_path) == \
        tmp_path / "consistencyCheck-20240102" / "final3d_model.ply"
