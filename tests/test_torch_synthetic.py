"""The port's synthetic scenes and DTU fixture generator against mvs_tpu's.

The scenes are numpy only and run the same arithmetic in the same order, so
images, depths and cameras must be exactly equal; so must every file of
generate(scene_type="objects") except the eval images, which the port
writes as PNG and mvs_tpu as JPEG: those are held to the scene's u8 pixels.
"""

import numpy as np
import pytest
from PIL import Image

from mvs_tpu.utils import synthetic as jax_synthetic
from mvs_tpu.utils.make_synthetic_dtu import generate as jax_generate
from mvs_tpu.utils.make_synthetic_dtu import main as jax_main
from mvs_tpu_torch.io.pfm import read_pfm
from mvs_tpu_torch.io.ply import read_ply
from mvs_tpu_torch.io.png import read_png
from mvs_tpu_torch.utils import synthetic
from mvs_tpu_torch.utils.make_synthetic_dtu import generate, main

FIELDS = ("images", "depths", "intrinsics", "extrinsics")


def _assert_scenes_equal(got, want):
    for field in FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert (got.depth_min, got.depth_max) == (want.depth_min, want.depth_max)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("size", [(64, 96), (40, 72)])
@pytest.mark.parametrize("name", ["make_objects_scene", "make_step_scene"])
def test_scene_matches_jax(name, size, seed):
    height, width = size
    kw = dict(num_views=4, height=height, width=width, seed=seed)
    got = getattr(synthetic, name)(**kw)
    _assert_scenes_equal(got, getattr(jax_synthetic, name)(**kw))
    assert got.images.shape == (4, height, width, 3)
    if name == "make_step_scene":
        # Both planes are in view, the near and the far, and off-axis views
        # see past the step's edge where no plane is.
        hit = got.depths[got.depths > 0]
        assert hit.min() < 9.5 and hit.max() > 11.0
        assert (got.depths[0] > 0).all()
    else:
        assert (got.depths > 0).all()  # the backdrop fills every view


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("size", [(64, 96), (40, 72)])
def test_objects_scene_keywords_match_jax(size, seed):
    """The full-width rig: focal scaled with the width, another tilt."""
    height, width = size
    kw = dict(num_views=3, height=height, width=width, seed=seed,
              focal=100.0 * width / 96, tilt=(0.05, 0.02), texture_freq=1.5,
              baseline=0.8, jitter_angle=0.03)
    _assert_scenes_equal(synthetic.make_objects_scene(**kw),
                         jax_synthetic.make_objects_scene(**kw))


def test_render_objects_matches_jax():
    """Spheres that occlude each other and the backdrop, and one ray set
    that misses everything (depth 0)."""
    scene = jax_synthetic.make_plane_scene(num_views=3, height=48, width=64)
    planes = [(10.0, 0.05, 0.0, -2.0, np.inf)]
    spheres = [(0.0, 0.0, 8.0, 1.0), (0.5, 0.2, 7.0, 0.6),
               (-1.5, 1.0, 9.0, 0.8)]
    args = (scene.intrinsics.astype(np.float64),
            scene.extrinsics.astype(np.float64), 48, 64, planes, spheres)
    got = synthetic._render_objects(*args, freq=2.0)
    want = jax_synthetic._render_objects(*args, freq=2.0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    depths = got[1]
    assert (depths == 0).any() and (depths > 0).any()
    assert depths[depths > 0].min() < 7.5  # the nearest sphere shows


@pytest.fixture(scope="module")
def objects_roots(tmp_path_factory):
    kw = dict(num_scans=2, num_views=5, height=64, width=96, num_depth=16,
              scene_type="objects", tilt=(0.08, 0.05))
    return (generate(tmp_path_factory.mktemp("port"), **kw),
            jax_generate(tmp_path_factory.mktemp("jax"), **kw))


def _assert_layouts_equal(root, jax_root, last_view=4):
    for rel in ("scan1/cams/00000003_cam.txt", "scan2/cams/00000000_cam.txt",
                "scan1/pair.txt", "scan2/pair.txt",
                "Cameras/00000001_cam.txt", "Cameras/pair.txt",
                "lists/train.txt", "lists/val.txt", "lists/test.txt"):
        assert (root / rel).read_text() == (jax_root / rel).read_text(), rel
    for rel in ("Points/stl/stl001_total.ply", "Points/stl/stl002_total.ply",
                "Depths/scan1_train/depth_map_0002.pfm",
                f"Depths/scan2_train/depth_map_{last_view:04d}.pfm"):
        assert (root / rel).read_bytes() == (jax_root / rel).read_bytes(), rel
    for rel in ("Rectified/scan2_train/rect_004_1_r5000.png",
                "Depths/scan1_train/depth_visual_0001.png"):
        np.testing.assert_array_equal(
            read_png(root / rel), np.asarray(Image.open(jax_root / rel)))


def test_generate_objects_matches_jax(objects_roots):
    root, jax_root = objects_roots
    _assert_layouts_equal(root, jax_root)
    # Eval images: PNG here, decoded equal to the scene's u8 pixels.
    for s in range(2):
        scene = synthetic.make_objects_scene(num_views=5, height=64, width=96,
                                             seed=s, tilt=(0.08, 0.05))
        u8 = (np.clip(scene.images, 0, 1) * 255).astype(np.uint8)
        for v in range(5):
            np.testing.assert_array_equal(
                read_png(root / f"scan{s + 1}" / "images" / f"{v:08d}.png"),
                u8[v])
        depth, _ = read_pfm(root / f"Depths/scan{s + 1}_train/"
                                   "depth_map_0000.pfm")
        np.testing.assert_array_equal(depth, scene.depths[0][::4, ::4])


def test_objects_gt_cloud_is_the_unprojected_depths(objects_roots):
    """The GT cloud is every view's analytic depth unprojected: a fifth of
    it (view 0's share) lands back on view 0's depth map. At 5 x 64 x 96
    pixels it stays under the 60000 points the decimation starts at."""
    root, _ = objects_roots
    stl = read_ply(root / "Points/stl/stl001_total.ply")["xyz"]
    scene = synthetic.make_objects_scene(num_views=5, height=64, width=96,
                                         seed=0, tilt=(0.08, 0.05))
    assert 15000 < len(stl) <= 5 * 64 * 96
    k, rt = scene.intrinsics[0], scene.extrinsics[0]
    uvw = (stl @ rt[:3, :3].T + rt[:3, 3]) @ k.T
    u = np.round(uvw[:, 0] / uvw[:, 2]).astype(int)
    v = np.round(uvw[:, 1] / uvw[:, 2]).astype(int)
    inside = (u >= 0) & (u < 96) & (v >= 0) & (v < 64)
    seen = inside & np.isclose(uvw[:, 2], scene.depths[0][v.clip(0, 63),
                                                          u.clip(0, 95)],
                               atol=1e-3)
    assert seen.mean() > 0.15


def test_scene_flag_matches_jax(tmp_path):
    args = ["--scans", "2", "--views", "4", "--height", "32", "--width", "64",
            "--depths", "8", "--tilt", "0.08", "0.05", "--scene", "objects"]
    main(["--root", str(tmp_path / "port"), *args])
    jax_main(["--root", str(tmp_path / "jax"), *args])
    _assert_layouts_equal(tmp_path / "port", tmp_path / "jax", last_view=3)
    # The default stays the plane fixture, which differs from the objects'.
    main(["--root", str(tmp_path / "plane"), *args[:-2]])
    plane = tmp_path / "plane" / "Points/stl/stl001_total.ply"
    assert plane.read_bytes() != (tmp_path / "port" /
                                  "Points/stl/stl001_total.ply").read_bytes()
