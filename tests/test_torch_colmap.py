"""The port's COLMAP converter (mvs_tpu_torch.io.colmap) and inverse-depth
ladder against mvs_tpu's on the CPU.

Models: tests/test_colmap.py's text model of a plane scene, and the same
cameras and points written by the port's write_colmap_model as text and as
binary. Checks: read_colmap_model returns what mvs_tpu's returns (ids,
names, tracks, K, qvec, tvec, points) on each; convert_colmap writes cam
files within 1e-6 relative of mvs_tpu's and the same pair.txt, at
--max_d 192 and 0 (the inverse-depth count); the text and binary models
convert to identical files; a .jpg source is copied byte for byte and a
PNG source is written as {i:08d}.png with the source's RGB pixels (mvs_tpu
writes JPEG through PIL: the recorded delta); `python -m
mvs_tpu_torch.io.colmap` runs; write_colmap_model's cameras convert back to
the scene's (within 1e-6); inverse_depth_values within 1e-6.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_tpu.geometry.depth import inverse_depth_values as jax_inverse
from mvs_tpu.io import colmap as jax_colmap
from mvs_tpu.utils.synthetic import make_plane_scene
from mvs_tpu_torch.geometry.depth import inverse_depth_values
from mvs_tpu_torch.io import colmap, read_cam_file, read_pair_file
from mvs_tpu_torch.io.png import read_png, write_png
from test_colmap import _write_colmap_text

REPO = Path(__file__).resolve().parents[1]


def _scene():
    return make_plane_scene(num_views=4, height=48, width=64, z0=10.0,
                            tilt=(0.05, 0.02))


def _points(seed=0, n=60):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    10.0 + rng.uniform(-1.0, 1.0, n)], axis=1)
    # Each point seen by a seeded subset of at least two views.
    tracks = [sorted(rng.choice(4, size=rng.integers(2, 5), replace=False)
                     .tolist()) for _ in range(n)]
    return pts, tracks


def _port_model(root: Path, binary: bool) -> Path:
    s = _scene()
    pts, tracks = _points()
    names = ["v0.png", "v1.jpg", "v2.png", "v3.jpg"]
    colmap.write_colmap_model(root / "sparse", s.intrinsics, s.extrinsics,
                              s.images.shape[1:3], pts, tracks, names,
                              binary=binary)
    images = root / "images"
    images.mkdir(parents=True, exist_ok=True)
    for i, name in enumerate(names):
        img = (s.images[i] * 255).astype(np.uint8)
        if name.endswith(".png"):
            write_png(images / name, img)
        else:  # not decoded by either converter: copied as it is
            (images / name).write_bytes(b"\xff\xd8\xff" + img.tobytes())
    return root


@pytest.fixture(scope="module", params=["test_colmap_text", "port_text",
                                        "port_binary"])
def model(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(request.param)
    if request.param == "test_colmap_text":
        return _write_colmap_text(root, make_plane_scene(
            num_views=3, height=48, width=64, z0=10.0))
    return _port_model(root, binary=request.param == "port_binary")


def test_read_colmap_model_matches_jax(model):
    got = colmap.read_colmap_model(model / "sparse")
    want = jax_colmap.read_colmap_model(model / "sparse")
    assert got[0].keys() == want[0].keys()
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k])
    assert got[1].keys() == want[1].keys()
    for k, w in want[1].items():
        g = got[1][k]
        assert (g.image_id, g.camera_id, g.name) == (w.image_id, w.camera_id,
                                                     w.name)
        for f in ("qvec", "tvec", "point3d_ids"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("max_d", [192, 0])
def test_convert_colmap_matches_jax(model, tmp_path, max_d):
    got_ranges, got_score = colmap.convert_colmap(model, tmp_path / "port",
                                                  max_d=max_d,
                                                  copy_images=False)
    want_ranges, want_score = jax_colmap.convert_colmap(
        model, tmp_path / "jax", max_d=max_d, copy_images=False)
    np.testing.assert_allclose(got_score, want_score, rtol=1e-12)
    assert [r[2] for r in got_ranges] == [r[2] for r in want_ranges]
    if max_d == 0:
        assert all(r[2] > 1 for r in got_ranges)
    cams = sorted((tmp_path / "jax" / "cams").iterdir())
    assert [p.name for p in cams] == sorted(
        p.name for p in (tmp_path / "port" / "cams").iterdir())
    for p in cams:
        g = read_cam_file(tmp_path / "port" / "cams" / p.name)
        w = read_cam_file(p)
        for f in ("intrinsics", "extrinsics", "depth_min", "depth_interval",
                  "depth_max"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                       rtol=1e-6, atol=1e-12, err_msg=f)
        assert g.num_depth == w.num_depth
    assert (tmp_path / "port" / "pair.txt").read_text() == \
        (tmp_path / "jax" / "pair.txt").read_text()


@pytest.mark.parametrize("binary", [False, True])
def test_written_model_converts_to_the_scene_cameras(tmp_path, binary):
    """write_colmap_model's qvec / tvec (and K) come back as the scene's
    cameras through convert_colmap."""
    root = _port_model(tmp_path / "m", binary)
    colmap.convert_colmap(root, tmp_path / "out", copy_images=False)
    s = _scene()
    for v in range(4):
        cam = read_cam_file(tmp_path / "out" / "cams" / f"{v:08d}_cam.txt")
        np.testing.assert_allclose(cam.extrinsics, s.extrinsics[v],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(cam.intrinsics, s.intrinsics[v],
                                   rtol=1e-7)
        assert cam.depth_min < 10.0 < cam.depth_max


def test_text_and_binary_models_convert_alike(tmp_path):
    out = {}
    for binary in (False, True):
        root = _port_model(tmp_path / f"m{binary}", binary)
        colmap.main(["--dense_folder", str(root), "--save_folder",
                     str(tmp_path / f"out{binary}"), "--max_d", "0"])
        out[binary] = {p.relative_to(tmp_path / f"out{binary}"): p.read_bytes()
                       for p in (tmp_path / f"out{binary}").rglob("*")
                       if p.is_file()}
    assert out[False] == out[True]
    # cams, pair.txt, two PNGs written and two JPEGs copied
    assert len(out[False]) == 4 + 1 + 4


def test_images_jpeg_copied_png_written(tmp_path):
    root = _port_model(tmp_path / "m", binary=False)
    colmap.convert_colmap(root, tmp_path / "out", max_d=32)
    images = tmp_path / "out" / "images"
    assert sorted(p.name for p in images.iterdir()) == [
        "00000000.png", "00000001.jpg", "00000002.png", "00000003.jpg"]
    assert (images / "00000001.jpg").read_bytes() == \
        (root / "images" / "v1.jpg").read_bytes()
    for i in (0, 2):
        np.testing.assert_array_equal(read_png(images / f"{i:08d}.png"),
                                      read_png(root / "images" / f"v{i}.png"))
    (root / "images" / "v0.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="only JPEG and PNG"):
        colmap.convert_colmap(root, tmp_path / "out2", max_d=32)


def test_module_runs_as_a_command(tmp_path):
    root = _port_model(tmp_path / "m", binary=True)
    out = subprocess.run(
        [sys.executable, "-m", "mvs_tpu_torch.io.colmap", "--dense_folder",
         str(root), "--save_folder", str(tmp_path / "out")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "wrote MVSNet inputs" in out.stdout
    pairs = read_pair_file(tmp_path / "out" / "pair.txt")
    assert len(pairs) == 4 and all(len(src) == 3 for _, src in pairs)


@pytest.mark.parametrize("dmin,dmax,n", [(425.0, 935.0, 192), (0.5, 40.0, 7),
                                         (2.0, 3.0, 2)])
def test_inverse_depth_values_match_jax(dmin, dmax, n):
    got = inverse_depth_values(dmin, dmax, n).numpy()
    want = np.asarray(jax_inverse(dmin, dmax, n, dtype=jnp.float32))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == pytest.approx(dmin, rel=1e-6)
    batched = inverse_depth_values(torch.tensor([dmin, dmin]),
                                   torch.tensor([dmax, dmax]), n)
    np.testing.assert_allclose(batched.numpy(), np.stack([got, got]),
                               rtol=1e-6)
