"""The port's I/O against mvs_tpu's and against PIL / cv2 on the CPU:
the PNG codec, the bilinear resize, the pair / PLY codecs, the config
loader, the DTU eval reader and the synthetic DTU generator.

The resize is held to cv2 at 4e-4 on images of random values in [0, 1]:
torch computes each source coordinate in f32, cv2 in f64, and at
x ~ 1600 three f32 roundings move it by up to 3 * 2^-24 * 2048 = 3.7e-4
pixel, so a value moves by up to that times the largest neighbour
difference (1 here). Smooth images move far less.
"""

import struct
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from mvs_tpu.io import read_pair_file as jax_read_pair_file
from mvs_tpu.io import read_ply as jax_read_ply
from mvs_tpu.io import write_pair_file as jax_write_pair_file
from mvs_tpu.io import write_ply as jax_write_ply
from mvs_tpu.io.dtu import DTUEvalDataset as JaxDTUEvalDataset
from mvs_tpu.io.dtu import _scale_to_fit as jax_scale_to_fit
from mvs_tpu.io.dtu import read_image as jax_read_image
from mvs_tpu.utils.config import config_to_dict as jax_config_to_dict
from mvs_tpu.utils.config import load_config as jax_load_config
from mvs_tpu.utils.make_synthetic_dtu import generate as jax_generate
from mvs_tpu_torch.io import (read_pair_file, read_ply, read_png,
                              write_pair_file, write_ply, write_png)
from mvs_tpu_torch.io.dtu import (DTUEvalDataset, _scale_to_fit, read_image,
                                  resize_bilinear)
from mvs_tpu_torch.io.pfm import read_pfm
from mvs_tpu_torch.utils.config import config_to_dict, load_config
from mvs_tpu_torch.utils.make_synthetic_dtu import generate

RESIZE_TOL = 4e-4
CHANNELS = {1: 0, 2: 4, 3: 2, 4: 6}


def _image(shape, seed=0, smooth=False):
    if not smooth:
        return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    y, x = np.mgrid[:shape[0], :shape[1]]
    planes = [(x * (c + 1) + y * (3 - c) + 7 * c) % 256
              for c in range(shape[2] if len(shape) == 3 else 1)]
    return np.stack(planes, -1).reshape(shape).astype(np.uint8)


def _png_bytes(img, filters, interlace=0):
    """A reference PNG encoder: row y uses filters[y % len(filters)]."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    bpp, raw = c, img.reshape(h, w * c).astype(np.int64)
    out, prev = [], np.zeros(w * c, np.int64)
    for y in range(h):
        f, row = filters[y % len(filters)], raw[y]
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            enc = row
        elif f == 1:
            enc = row - left
        elif f == 2:
            enc = row - prev
        elif f == 3:
            enc = row - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
            enc = row - pred
        out.append(bytes([f]) + (enc % 256).astype(np.uint8).tobytes())
        prev = row

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, CHANNELS[c], 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(17, 23), (17, 23, 1), (5, 9, 2),
                                   (17, 23, 3), (6, 4, 4)])
def test_png_round_trip(tmp_path, shape):
    img = _image(shape)
    write_png(tmp_path / "a.png", img)
    got = read_png(tmp_path / "a.png")
    np.testing.assert_array_equal(got, img.reshape(got.shape))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")),
                                  got)


@pytest.mark.parametrize("mode,shape", [("L", (31, 45)), ("RGB", (31, 45, 3)),
                                        ("RGBA", (20, 33, 4))])
@pytest.mark.parametrize("smooth", [False, True])
def test_png_decodes_pil_written(tmp_path, mode, shape, smooth):
    Image.fromarray(_image(shape, smooth=smooth), mode).save(tmp_path / "p.png")
    np.testing.assert_array_equal(read_png(tmp_path / "p.png"),
                                  np.asarray(Image.open(tmp_path / "p.png")))


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [4, 3, 2, 1, 0]])
@pytest.mark.parametrize("shape", [(9, 13), (9, 13, 3), (7, 5, 4)])
def test_png_decodes_every_filter(tmp_path, filters, shape):
    img = _image(shape, seed=len(filters))
    (tmp_path / "f.png").write_bytes(_png_bytes(img, filters))
    got = read_png(tmp_path / "f.png")
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "f.png")),
                                  got)


def test_png_rejects_what_it_does_not_support(tmp_path):
    Image.fromarray(_image((8, 8, 3))).convert("P").save(tmp_path / "p.png")
    Image.fromarray(_image((8, 8)).astype(np.uint16) * 257).save(
        tmp_path / "d.png")
    (tmp_path / "i.png").write_bytes(_png_bytes(_image((8, 8)), [0],
                                                interlace=1))
    (tmp_path / "j.png").write_bytes(b"\xff\xd8\xff" + bytes(20))
    for name, match in (("p.png", "colour type 3"), ("d.png", "bit depth 16"),
                        ("i.png", "interlaced"), ("j.png", "not a PNG")):
        with pytest.raises(ValueError, match=match):
            read_png(tmp_path / name)
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 5), np.uint8)):
        with pytest.raises(ValueError):
            write_png(tmp_path / "x.png", bad)


@pytest.mark.parametrize("src,dst", [((1200, 1600), (864, 1152)),
                                     ((1200, 1600), (224, 320)),
                                     ((37, 53), (16, 20)),
                                     ((40, 60), (80, 100)),
                                     ((64, 96), (64, 96))])
@pytest.mark.parametrize("channels", [0, 3])
def test_resize_matches_cv2(src, dst, channels):
    shape = src + ((channels,) if channels else ())
    img = np.random.default_rng(0).random(shape, dtype=np.float32)
    got = resize_bilinear(img, *dst)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=RESIZE_TOL, rtol=0)


@pytest.mark.parametrize("size,fit", [((1200, 1600), (864, 1152, 32)),
                                      ((1200, 1600), (256, 320, 32)),
                                      ((48, 64), (40, 56, 8))])
def test_scale_to_fit_matches_jax(size, fit):
    y, x = np.mgrid[:size[0], :size[1]]
    img = np.stack([np.sin(x / 30.0), np.cos(y / 20.0), (x + y) / 3000.0],
                   -1).astype(np.float32)
    k = np.array([[1000.0, 0, 800], [0, 1000, 600], [0, 0, 1]], np.float32)
    got_img, got_k = _scale_to_fit(img, k, *fit)
    want_img, want_k = jax_scale_to_fit(img, k, *fit)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_allclose(got_img, want_img, atol=2e-5, rtol=0)


def test_read_image_matches_jax(tmp_path):
    rgb = _image((24, 40, 3), smooth=True)
    Image.fromarray(rgb).save(tmp_path / "a.jpg", quality=90)
    write_png(tmp_path / "b.png", rgb)
    write_png(tmp_path / "c.png", rgb[..., 0])
    write_png(tmp_path / "d.png", np.dstack([rgb, rgb[..., :1]]))
    for name in ("a.jpg", "b.png", "c.png", "d.png"):
        got = read_image(tmp_path / name)
        assert got.shape == (24, 40, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_read_image(tmp_path / name))


def test_read_jpeg_without_a_decoder_says_so(tmp_path, monkeypatch):
    Image.fromarray(_image((8, 8, 3))).save(tmp_path / "a.jpg")
    write_png(tmp_path / "b.png", _image((8, 8, 3)))
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="needs cv2 or PIL"):
        read_image(tmp_path / "a.jpg")
    assert read_image(tmp_path / "b.png").shape == (8, 8, 3)


def test_pair_codec_matches_jax(tmp_path):
    pairs = [(r, [(v, float(10 - abs(v - r)) / 3) for v in range(6) if v != r])
             for r in range(6)]
    write_pair_file(tmp_path / "a.txt", pairs)
    jax_write_pair_file(tmp_path / "b.txt", pairs)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
    assert read_pair_file(tmp_path / "a.txt") == jax_read_pair_file(
        tmp_path / "a.txt")


@pytest.mark.parametrize("with_rgb,with_normals", [(False, False),
                                                   (True, False),
                                                   (True, True)])
def test_ply_codec_matches_jax(tmp_path, with_rgb, with_normals):
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(50, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (50, 3), np.uint8) if with_rgb else None
    normals = rng.normal(size=(50, 3)) if with_normals else None
    write_ply(tmp_path / "a.ply", xyz, rgb, normals)
    jax_write_ply(tmp_path / "b.ply", xyz, rgb, normals)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    got, want = read_ply(tmp_path / "a.ply"), jax_read_ply(tmp_path / "a.ply")
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("yaml_path", [None, "configs/cas_eval_dtu.yaml"])
def test_load_config_matches_jax(yaml_path):
    overrides = ["model.ndepths=8,8,8", "data.batch_size=3",
                 "model.compute_dtype=bfloat16", "fusion.depth_thresh=0.05",
                 "train.grad_clip=1.5", "model.refine=true",
                 "data.eval_root=/x/y"]
    path = yaml_path and str(Path(__file__).resolve().parents[1] / yaml_path)
    assert config_to_dict(load_config(path, overrides)) == \
        jax_config_to_dict(jax_load_config(path, overrides))
    with pytest.raises(KeyError, match="unknown config key"):
        load_config(None, ["model.nope=1"])
    with pytest.warns(DeprecationWarning):
        assert load_config(None, ["train.bf16=1"]).model.compute_dtype == \
            "bfloat16"


@pytest.fixture(scope="module")
def jax_fixture(tmp_path_factory):
    """mvs_tpu's generator: eval images as JPEG, 2 scans x 5 views."""
    return jax_generate(tmp_path_factory.mktemp("jaxdtu"), num_scans=2,
                        num_views=5, height=32, width=64, num_depth=16,
                        tilt=(0.05, 0.02))


@pytest.mark.parametrize("fit,tol", [((32, 64, 32), 0.0), ((24, 48, 8), 2e-5)])
def test_dtu_eval_dataset_matches_jax(jax_fixture, fit, tol):
    kw = dict(num_views=3, num_depth=16, interval_scale=1.06, max_h=fit[0],
              max_w=fit[1], align=fit[2])
    got = DTUEvalDataset(jax_fixture, ["scan1", "scan2"], **kw)
    want = JaxDTUEvalDataset(jax_fixture, ["scan1", "scan2"], **kw)
    assert got.metas == want.metas and len(got) == 10
    for i in (0, 7):
        g, w = got[i], want[i]
        assert g.keys() == w.keys()
        assert g["imgs"].shape == (3, fit[0], fit[1], 3)
        np.testing.assert_allclose(g["imgs"], w["imgs"], atol=tol, rtol=0)
        for key in g:
            if key != "imgs":
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
                assert np.asarray(g[key]).dtype == np.asarray(w[key]).dtype


def test_make_synthetic_dtu_matches_jax(jax_fixture, tmp_path):
    root = generate(tmp_path, num_scans=2, num_views=5, height=32, width=64,
                    num_depth=16, tilt=(0.05, 0.02))
    for rel in ("scan1/cams/00000003_cam.txt", "scan2/pair.txt",
                "Cameras/00000001_cam.txt", "Cameras/pair.txt",
                "lists/train.txt", "lists/val.txt", "lists/test.txt"):
        assert (root / rel).read_text() == (jax_fixture / rel).read_text(), rel
    for rel in ("Points/stl/stl002_total.ply",
                "Depths/scan1_train/depth_map_0002.pfm"):
        assert (root / rel).read_bytes() == (jax_fixture / rel).read_bytes(), \
            rel
    for rel in ("Rectified/scan2_train/rect_004_1_r5000.png",
                "Depths/scan2_train/depth_visual_0001.png"):
        np.testing.assert_array_equal(read_png(root / rel),
                                      np.asarray(Image.open(jax_fixture
                                                            / rel)))
    # Eval images: PNG here, JPEG in mvs_tpu, from the same pixels.
    np.testing.assert_array_equal(
        read_png(root / "scan1/images/00000002.png"),
        read_png(root / "Rectified/scan1_train/rect_003_0_r5000.png"))
    depth, _ = read_pfm(root / "Depths/scan1_train/depth_map_0000.pfm")
    assert depth.shape == (8, 16)
