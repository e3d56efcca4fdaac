"""The port's consistency check and depth-map fusion against mvs_tpu's on
the CPU.

Inputs are seeded numpy: a tilted plane scene with multiplicative depth
noise (0.4%, so the 1% relative and 0.1-unit absolute thresholds pass some
pixels and fail others), random confidences, and pair lists with views
missing and views without sources. Round-trip depths and world points are
held to rtol 1e-5 (f32 rounding of 4x4 products in another order). A mask
may flip only where a test quantity lies within that rounding of its
threshold; allow 1e-3 of the pixels to disagree. Projected coordinates
are x / z: where a point lies nearly in a camera's focal plane, z's rounding
is amplified, so 1e-3 of them may miss rtol 1e-5 (all stay within 1e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_tpu.fusion import FusionConfig as JaxFusionConfig
from mvs_tpu.fusion import fuse_depth_maps as jax_fuse_depth_maps
from mvs_tpu.fusion import fuse_scene as jax_fuse_scene
from mvs_tpu.fusion import fuse_view as jax_fuse_view
from mvs_tpu.fusion import pad_pairs as jax_pad_pairs
from mvs_tpu.geometry.consistency import \
    geometric_consistency as jax_geometric_consistency
from mvs_tpu.geometry.consistency import \
    reproject_with_depth as jax_reproject_with_depth
from mvs_tpu.geometry.projection import invert_rigid as jax_invert_rigid
from mvs_tpu_torch.fusion import (FusionConfig, fuse_depth_maps, fuse_scene,
                                  fuse_view, pad_pairs)
from mvs_tpu_torch.geometry import (geometric_consistency, invert_rigid,
                                    reproject_with_depth)
from mvs_tpu_torch.utils.synthetic import make_plane_scene

MASK_SHARE = 1e-3
RTOL = 1e-5
PAIRS = [(0, [1, 2, 3, 4, 5]), (1, [0, 2]), (3, []), (4, [5, 0, 1]),
         (5, [4])]  # view 2 is absent, view 3 has no sources
MODES = [("relative", 0.01), ("absolute", 0.1)]


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def scene():
    sc = make_plane_scene(num_views=6, height=48, width=64, z0=10.0,
                          tilt=(0.05, 0.02))
    rng = np.random.default_rng(0)
    depths = (sc.depths * (1 + rng.normal(0, 0.004, sc.depths.shape))
              ).astype(np.float32)
    confs = rng.uniform(0, 1, depths.shape).astype(np.float32)
    return sc, depths, confs


def _rigid(rng, n):
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        out[i, :3, :3] = q * np.sign(np.linalg.det(q))
        out[i, :3, 3] = rng.normal(0, 2, 3)
    return out


def _assert_masks_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == bool
    assert (got != want).mean() <= MASK_SHARE, (got != want).sum()


def test_invert_rigid_matches_jax():
    e = _rigid(np.random.default_rng(1), 5).reshape(5, 1, 4, 4)
    got = invert_rigid(_t(e)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_invert_rigid(e)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got @ e, np.broadcast_to(np.eye(4), e.shape),
                               atol=1e-5)


def _awkward_pair():
    """A source camera 1.5 units before the plane, turned 50 degrees about
    y: part of the ref pixels land behind it and part off its image; the
    ref depth has zeros and negative values."""
    sc = make_plane_scene(num_views=2, height=40, width=56, z0=10.0,
                          tilt=(0.05, 0.02))
    ang = np.deg2rad(50.0)
    c, s = np.cos(ang), np.sin(ang)
    r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    extr = np.eye(4, dtype=np.float32)
    extr[:3, :3] = r
    extr[:3, 3] = -r @ np.array([0.0, 0.0, 8.5], np.float32)
    depth_ref = sc.depths[0].copy()
    depth_ref[:4] = 0.0
    depth_ref[-3:, :10] = -1.0
    depth_src = np.full_like(depth_ref, 2.0)
    return (depth_ref, sc.intrinsics[0], sc.extrinsics[0], depth_src,
            sc.intrinsics[1], extr)


def test_reproject_with_depth_matches_jax(scene):
    sc, depths, _ = scene
    cases = [(depths[0], sc.intrinsics[0], sc.extrinsics[0], depths[s],
              sc.intrinsics[s], sc.extrinsics[s]) for s in (1, 4)]
    cases.append(_awkward_pair())
    for args in cases:
        got = reproject_with_depth(*map(_t, args))
        want = jax_reproject_with_depth(*map(jnp.asarray, args))
        for g, w in zip(got, want):
            g, w = g.numpy(), np.asarray(w)
            assert g.shape == w.shape
            close = np.isclose(g, w, rtol=RTOL, atol=1e-4)
            assert close.mean() >= 1 - MASK_SHARE, (~close).sum()
            np.testing.assert_allclose(g, w, rtol=1e-2, atol=1e-4)


def test_awkward_pair_reaches_its_cases():
    d_ref, k_ref, e_ref, _, k_src, e_src = _awkward_pair()
    h, w = d_ref.shape
    ys, xs = np.mgrid[:h, :w]
    cam = np.linalg.inv(k_ref) @ np.stack([xs * d_ref, ys * d_ref, d_ref]
                                          ).reshape(3, -1)
    z_src = (e_src[:3, :3] @ cam + e_src[:3, 3:4])[2]
    assert (z_src < 0).mean() > 0.1 and (z_src > 0).mean() > 0.1
    got = reproject_with_depth(*map(_t, _awkward_pair())).coords_src.numpy()
    off = (got[..., 0] < 0) | (got[..., 0] > w - 1)
    assert 0.05 < off.mean() < 0.95


@pytest.mark.parametrize("mode,thresh", MODES)
def test_geometric_consistency_matches_jax(scene, mode, thresh):
    sc, depths, _ = scene
    cases = [(depths[0], sc.intrinsics[0], sc.extrinsics[0], depths[s],
              sc.intrinsics[s], sc.extrinsics[s]) for s in range(1, 6)]
    cases.append(_awkward_pair())
    for args in cases:
        mask, depth = geometric_consistency(*map(_t, args), pixel_thresh=1.0,
                                            depth_thresh=thresh,
                                            depth_mode=mode)
        jmask, jdepth = jax_geometric_consistency(
            *map(jnp.asarray, args), pixel_thresh=1.0, depth_thresh=thresh,
            depth_mode=mode)
        _assert_masks_close(mask.numpy(), jmask)
        both = mask.numpy() & np.asarray(jmask)
        np.testing.assert_allclose(depth.numpy()[both],
                                   np.asarray(jdepth)[both], rtol=RTOL)
    assert not mask.numpy()[:4].any()  # zero and negative ref depths


def test_geometric_consistency_batches_sources(scene):
    sc, depths, _ = scene
    srcs = [1, 3, 5]
    mask, depth = geometric_consistency(
        _t(depths[0]), _t(sc.intrinsics[0]), _t(sc.extrinsics[0]),
        _t(depths[srcs]), _t(sc.intrinsics[srcs]), _t(sc.extrinsics[srcs]))
    for i, s in enumerate(srcs):
        m, d = geometric_consistency(
            _t(depths[0]), _t(sc.intrinsics[0]), _t(sc.extrinsics[0]),
            _t(depths[s]), _t(sc.intrinsics[s]), _t(sc.extrinsics[s]))
        assert torch.equal(mask[i], m)
        torch.testing.assert_close(depth[i], d, rtol=1e-6, atol=1e-6)


def test_pad_pairs_matches_jax():
    for pairs in (PAIRS, [(0, []), (1, [])]):
        for got, want in zip(pad_pairs(pairs, 6), jax_pad_pairs(pairs, 6)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype


@pytest.mark.parametrize("mode,thresh", MODES)
def test_fuse_scene_matches_jax(scene, mode, thresh):
    sc, depths, confs = scene
    args = (depths, confs, sc.intrinsics, sc.extrinsics, PAIRS)
    mask, world = fuse_scene(*args, FusionConfig(0.3, 2, 1.0, thresh, mode),
                             device="cpu")
    jmask, jworld = jax_fuse_scene(*args,
                                   JaxFusionConfig(0.3, 2, 1.0, thresh, mode))
    assert world.shape == jworld.shape and world.dtype == np.float32
    _assert_masks_close(mask, jmask)
    assert 500 < mask.sum() < mask[[0, 1, 4, 5]].size // 2  # thresholds bite
    assert not mask[[2, 3]].any()  # absent view, view without sources
    both = mask & jmask
    np.testing.assert_allclose(world[both], jworld[both], rtol=RTOL,
                               atol=1e-5)


def test_fuse_depth_maps_matches_jax(scene):
    sc, depths, confs = scene
    args = (depths, confs, sc.images, sc.intrinsics, sc.extrinsics, PAIRS)
    xyz, rgb = fuse_depth_maps(*args, FusionConfig(0.3, 2), device="cpu")
    jxyz, jrgb = jax_fuse_depth_maps(*args, JaxFusionConfig(0.3, 2))
    scene_args = (depths, confs, sc.intrinsics, sc.extrinsics, PAIRS)
    mask, _ = fuse_scene(*scene_args, FusionConfig(0.3, 2), device="cpu")
    jmask, _ = jax_fuse_scene(*scene_args, JaxFusionConfig(0.3, 2))
    _assert_masks_close(mask, jmask)
    # Each cloud is its mask compacted over the refs with sources, in pair
    # order: pick the points of the common mask out of both.
    refs = [r for r, srcs in PAIRS if srcs]
    assert len(xyz) == mask[refs].sum() and len(jxyz) == jmask[refs].sum()
    keep = np.concatenate([jmask[r][mask[r]] for r in refs])
    jkeep = np.concatenate([mask[r][jmask[r]] for r in refs])
    np.testing.assert_allclose(xyz[keep], jxyz[jkeep], rtol=RTOL, atol=1e-5)
    np.testing.assert_array_equal(rgb[keep], jrgb[jkeep])
    none, _ = fuse_depth_maps(*args[:2], None, *args[3:],
                              FusionConfig(0.3, 2), device="cpu")
    assert len(none) == len(xyz)


def test_fuse_view_matches_jax(scene):
    sc, depths, confs = scene
    args = (0, [1, 2, 4], depths, confs, sc.intrinsics, sc.extrinsics)
    xyz, mask = fuse_view(*args, FusionConfig(0.3, 2), device="cpu")
    jxyz, jmask = jax_fuse_view(*args, JaxFusionConfig(0.3, 2))
    _assert_masks_close(mask, jmask)
    np.testing.assert_allclose(xyz[jmask[mask]], jxyz[mask[jmask]],
                               rtol=RTOL, atol=1e-5)


def test_fusion_config_rejects_unknown_mode():
    with pytest.raises(ValueError, match="depth_mode"):
        FusionConfig(depth_mode="disparity")


# The three behaviours of tests/test_fusion_eval.py, on the port.

def test_fuse_synthetic_scene_recovers_plane():
    scene = make_plane_scene(num_views=4, height=48, width=48, z0=10.0)
    xyz, rgb = fuse_depth_maps(
        scene.depths, np.ones_like(scene.depths), scene.images,
        scene.intrinsics, scene.extrinsics, [(0, [1, 2, 3]), (1, [0, 2, 3])],
        FusionConfig(conf_thresh=0.5, num_consistent=2), device="cpu")
    assert len(xyz) > 1000
    assert rgb is not None and rgb.shape == (len(xyz), 3)
    np.testing.assert_allclose(xyz[:, 2], 10.0, atol=0.05)


def test_fuse_rejects_inconsistent_view():
    scene = make_plane_scene(num_views=3, height=48, width=48, z0=10.0)
    depths = scene.depths.copy()
    depths[0] *= 1.2  # a corrupt ref view: nothing should survive
    xyz, _ = fuse_depth_maps(
        depths, np.ones_like(depths), None, scene.intrinsics,
        scene.extrinsics, [(0, [1, 2])],
        FusionConfig(conf_thresh=0.5, num_consistent=2), device="cpu")
    assert len(xyz) < 50


def test_fuse_respects_confidence():
    scene = make_plane_scene(num_views=3, height=48, width=48, z0=10.0)
    xyz, _ = fuse_depth_maps(
        scene.depths, np.zeros_like(scene.depths), None, scene.intrinsics,
        scene.extrinsics, [(0, [1, 2])],
        FusionConfig(conf_thresh=0.8, num_consistent=2), device="cpu")
    assert len(xyz) == 0


def test_fuse_scene_default_device_is_the_card(scene, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc, depths, confs = scene
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fuse_scene(depths, confs, sc.intrinsics, sc.extrinsics, PAIRS)


def _scan_layout(root, seeds):
    """cli.infer's layout (depth_est/, confidence/, cams/, pair.txt) for
    one noisy plane scan per seed, no images."""
    from mvs_tpu_torch.io.cams import CameraParams, write_cam_file
    from mvs_tpu_torch.io.pairs import write_pair_file
    from mvs_tpu_torch.io.pfm import write_pfm

    jobs = []
    for i, seed in enumerate(seeds):
        sc = make_plane_scene(num_views=4, height=32, width=40, z0=10.0,
                              seed=seed, tilt=(0.05, 0.02))
        rng = np.random.default_rng(seed)
        scan = root / f"scan{i + 1}"
        for v in range(4):
            noisy = sc.depths[v] * (1 + rng.normal(0, 0.004, (32, 40)))
            write_pfm(scan / "depth_est" / f"{v:08d}.pfm",
                      noisy.astype(np.float32))
            write_pfm(scan / "confidence" / f"{v:08d}.pfm",
                      rng.uniform(0.3, 1, (32, 40)).astype(np.float32))
            write_cam_file(scan / "cams" / f"{v:08d}_cam.txt", CameraParams(
                sc.intrinsics[v], sc.extrinsics[v], 8.0, 0.1))
        write_pair_file(scan / "pair.txt",
                        [(r, [(s, 1.0) for s in range(4) if s != r])
                         for r in range(4)])
        jobs.append((scan, scan / "pair.txt"))
    return jobs


def test_fuse_scans_over_two_devices_equals_serial(tmp_path, monkeypatch):
    """Scan-parallel fusion (scan i on device i mod 2, a stream per device)
    writes the serial path's clouds, and a device loads a scan only when
    its stream reaches it: at most two scans per device are loaded and not
    yet written."""
    from mvs_tpu_torch.cli import fuse as cli_fuse
    from mvs_tpu_torch.io.ply import read_ply

    jobs = _scan_layout(tmp_path, [0, 1, 2, 3, 4])
    fcfg = FusionConfig(0.5, 2, 1.0, 0.01)
    serial = [read_ply(p)["xyz"] for p in cli_fuse.fuse_scans(
        jobs, fcfg, devices="cpu")]
    for (scan, _), xyz in zip(jobs, serial):
        (scan / "fused.ply").rename(scan / "serial.ply")
        assert len(xyz) > 100

    load, write = cli_fuse.load_scan_arrays, cli_fuse.write_scan_cloud
    held, most = set(), [0]

    def counted_load(*a):
        scan = load(*a)
        held.add(scan["name"])
        most[0] = max(most[0], len(held))
        return scan

    def counted_write(scan, *a):
        out = write(scan, *a)
        held.discard(scan["name"])
        return out

    monkeypatch.setattr(cli_fuse, "load_scan_arrays", counted_load)
    monkeypatch.setattr(cli_fuse, "write_scan_cloud", counted_write)
    paths = cli_fuse.fuse_scans(jobs, fcfg, devices=["cpu", "cpu"])
    assert [p.parent for p in paths] == [scan for scan, _ in jobs]
    for p, xyz in zip(paths, serial):
        np.testing.assert_array_equal(read_ply(p)["xyz"], xyz)
    assert 2 <= most[0] <= 4, most[0]
