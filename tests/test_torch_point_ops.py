"""Point-MVSNet's point operations in the port against mvs_tpu's on the
CPU: the pixel grid, the feature fetch, the lattice kNN and the neighbour
gather, and the route that puts the model's variance volumes on the
warp-variance kernel (ops.point_ops.point_sweep_projections, whose plain
version runs here).

kNN: the index arrays are equal, order included (exact integers), on
random lattices, on lattices near the origin (the zero padding wins window
slots and the clamp to [0, N-1] shows) and on integer lattices full of
exact ties. The gather and its gradient (a scatter-add) are exact sums of
the same f32 values: rtol 1e-6.

Kernel route: the plain warp-variance volume over the shifted projections
against mvs_tpu's fetch-then-variance (the reference view put in
directly), for the coarse ladder and for per-pixel flow hypotheses; both
compute the sampling coordinates in f32 by other orders of operations
(composed projections against unproject-then-project), which moves a
sample by up to ~1e-5 px, so the volumes agree within 2e-4 of their
largest magnitude. The behind-camera delta: the kernel route drops a
sample whose source z <= 1e-3, mvs_tpu samples its mirrored projection.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mvs_tpu.ops import point_ops as jax_ops
from mvs_tpu.utils.synthetic import make_plane_scene
from mvs_tpu_torch.geometry.projection import scale_intrinsics
from mvs_tpu_torch.ops import point_ops
from mvs_tpu_torch.ops.warp_variance import fused_variance_volume

VOLUME_TOL = 2e-4


@pytest.mark.parametrize("height,width", [(5, 7), (4, 5), (60, 80)])
def test_point_pixel_grid_matches_jax(height, width):
    """The exact pixel centres; mvs_tpu's f32 jnp.linspace misses some by
    up to 2^-22 of their value (its 4-point 0.5..3.5 has 2.5000002)."""
    got = point_ops.point_pixel_grid(height, width).numpy()
    want = np.asarray(jax_ops.point_pixel_grid(height, width))
    np.testing.assert_allclose(got, want, rtol=2.0 ** -22, atol=0)
    ys, xs = np.mgrid[:height, :width] + 0.5
    np.testing.assert_array_equal(got[:2], np.stack([xs, ys]).reshape(2, -1))


def test_fetch_point_features_matches_jax():
    rng = np.random.default_rng(0)
    scene = make_plane_scene(num_views=3, height=24, width=32, z0=10.0,
                             tilt=(0.05, 0.02))
    feats = rng.standard_normal((3, 24, 32, 5)).astype(np.float32)
    pts = np.concatenate([rng.uniform(-6, 6, (2, 300)),
                          rng.uniform(-3, 14, (1, 300))]).astype(np.float32)
    want = jax_ops.fetch_point_features(
        jnp.asarray(feats), jnp.asarray(pts), jnp.asarray(scene.intrinsics),
        jnp.asarray(scene.extrinsics))
    got = point_ops.fetch_point_features(
        torch.tensor(feats), torch.tensor(pts),
        torch.tensor(scene.intrinsics), torch.tensor(scene.extrinsics))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _knn_both(xyz, kernel_size, k):
    want = np.asarray(jax_ops.lattice_knn(jnp.asarray(xyz), kernel_size, k))
    got = point_ops.lattice_knn(torch.tensor(xyz), kernel_size, k).numpy()
    return got, want


@pytest.mark.parametrize("shape,kernel_size,k", [
    ((3, 5, 6, 7), 5, 16), ((3, 4, 5, 6), 3, 8), ((3, 5, 3, 4), 5, 125)])
def test_lattice_knn_matches_jax(shape, kernel_size, k):
    xyz = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got, want = _knn_both(xyz, kernel_size, k)
    assert got.shape == want.shape == (np.prod(shape[1:]), k)
    np.testing.assert_array_equal(got, want)


def test_lattice_knn_near_the_origin():
    """Points within 0.05 of the origin: the zero padding outside the
    lattice is nearer than most neighbours, so padded slots win, and their
    flat indices (base + offset) are clamped to [0, N-1]."""
    xyz = (np.random.default_rng(2).standard_normal((3, 5, 4, 4)) * 0.05
           ).astype(np.float32)
    got, want = _knn_both(xyz, 5, 16)
    np.testing.assert_array_equal(got, want)
    n = 5 * 4 * 4
    assert (got == 0).sum() > n and (got == n - 1).sum() > 1  # clamped


def test_lattice_knn_breaks_ties_to_the_lower_slot():
    """An integer lattice: every shell of neighbours is an exact tie."""
    xyz = np.stack(np.meshgrid(np.arange(5), np.arange(4), np.arange(6),
                               indexing="ij")).astype(np.float32)
    got, want = _knn_both(xyz, 5, 16)
    np.testing.assert_array_equal(got, want)
    # The centre's first neighbours: itself, then the 6 at distance 1 in
    # window-slot order (-hw, -w, -1, +1, +w, +hw).
    centre = (2 * 4 + 2) * 6 + 3
    assert list(got[centre, :7]) == [centre + o for o in
                                     (0, -24, -6, -1, 1, 6, 24)]


def test_lattice_knn_batched():
    xyz = np.random.default_rng(3).standard_normal(
        (2, 3, 5, 4, 5)).astype(np.float32)
    got = point_ops.lattice_knn(torch.tensor(xyz), 5, 16).numpy()
    for i in range(2):
        np.testing.assert_array_equal(
            got[i], np.asarray(jax_ops.lattice_knn(jnp.asarray(xyz[i]), 5,
                                                   16)))


def test_gather_neighbors_and_gradient_match_jax():
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, 30, 6)).astype(np.float32)
    idx = rng.integers(0, 30, (2, 30, 4))
    w = rng.standard_normal((2, 30, 4, 6)).astype(np.float32)
    gather = jax.vmap(jax_ops.gather_neighbors)
    want = gather(jnp.asarray(feats), jnp.asarray(idx))
    want_grad = jax.grad(lambda f: jnp.sum(gather(f, jnp.asarray(idx)) * w))(
        jnp.asarray(feats))
    f = torch.tensor(feats, requires_grad=True)
    got = point_ops.gather_neighbors(f, torch.tensor(idx))
    (got * torch.tensor(w)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-6, atol=1e-6)


def _jax_volume(feats, intrinsics, extrinsics, depths, height, width,
                ref_direct=True):
    """mvs_tpu's coarse volume and flow features, written as the model
    writes them: unproject the reference lattice at depths (D, N), fetch
    every view, the reference view's own features put in directly, the
    variance over views -> (D, H, W, C)."""
    from mvs_tpu.geometry.projection import invert_rigid
    from mvs_tpu.models.point_mvsnet import _unproject_ref_lattice

    d, n = depths.shape
    c = feats.shape[-1]
    world = _unproject_ref_lattice(
        jnp.linalg.inv(intrinsics[0]), invert_rigid(extrinsics[0]),
        jnp.asarray(depths), height, width)
    pf = jax_ops.fetch_point_features(feats, world, intrinsics, extrinsics)
    if ref_direct:
        pf = pf.at[0].set(jnp.broadcast_to(feats[0].reshape(1, n, c),
                                           (d, n, c)).reshape(d * n, c))
    mean = jnp.mean(pf, axis=0)
    return np.asarray(jnp.mean(pf * pf, axis=0) - mean * mean).reshape(
        d, height, width, c)


def _port_volume(feats, intrinsics, extrinsics, hyp, scale):
    rel = point_ops.point_sweep_projections(
        torch.tensor(intrinsics)[None], torch.tensor(extrinsics)[None], scale)
    f = torch.tensor(feats)[None]
    return fused_variance_volume(f[:, 0].contiguous(), f[:, 1:].contiguous(),
                                 rel, torch.tensor(hyp)[None])[0].numpy()


def _check_volume(got, want):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=VOLUME_TOL * scale)


def test_coarse_volume_route_matches_fetch():
    """The coarse stage at 1/8 of 96x128 images: a 12-hypothesis ladder,
    C = 16, 4 views."""
    scene = make_plane_scene(num_views=4, height=96, width=128, z0=10.0,
                             tilt=(0.05, 0.02))
    h, w = 12, 16
    feats = np.random.default_rng(5).standard_normal(
        (4, h, w, 16)).astype(np.float32)
    ladder = (8.0 + np.arange(12) * (4.0 / 11)).astype(np.float32)
    k = np.asarray(scale_intrinsics(torch.tensor(scene.intrinsics), 1 / 8))
    want = _jax_volume(jnp.asarray(feats), jnp.asarray(k),
                       jnp.asarray(scene.extrinsics),
                       np.repeat(ladder[:, None], h * w, axis=1), h, w)
    hyp = np.broadcast_to(ladder[:, None, None], (12, h, w)).copy()
    _check_volume(_port_volume(feats, scene.intrinsics, scene.extrinsics,
                               hyp, 1 / 8), want)


def test_flow_features_route_matches_fetch():
    """A flow iteration at 1/4 of 64x80 images: 5 hypotheses per pixel
    around a tilted depth map (spacing 0.2), C = 8, 3 views."""
    scene = make_plane_scene(num_views=3, height=64, width=80, z0=10.0,
                             tilt=(0.05, 0.02))
    h, w = 16, 20
    feats = np.random.default_rng(6).standard_normal(
        (3, h, w, 8)).astype(np.float32)
    depth = scene.depths[0][2::4, 2::4]
    hyp = (depth[None] + np.arange(-2, 3)[:, None, None] * np.float32(0.2)
           ).astype(np.float32)
    k = np.asarray(scale_intrinsics(torch.tensor(scene.intrinsics), 0.25))
    want = _jax_volume(jnp.asarray(feats), jnp.asarray(k),
                       jnp.asarray(scene.extrinsics), hyp.reshape(5, -1),
                       h, w)
    _check_volume(_port_volume(feats, scene.intrinsics, scene.extrinsics,
                               hyp, 0.25), want)


def test_behind_camera_delta():
    """A source camera 5 units ahead of the reference on its axis sees the
    points at depth < 5 behind it. mvs_tpu's fetch divides by z with its
    sign and samples the mirrored projection (a nonzero feature there); the
    kernel route drops the sample, so its volume at such a point is the
    variance with that view's feature 0. In front of both cameras the two
    agree."""
    h, w, c = 8, 10, 4
    k = np.array([[10.0, 0, 5.0], [0, 10.0, 4.0], [0, 0, 1]], np.float32)
    intr = np.stack([k, k])
    extr = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
    extr[1, 2, 3] = -5.0  # source at z = +5 in the reference frame
    feats = np.random.default_rng(7).uniform(0.5, 1.5, (2, h, w, c)).astype(
        np.float32)
    ladder = np.array([2.0, 3.0, 10.0, 20.0], np.float32)
    want = _jax_volume(jnp.asarray(feats), jnp.asarray(intr),
                       jnp.asarray(extr),
                       np.repeat(ladder[:, None], h * w, axis=1), h, w)
    got = _port_volume(feats, intr, extr, np.broadcast_to(
        ladder[:, None, None], (4, h, w)).copy(), 1.0)
    behind, ahead = slice(0, 2), slice(2, 4)
    _check_volume(got[ahead], want[ahead])
    ref = feats[0]
    dropped = ref * ref / 2 - (ref / 2) ** 2  # variance of (ref, 0)
    np.testing.assert_allclose(got[behind], np.broadcast_to(
        dropped, (2, h, w, c)), rtol=1e-6)
    # mvs_tpu sampled something else there: the mirrored projection.
    assert np.abs(want[behind] - got[behind]).max() > 0.05


def _min_source_z(intrinsics, extrinsics, height, width, depths):
    """The least z of every hypothesis in every source camera: pixels of
    the 0.5-centred lattice at depths (D,) in the reference frame."""
    grid = point_ops.point_pixel_grid(height, width).double().numpy()
    rays = np.linalg.inv(intrinsics[0].astype(np.float64)) @ grid
    world = np.linalg.inv(extrinsics[0].astype(np.float64))
    pts = world[:3, :3] @ (rays[:, None] * depths[None, :, None]).reshape(
        3, -1) + world[:3, 3:]
    src = extrinsics[1:].astype(np.float64)
    return float((src[:, 2, :3] @ pts + src[:, 2, 3:]).min())


def test_no_hypothesis_of_the_fixtures_lies_behind_a_source_camera():
    """The parity tests here, in tests/test_torch_point_mvsnet.py and
    tests/test_torch_point_train.py, and chip_smoke.py's phase 11 rigs
    stay clear of the delta above: every hypothesis a flow iteration can
    reach (the ladder widened by 2.25 intervals, the flows' reach), at the
    finest flow lattice's pixels, is in front of every source camera by
    far more than 1e-3."""
    tilted = dict(z0=10.0, tilt=(0.05, 0.02))
    rigs = [dict(scene=dict(num_views=4, height=96, width=128, **tilted),
                 depths=(7.0, 13.0)),
            dict(scene=dict(num_views=3, height=64, width=80, **tilted),
                 depths=(7.0, 13.0))] + chip_smoke.point_rigs()
    for rig in rigs:
        scene = make_plane_scene(**rig["scene"])
        h, w = scene.images.shape[1] // 2, scene.images.shape[2] // 2
        k = np.asarray(scale_intrinsics(torch.tensor(scene.intrinsics), 0.5))
        assert _min_source_z(k, scene.extrinsics, h, w,
                             np.linspace(*rig["depths"], 9)) > 1.0, rig
