"""Parity of the port's geometry (mvs_tpu_torch.geometry) with mvs_tpu's on
the CPU: the same numpy inputs through both, f32, atol 1e-5 unless stated
(f32 rounding of coordinates of a few hundred pixels)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_tpu import geometry as jg
from mvs_tpu_torch import geometry as tg
from mvs_tpu_torch.utils.synthetic import make_plane_scene


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _rel(num_views=3, height=24, width=32, seed=0):
    scene = make_plane_scene(num_views=num_views, height=height, width=width,
                             seed=seed)
    proj = scene.projections.astype(np.float32)
    rel = np.stack([np.asarray(jg.relative_projection(jnp.asarray(proj[v]),
                                                      jnp.asarray(proj[0])))
                    for v in range(1, num_views)])
    return scene, proj, rel


def test_relative_projection_and_compose():
    scene, proj, rel = _rel()
    k = scene.intrinsics
    want_proj = np.asarray(jg.compose_projection(
        jg.scale_intrinsics(jnp.asarray(k), 0.5), jnp.asarray(scene.extrinsics)))
    got_proj = tg.compose_projection(tg.scale_intrinsics(_t(k), 0.5),
                                     _t(scene.extrinsics))
    np.testing.assert_allclose(got_proj.numpy(), want_proj, rtol=1e-6,
                               atol=1e-5)
    got_rel = tg.relative_projection(_t(proj[1:]), _t(proj[0])[None])
    np.testing.assert_allclose(got_rel.numpy(), rel, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("per_pixel", [False, True])
def test_plane_sweep_coords(per_pixel):
    _, _, rel = _rel()
    rng = np.random.default_rng(1)
    if per_pixel:
        depth = rng.uniform(7.0, 13.0, (5, 24, 32)).astype(np.float32)
    else:
        depth = np.linspace(7.0, 13.0, 5).astype(np.float32)
    want = np.asarray(jg.plane_sweep_coords(jnp.asarray(rel[0]),
                                            jnp.asarray(depth), 24, 32))
    got = tg.plane_sweep_coords(_t(rel[0]), _t(depth), 24, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    # The batched form equals the per-item calls.
    got_b = tg.plane_sweep_coords(_t(rel), _t(np.stack([depth, depth])), 24,
                                  32)
    np.testing.assert_allclose(got_b[1].numpy(), tg.plane_sweep_coords(
        _t(rel[1]), _t(depth), 24, 32).numpy(), atol=0)


def test_behind_camera_points_go_far_out():
    rel = np.eye(4, dtype=np.float32)
    rel[2, 3] = -20.0  # z = d - 20 <= 1e-3 for every depth below 20
    depth = np.array([5.0, 19.0, 25.0], np.float32)
    want = np.asarray(jg.plane_sweep_coords(jnp.asarray(rel),
                                            jnp.asarray(depth), 6, 8))
    got = tg.plane_sweep_coords(_t(rel), _t(depth), 6, 8).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (got[:2, ..., 0] == -16.0).all() and (got[:2, ..., 1] == -12.0).all()


@pytest.mark.parametrize("case", ["inside", "half_out", "behind"])
def test_bilinear_sample(case):
    rng = np.random.default_rng(2)
    feat = rng.standard_normal((2, 10, 12, 5)).astype(np.float32)
    coords = rng.uniform(0.0, 11.0, (2, 7, 9, 2)).astype(np.float32)
    if case == "half_out":
        # Straddle every border: some corners in, some out.
        coords[..., 0] = rng.uniform(-1.5, 12.5, coords.shape[:-1])
        coords[..., 1] = rng.uniform(-1.5, 10.5, coords.shape[:-1])
    elif case == "behind":
        coords[:, :3] = np.array([-24.0, -20.0], np.float32)
    want = np.stack([np.asarray(jg.bilinear_sample(jnp.asarray(feat[i]),
                                                   jnp.asarray(coords[i])))
                     for i in range(2)])
    got = tg.bilinear_sample(_t(feat), _t(coords)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if case == "behind":
        assert (got[:, :3] == 0).all()


@pytest.mark.parametrize("windowed", [False, True])
def test_cascade_depth_samples(windowed):
    rng = np.random.default_rng(3)
    interval = rng.uniform(0.01, 0.05, 2).astype(np.float32)
    if windowed:
        cur = rng.uniform(8.0, 12.0, (2, 6, 7)).astype(np.float32)
    else:
        cur = np.stack([np.linspace(8.0, 12.0, 192),
                        np.linspace(7.0, 11.0, 192)]).astype(np.float32)
    want = np.asarray(jax.vmap(
        lambda c, i: jg.cascade_depth_samples(c, 8, i, 6, 7))(
            jnp.asarray(cur), jnp.asarray(interval)))
    got = tg.cascade_depth_samples(_t(cur), 8, _t(interval), 6, 7).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
