"""Parity of the port's warp-variance volume with mvs_tpu's on the CPU.

On CPU tensors ``fused_variance_volume`` runs its plain version (the exact
gather path); the CUDA kernel is held against that plain version on the card
by chip_smoke.py. Here the plain version is held against
  * mvs_tpu's variance_cost_volume(sampler='gather'), to f32 rounding
    (coordinates of ~100 px carry ~1e-5 px of rounding; atol 1e-4), and
  * the Pallas kernel fused_variance_volume_pallas in interpret mode, at the
    bounds tests/test_warp_pallas.py pins it to (mean error < 2e-3 / 3e-3:
    the Pallas kernel's banded hat warp is approximate, the port is exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_tpu.geometry import relative_projection, uniform_depth_values
from mvs_tpu.ops.cost_volume import variance_cost_volume
from mvs_tpu.ops.warp_pallas import fused_variance_volume_pallas
from mvs_tpu.utils.synthetic import make_plane_scene, make_step_scene
from mvs_tpu_torch.ops import cost_volume as tcv
from mvs_tpu_torch.ops.warp_variance import fused_variance_volume


def _inputs(scene, nsrc):
    proj = jnp.asarray(scene.projections)
    rels = jnp.stack([relative_projection(proj[v], proj[0])
                      for v in range(1, nsrc + 1)])
    return np.asarray(scene.images), np.asarray(rels)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("per_pixel", [False, True])
def test_matches_jax_gather_batched(per_pixel):
    rng = np.random.default_rng(0)
    feats, rels, hyps = [], [], []
    for seed in (0, 1):
        scene = make_plane_scene(num_views=4, height=24, width=40, z0=10.0,
                                 seed=seed, tilt=(0.1, 0.05))
        f, r = _inputs(scene, 3)
        # Six channels: the image and a random mix of it (sharper features).
        mix = rng.standard_normal((3, 3)).astype(np.float32)
        feats.append(np.concatenate([f, f @ mix], axis=-1))
        rels.append(r)
        if per_pixel:
            base = scene.depths[0]
            hyps.append(np.stack([base + o for o in (-0.4, -0.1, 0.2, 0.5)]))
        else:
            hyps.append(np.asarray(uniform_depth_values(8.0, 0.5, 8)))
    feats, rels, hyps = np.stack(feats), np.stack(rels), np.stack(hyps)
    want = np.stack([np.asarray(variance_cost_volume(
        jnp.asarray(feats[i, 0]), jnp.asarray(feats[i, 1:]),
        jnp.asarray(rels[i]), jnp.asarray(hyps[i]), sampler="gather"))
        for i in range(2)])
    before = fused_variance_volume.launches
    got = fused_variance_volume(_t(feats[:, 0]), _t(feats[:, 1:]), _t(rels),
                                _t(hyps)).numpy()
    assert fused_variance_volume.launches == before  # CPU: plain version
    assert got.shape == want.shape == (2, hyps.shape[1], 24, 40, 6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _pallas_cases():
    shared = make_plane_scene(num_views=3, height=48, width=64, z0=10.0)
    tilted = make_plane_scene(num_views=2, height=96, width=128, z0=10.0,
                              tilt=(0.15, 0.1))
    step = make_step_scene(num_views=2, height=96, width=128, baseline=1.2)
    return {
        "shared_ladder": (shared, 2, lambda s: np.broadcast_to(
            np.asarray(uniform_depth_values(8.0, 0.5, 8))[:, None, None],
            (8, 48, 64)), dict(band_h=48, band_w=64, depth_group=1), 2e-3),
        "per_pixel": (tilted, 1, lambda s: np.stack(
            [s.depths[0] + o for o in (-0.3, -0.1, 0.1, 0.3)]),
            dict(band_h=48, band_w=64, depth_group=4), 2e-3),
        "discontinuity": (step, 1, lambda s: np.stack(
            [s.depths[0] + o for o in (-0.2, 0.0, 0.2)]),
            dict(band_h=64, band_w=96, depth_group=3), 3e-3),
    }


@pytest.mark.parametrize("case", ["shared_ladder", "per_pixel",
                                  "discontinuity"])
def test_matches_pallas_kernel_interpret(case):
    scene, nsrc, make_hyp, band, bound = _pallas_cases()[case]
    feats, rels = _inputs(scene, nsrc)
    hyp = np.ascontiguousarray(make_hyp(scene), np.float32)
    want = np.asarray(fused_variance_volume_pallas(
        jnp.asarray(feats[0])[None], jnp.asarray(feats[1:])[None],
        jnp.asarray(rels)[None], jnp.asarray(hyp)[None], tile_rows=16,
        tile_cols=32, interpret=True, **band))[0]
    got = fused_variance_volume(_t(feats[0])[None], _t(feats[1:])[None],
                                _t(rels)[None], _t(hyp)[None])[0].numpy()
    err = np.abs(got - want)
    assert err.mean() < bound, err.mean()


def test_variance_from_partials_and_bf16():
    rng = np.random.default_rng(4)
    f = rng.standard_normal((3, 2, 5)).astype(np.float32)
    got = tcv.variance_from_partials(_t(f.sum(0)), _t((f * f).sum(0)), 3)
    np.testing.assert_allclose(got.numpy(), f.var(0), atol=1e-5)
    # bf16 features: sums in f32, one rounding of the result to bf16.
    scene = make_plane_scene(num_views=3, height=16, width=24)
    feats, rels = _inputs(scene, 2)
    hyp = np.broadcast_to(np.linspace(8, 12, 4, dtype=np.float32)[:, None,
                                                                    None],
                          (4, 16, 24))
    x = _t(feats).to(torch.bfloat16)
    got = fused_variance_volume(x[0][None], x[1:][None], _t(rels)[None],
                                _t(hyp)[None])
    want = fused_variance_volume(x[0][None].float(), x[1:][None].float(),
                                 _t(rels)[None], _t(hyp)[None])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               want.to(torch.bfloat16).float().numpy(),
                               rtol=0, atol=0)


def test_wrapper_rejects_other_devices():
    x = torch.empty((1, 4, 4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_variance_volume(x, x[:, None], torch.empty((1, 1, 4, 4)),
                              torch.empty((1, 2, 4, 4)))
