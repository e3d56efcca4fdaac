"""AACVP-MVSNet's group-wise correlation in the port against mvs_tpu's on
the CPU (JAX_PLATFORMS=cpu, exact gather sampler), and AACVP-MVSNet
inference as a whole.

The plain version of the group-correlation kernel
(ops.cost_volume.group_correlation_cost_volume) is held against
mvs_tpu.ops.cost_volume.group_correlation_cost_volume to 1e-5 of the largest
magnitude: shared ladders and per-pixel hypotheses, batch 2, D = 1, C = 12
in 3 groups, C = 24 in 2 and C = 16 in 8 (the group layouts the kernel's
16-byte variant branches on), off-image and behind-camera samples. The wrapper runs the plain
version only for CPU tensors: on any other device it launches the kernel or
raises. The kernel itself runs only on the card (chip_smoke.py phases 8a
and 10a hold it and its backward against the plain versions there).
AACVP-MVSNet (3 levels at 64x80, 3 views, batch 2, epipolar interval on,
Flax parameters through convert.py) is held to the CasMVSNet bounds: depth
rtol 1e-4 at every level, confidence atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_tpu.models.cvp_mvsnet import CVPMVSNet as JaxCVPMVSNet
from mvs_tpu.nn.feature_nets import PyramidFeatureNet as JaxFeatureNet
from mvs_tpu.ops.cost_volume import \
    group_correlation_cost_volume as jax_group_correlation
from mvs_tpu_torch.convert import flax_to_state_dict
from mvs_tpu_torch.models.cvp_mvsnet import CVPMVSNet
from mvs_tpu_torch.nn.feature_nets import PyramidFeatureNet
from mvs_tpu_torch.ops import group_correlation
from mvs_tpu_torch.ops.group_correlation import (
    group_correlation_volume, group_correlation_volume_plain)
from test_torch_cvp import _t, init_variables, scenes


def _geometry(b, v, seed):
    """Random near-identity relative projections whose translations push
    samples off the image and (for negative depths) behind the camera."""
    rng = np.random.default_rng(seed)
    rel = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
    rel[:, :, :3, :3] += rng.normal(0, 0.05, (b, v, 3, 3))
    rel[:, :, :3, 3] = rng.normal(0, 1, (b, v, 3)) * np.array([20, 20, 0.5])
    return rel.astype(np.float32)


@pytest.mark.parametrize("b,v,d,h,w,c,g,per_pixel", [
    (2, 3, 5, 9, 13, 16, 4, True),
    (2, 4, 6, 7, 10, 16, 4, False),
    (1, 2, 1, 6, 8, 12, 3, True),
    # the kernel's 16-byte lane layout: groups across 16-byte chunks
    # (Cg = 12), and two (bf16) or more (f32) groups in one chunk (Cg = 2)
    (2, 3, 4, 7, 9, 24, 2, True),
    (1, 3, 3, 6, 8, 16, 8, False),
    # wide features: past the lane kernel's 32 chunks in f32
    (1, 2, 2, 5, 6, 160, 4, True),
])
def test_plain_matches_jax(b, v, d, h, w, c, g, per_pixel):
    rng = np.random.default_rng(b * 100 + d)
    feats = rng.standard_normal((b, v + 1, h, w, c)).astype(np.float32)
    rel = _geometry(b, v, d)
    if per_pixel:
        hyp = (np.linspace(12.0, -2.0, d)[None, :, None, None]
               + rng.uniform(0, 1, (b, d, h, w))).astype(np.float32)
    else:
        hyp = np.tile(np.linspace(0.5, 12.0, d, dtype=np.float32), (b, 1))
    want = np.asarray(jax.jit(jax.vmap(
        lambda r, s, p, dv: jax_group_correlation(r, s, p, dv, g)))(
        feats[:, 0], feats[:, 1:], rel, hyp))
    got = group_correlation_volume(_t(feats[:, 0]), _t(feats[:, 1:]),
                                   _t(rel), _t(hyp), g)
    assert got.shape == (b, d, h, w, g) and got.dtype == torch.float32
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * np.abs(want).max())


def test_plain_sums_bf16_in_f32():
    """bf16 features: the product sums are f32 and rounded once, as the
    kernel takes them (mvs_tpu's gather path sums in bf16)."""
    rng = np.random.default_rng(3)
    feats = torch.from_numpy(rng.standard_normal((1, 3, 6, 8, 16)).astype(
        np.float32)).to(torch.bfloat16)
    rel, hyp = _t(_geometry(1, 2, 3)), torch.full((1, 4, 6, 8), 5.0)
    got = group_correlation_volume_plain(feats[:, 0], feats[:, 1:], rel, hyp,
                                         4)
    want = group_correlation_volume_plain(feats[:, 0].float(),
                                          feats[:, 1:].float(), rel, hyp, 4)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), atol=0, rtol=0)


def test_wrapper_never_falls_back_from_a_device(monkeypatch):
    """Off the CPU the wrapper launches the kernel or raises: a feature or
    hypotheses that require a gradient go through the autograd Function
    (whose forward is the kernel), another device is refused, and the
    cameras never take a gradient."""
    ref = torch.empty((1, 4, 4, 16), device="meta")
    src = torch.empty((1, 2, 4, 4, 16), device="meta")
    rel = torch.empty((1, 2, 4, 4), device="meta")
    hyp = torch.empty((1, 3, 4, 4), device="meta")
    applied = []
    apply = group_correlation._GroupCorrelation.apply
    monkeypatch.setattr(group_correlation._GroupCorrelation, "apply",
                        lambda *a: applied.append(a) or apply(*a))
    for args in ((ref.requires_grad_(), src, rel, hyp),
                 (ref.detach(), src, rel, hyp.requires_grad_())):
        with pytest.raises(ValueError, match="unsupported device meta"):
            group_correlation_volume(*args, 4)
    assert len(applied) == 2
    with pytest.raises(ValueError, match="unsupported device meta"):
        group_correlation_volume(ref.detach(), src, rel, hyp.detach(), 4)
    assert len(applied) == 2
    with pytest.raises(ValueError, match="rel_projs requires grad"):
        group_correlation_volume(torch.zeros(1, 4, 4, 16),
                                 torch.zeros(1, 2, 4, 4, 16),
                                 torch.zeros(1, 2, 4, 4, requires_grad=True),
                                 torch.ones(1, 3, 4, 4), 4)
    with pytest.raises(ValueError, match="not divisible"):
        group_correlation_volume(torch.zeros(1, 4, 4, 16),
                                 torch.zeros(1, 2, 4, 4, 16),
                                 torch.zeros(1, 2, 4, 4),
                                 torch.ones(1, 3, 4, 4), 5)


def test_attention_features_are_float32_in_bf16():
    """mvs_tpu's AttentionConv adds f32 embeddings to bf16 keys, so AACVP's
    features (and its cost volume) are f32 in a bf16 model; the port keeps
    that dtype flow."""
    x = jnp.zeros((1, 8, 8, 3), jnp.bfloat16)
    jmod = JaxFeatureNet(16, attention=True, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(jmod.init, jax.random.key(0), x)
    assert jax.eval_shape(jmod.apply, shapes, x).dtype == jnp.float32
    port = PyramidFeatureNet(16, attention=True).eval()
    with torch.no_grad():
        assert port(torch.zeros(1, 8, 8, 3, dtype=torch.bfloat16)).dtype == \
            torch.float32


@pytest.fixture(scope="module")
def aacvp_outputs():
    """AACVP-MVSNet, 3 levels at 64x80, 3 views, batch 2, epipolar interval
    on, f32: (port outputs, JAX outputs)."""
    s = scenes(2, 64, 80)
    args = (s["images"], s["intrinsics"], s["extrinsics"],
            np.array([8.0, 8.5], np.float32), np.array([12.0, 12.5],
                                                       np.float32))
    kw = dict(num_levels=3, use_epipolar_interval=True, attention=True,
              cost_mode="group_correlation", num_groups=4)
    jmodel = JaxCVPMVSNet(**kw)
    variables = init_variables(jmodel, *args, seed=4)
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        variables, *args)
    model = CVPMVSNet(**kw)
    model.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = model.eval()(*(_t(a) for a in args))
    return got, jax.tree.map(np.asarray, want)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_aacvp_depth_matches_jax(aacvp_outputs, level):
    got, want = aacvp_outputs
    g, w = got["depth_levels"][level].numpy(), want["depth_levels"][level]
    assert g.shape == w.shape == (2, 64 // 2 ** level, 80 // 2 ** level)
    np.testing.assert_allclose(g, w, rtol=1e-4)


def test_aacvp_confidence_matches_jax(aacvp_outputs):
    got, want = aacvp_outputs
    np.testing.assert_allclose(got["photometric_confidence"].numpy(),
                               want["photometric_confidence"], atol=1e-4)
