"""Parity of the port's layers (mvs_tpu_torch.nn, ops.regression) with the
Flax modules of mvs_tpu on the CPU, eval mode, f32, through weights carried
over by convert.flax_to_state_dict with non-trivial BatchNorm. Tolerance
rtol/atol 2e-4 (f32 sums in another order), 1e-5 for the elementwise ops."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_tpu.nn import blocks as jblocks
from mvs_tpu.nn.cost_reg import UNetCostRegNet as JaxUNet
from mvs_tpu.nn.feature_nets import CascadeFeatureNet as JaxFeatureNet
from mvs_tpu.nn.feature_nets import _upsample2x_nearest as jax_upsample
from mvs_tpu.ops.regression import regress_depth_and_confidence as jax_regress
from mvs_tpu_torch.convert import flax_to_state_dict
from mvs_tpu_torch.nn import blocks
from mvs_tpu_torch.nn.cost_reg import UNetCostRegNet
from mvs_tpu_torch.nn.feature_nets import (CascadeFeatureNet,
                                            _upsample2x_nearest)
from mvs_tpu_torch.ops.regression import regress_depth_and_confidence


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def perturb_batch_norm(variables, seed):
    """numpy copy of Flax `variables` with non-trivial BatchNorm and biases:
    random gamma/beta/bias and EMA accumulators after 3 updates (shared by
    the other tests/test_torch_*.py files)."""
    rng = np.random.default_rng(seed)
    draw = {
        "count": lambda s: np.full(s, 3.0),
        "mean": lambda s: rng.normal(0.0, 0.1, s),
        "var": lambda s: rng.uniform(0.2, 0.6, s),
        "scale": lambda s: rng.uniform(0.5, 1.5, s),
        "bias": lambda s: rng.normal(0.0, 0.2, s),
    }

    def f(path, x):
        name = path[-1].key
        x = draw[name](np.shape(x)) if name in draw else x
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(f, variables)


def _run_both(jax_module, port_module, x, seed=0):
    variables = perturb_batch_norm(
        jax.jit(jax_module.init)(jax.random.key(seed), jnp.asarray(x)),
        seed + 1)
    want = jax_module.apply(variables, jnp.asarray(x))
    port_module.load_state_dict(flax_to_state_dict(variables))
    port_module.eval()
    with torch.no_grad():
        got = port_module(_t(x))
    return got, want


@pytest.mark.parametrize("rank,kernel,shape", [
    (2, 5, (2, 12, 16, 8)),      # feature net downsampling conv
    (2, 3, (2, 7, 9, 8)),        # odd sizes: asymmetric SAME pads
    (3, 3, (2, 4, 6, 8, 8)),     # cost-reg downsampling conv
    (3, 3, (1, 5, 7, 9, 8)),
])
def test_stride2_conv_block(rank, kernel, shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ks = (kernel,) * rank
    got, want = _run_both(jblocks.ConvBlock(16, ks, strides=2),
                          blocks.ConvBlock(8, 16, ks, stride=2), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_conv_transpose_block():
    x = np.random.default_rng(1).standard_normal((2, 3, 4, 5, 16)).astype(
        np.float32)
    got, want = _run_both(jblocks.ConvTransposeBlock(8, (3, 3, 3), strides=2),
                          blocks.ConvTransposeBlock(16, 8), x)
    assert got.shape == (2, 6, 8, 10, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_upsample2x_nearest():
    x = np.random.default_rng(2).standard_normal((2, 3, 5, 4)).astype(
        np.float32)
    np.testing.assert_allclose(_upsample2x_nearest(_t(x)).numpy(),
                               np.asarray(jax_upsample(jnp.asarray(x))),
                               atol=1e-6)


@pytest.fixture(scope="module")
def feature_net_outputs():
    x = np.random.default_rng(3).uniform(0, 1, (2, 32, 48, 3)).astype(
        np.float32)
    return _run_both(JaxFeatureNet(8, 3, "fpn"), CascadeFeatureNet(8, 3), x)


@pytest.mark.parametrize("stage", ["stage1", "stage2", "stage3"])
def test_cascade_feature_net(feature_net_outputs, stage):
    got, want = feature_net_outputs
    np.testing.assert_allclose(got[stage].numpy(), np.asarray(want[stage]),
                               rtol=2e-4, atol=2e-4)


def test_unet_cost_reg():
    x = np.random.default_rng(4).standard_normal((1, 8, 8, 16, 16)).astype(
        np.float32)
    got, want = _run_both(JaxUNet(8), UNetCostRegNet(16, 8), x)
    assert got.shape == (1, 8, 8, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("per_pixel", [False, True])
def test_regress_depth_and_confidence(per_pixel):
    rng = np.random.default_rng(5)
    cost = (rng.standard_normal((2, 8, 5, 6)) * 3).astype(np.float32)
    if per_pixel:
        hyp = (rng.uniform(8, 12, (2, 1, 5, 6))
               + np.arange(8)[None, :, None, None] * 0.1).astype(np.float32)
    else:
        hyp = np.broadcast_to(np.linspace(8, 12, 8, dtype=np.float32)[
            None, :, None, None], (2, 8, 5, 6)).copy()
    want = jax.vmap(jax_regress)(jnp.asarray(cost), jnp.asarray(hyp))
    got = regress_depth_and_confidence(_t(cost), _t(hyp))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
