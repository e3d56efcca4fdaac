"""Parity of the port's fused 3x3x3 conv (mvs_tpu_torch.ops.conv3d) with
mvs_tpu's on the CPU.

On CPU tensors ``conv3d_affine`` runs its plain version (F.conv3d, affine,
ReLU); the CUDA kernel is held against it on the card by chip_smoke.py. Here
it is held against the Pallas kernel conv3d_folded(..., interpret=True) at
the shapes and bound of tests/test_conv3d_pallas.py (rtol/atol 2e-4: f32
sums of 27*Cin products in another order), and FusedConvBlock3D against the
Flax module through converted weights with non-trivial BatchNorm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_tpu.nn.blocks import FusedConvBlock3D as JaxFusedConvBlock3D
from mvs_tpu.ops.conv3d_pallas import conv3d_folded
from mvs_tpu_torch.convert import flax_to_state_dict
from mvs_tpu_torch.nn.blocks import FusedConvBlock3D
from mvs_tpu_torch.ops.conv3d import conv3d_affine
from test_torch_blocks import perturb_batch_norm


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("c_in,c_out,shape", [
    (16, 8, (4, 8, 16)),
    (8, 8, (4, 8, 32)),
    (32, 8, (4, 8, 8)),
    (16, 16, (3, 6, 16)),
])
def test_matches_pallas_kernel_interpret(c_in, c_out, shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, *shape, c_in)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, c_in, c_out)) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, c_out).astype(np.float32)
    shift = rng.standard_normal(c_out).astype(np.float32)
    want = np.asarray(conv3d_folded(jnp.asarray(x), jnp.asarray(k),
                                    jnp.asarray(scale), jnp.asarray(shift),
                                    relu=True, interpret=True))
    before = conv3d_affine.launches
    got = conv3d_affine(_t(x), _t(k.transpose(4, 3, 0, 1, 2)), _t(scale),
                        _t(shift), relu=True).numpy()
    assert conv3d_affine.launches == before  # CPU: plain version
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("relu", [True, False])
def test_fused_block_matches_flax(relu):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 6, 10, 16)).astype(np.float32)
    block = JaxFusedConvBlock3D(8, relu=relu)
    variables = perturb_batch_norm(
        jax.jit(block.init)(jax.random.key(0), jnp.asarray(x)), 2)
    want = np.asarray(block.apply(variables, jnp.asarray(x)))
    port = FusedConvBlock3D(16, 8, relu=relu)
    port.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = port(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_wrapper_rejects_other_devices():
    x = torch.empty((1, 2, 3, 4, 8), device="meta")
    w = torch.empty((8, 8, 3, 3, 3))
    with pytest.raises(ValueError, match="unsupported device"):
        conv3d_affine(x, w, torch.ones(8), torch.zeros(8), relu=False)
