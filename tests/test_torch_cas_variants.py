"""CasMVSNet's variants against mvs_tpu's on the CPU: U-Net features
(arch_mode="unet"), one shared regularizer behind per-stage 1x1x1
projections (share_cr=True), and normalization "none" and "group".

Three JAX references at 32x32, 3 views, ndepths 8/8/8, f32, batch 2
(weights: kernels N(0, 1/fan_in), non-trivial BatchNorm and GroupNorm
affines, through convert.flax_to_state_dict):
  * "unet_shared_none": unet + share_cr + none;
  * "unet_shared_batch": unet + share_cr + batch (BatchNorm folded into
    the epilogues in eval mode, the 2D transposed convs of the unet head);
  * "group": FPN, one regularizer per stage, group norm.
Depth is compared at rtol 1e-4 and confidence at atol 1e-4, as
tests/test_torch_cas_mvsnet.py does. share_cr's parameter count is below
the per-stage model's (tests/test_cascade.py). The variants' training
step: tests/test_torch_cas_variants_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_tpu.models.cas_mvsnet import CasMVSNet as JaxCasMVSNet
from mvs_tpu_torch.convert import flax_to_state_dict
from mvs_tpu_torch.models.cas_mvsnet import CasMVSNet
from mvs_tpu_torch.train.tasks import batch_to_device
from test_torch_train import _train_batch
from test_torch_train_blocks import random_variables

NDEPTHS = (8, 8, 8)
VARIANTS = {
    "unet_shared_none": dict(arch_mode="unet", share_cr=True,
                             normalization="none"),
    "unet_shared_batch": dict(arch_mode="unet", share_cr=True,
                              normalization="batch"),
    "group": dict(normalization="group"),
}


@pytest.fixture(scope="module")
def batch():
    return _train_batch()


@pytest.fixture(scope="module", params=list(VARIANTS))
def reference(request, batch):
    name = request.param
    kw = VARIANTS[name]
    jb = jax.tree.map(jnp.asarray, batch)
    jmodel = JaxCasMVSNet(ndepths=NDEPTHS, **kw)
    variables = random_variables(jmodel, jb["imgs"], jb["proj_matrices"],
                                 jb["depth_values"], seed=5)
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        variables, jb["imgs"], jb["proj_matrices"], jb["depth_values"])
    model = CasMVSNet(ndepths=NDEPTHS, **kw)
    model.load_state_dict(flax_to_state_dict(variables))
    model.eval()
    tb = batch_to_device(batch, "cpu")
    with torch.no_grad():
        got = model(tb["imgs"], tb["proj_matrices"], tb["depth_values"])
    return dict(name=name, kw=kw, variables=variables, model=model, got=got,
                want=jax.tree.map(np.asarray, want))


@pytest.mark.parametrize("key", ["depth", "stage1", "stage2"])
def test_depth_matches_jax(reference, key):
    got, want = reference["got"], reference["want"]
    g = got[key] if key == "depth" else got[key]["depth"]
    w = want[key] if key == "depth" else want[key]["depth"]
    assert g.shape == w.shape
    np.testing.assert_allclose(g.numpy(), w, rtol=1e-4)


@pytest.mark.parametrize("key", ["photometric_confidence", "prob_volume"])
def test_confidence_matches_jax(reference, key):
    got, want = reference["got"], reference["want"]
    g = got[key] if key == "photometric_confidence" else \
        got["stage3"]["prob_volume"]
    w = want[key] if key == "photometric_confidence" else \
        want["stage3"]["prob_volume"]
    np.testing.assert_allclose(g.numpy(), w, atol=1e-4)


def test_parameters_are_the_flax_tree(reference):
    """Every converted parameter lands on a port parameter of its shape,
    and every statistic on a buffer."""
    state = flax_to_state_dict(reference["variables"])
    model_state = reference["model"].state_dict()
    assert set(state) == set(model_state)
    for k, p in reference["model"].named_parameters():
        assert tuple(state[k].shape) == tuple(p.shape), k


def test_shared_regularizer_has_fewer_parameters():
    def count(m):
        return sum(p.numel() for p in m.parameters())

    shared = CasMVSNet(ndepths=NDEPTHS, share_cr=True)
    assert count(shared) < count(CasMVSNet(ndepths=NDEPTHS))
    assert not hasattr(shared, "cost_reg_stage1")
