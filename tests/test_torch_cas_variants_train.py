"""One training step of CasMVSNet's variants against mvs_tpu's on the CPU,
in float64: unet + share_cr + none, and group norm (32x32, 3 views,
ndepths 8/8/8, batch 2; tests/test_torch_cas_variants.py holds their
forward). The loss within 1e-12 and every parameter's gradient within
1e-9 of its largest magnitude, as tests/test_torch_train.py holds the
batch-norm model's. mvs_tpu's task applies a model without batch
statistics with train=False (mvs_tpu/train/tasks.py:30-37), which for
CasMVSNet is the same function as train mode; the port trains in train
mode.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_tpu.models.cas_mvsnet import CasMVSNet as JaxCasMVSNet
from mvs_tpu.train import CascadeTask as JaxCascadeTask
from mvs_tpu_torch.convert import flax_to_state_dict
from mvs_tpu_torch.models.cas_mvsnet import CasMVSNet
from mvs_tpu_torch.train.tasks import CascadeTask, batch_to_device
from test_torch_cas_variants import NDEPTHS, VARIANTS
from test_torch_train import (_flax_grads_to_torch, _Float64Numpy,
                              _gradient_errors, _to_float64, _train_batch)
from test_torch_train_blocks import random_variables


@pytest.fixture(scope="module")
def batch():
    return _train_batch()


@pytest.mark.parametrize("name", ["unet_shared_none", "group"])
def test_train_step_float64_gradients_agree(name, batch):
    """One train step's loss and gradients in float64, the port in train
    mode against jax.grad of mvs_tpu's CascadeTask."""
    kw = VARIANTS[name]
    jb = jax.tree.map(jnp.asarray, batch)
    variables = random_variables(JaxCasMVSNet(ndepths=NDEPTHS, **kw),
                                 jb["imgs"], jb["proj_matrices"],
                                 jb["depth_values"], seed=7)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "float", lambda t: t if t.dtype ==
                   torch.float64 else t.to(torch.float32))
        model = CasMVSNet(ndepths=NDEPTHS, compute_dtype=torch.float64, **kw)
        model.load_state_dict(flax_to_state_dict(variables))
        model.double().train()
        tb = batch_to_device(batch, "cpu")
        tb = {k: {s: t.double() for s, t in v.items()} if isinstance(v, dict)
              else v.double() for k, v in tb.items()}
        loss, _ = CascadeTask(model).loss_and_metrics(tb)
        loss.backward()
        port = {k: p.grad for k, p in model.named_parameters()}

        for mod_name, module in list(sys.modules.items()):
            if mod_name.split(".")[0] == "mvs_tpu" and \
                    getattr(module, "jnp", None) is jnp:
                mp.setattr(module, "jnp", _Float64Numpy())
        x64 = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)
        try:
            jtask = JaxCascadeTask(JaxCasMVSNet(
                ndepths=NDEPTHS, compute_dtype=jnp.float64, **kw))
            v64 = _to_float64(variables)
            assert "batch_stats" not in v64
            jloss, jgrads = jax.jit(jax.value_and_grad(
                lambda p, b: jtask(p, None, b)[0]))(
                    v64["params"], _to_float64(batch))
            jgrads = _flax_grads_to_torch(jax.tree.map(np.asarray, jgrads))
        finally:
            jax.config.update("jax_enable_x64", x64)
    assert set(port) == set(jgrads)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-12)
    top = max(float(w.abs().max()) for w in jgrads.values())
    for k, (err, _, _) in _gradient_errors(port, jgrads).items():
        if k.endswith("FoldedConv_0.bias") and "cost_reg" in k:
            # The score conv's bias: softmax over depth ignores a constant,
            # so its exact gradient is 0 (rounding residue on both sides).
            assert float(port[k].abs().max()) <= 1e-12 * top, k
        else:
            assert err <= 1e-9, (k, err)
