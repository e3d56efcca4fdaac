"""The port's data=2 train step over two gloo processes against mvs_tpu's
step on a 2-device data_parallel mesh, on the CPU.

MVSNet (64x64 images, 3 views, 8 hypotheses, global batch 2 with unequal
mask counts, smooth-L1) from one set of variables (jax.jit(model.init)),
one SGD step at lr 1e-2 (the update is -lr x the gradient), f32. The ranks
(tests/_torch_dist_worker.py) run while mvs_tpu compiles. Bounds:
tests/test_parallel.py's noise-floor criterion per parameter, deviation <=
3 x (how far a 1-ulp change of the images moves mvs_tpu's one-device
update) + 2% of that update's norm + 5e-7, and the loss within 1e-4. The
port's own two-rank step against its one-process step, in float64, and
the wrong forms of the gradient rule are in tests/test_torch_parallel.py.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvs_tpu.models.mvsnet import MVSNet as JaxMVSNet
from mvs_tpu.parallel import make_mesh as jax_make_mesh
from mvs_tpu.parallel import replicate as jax_replicate
from mvs_tpu.parallel import shard_batch as jax_shard_batch
from mvs_tpu.train import MVSNetTask as JaxMVSNetTask
from mvs_tpu.train import TrainState
from mvs_tpu.train import make_train_step as jax_make_train_step
from mvs_tpu_torch.convert import flax_to_state_dict
from test_torch_mvsnet_train import ZERO_GRADIENT, _train_batch
from test_torch_parallel import DATA2, run_ranks

LR = 1e-2
CASE = ("train", DATA2, "right", 1, "float32")


def _jax_steps(variables, batch):
    """mvs_tpu's one-step updates and losses: on a 2-device data mesh, on
    one device, and on one device with the images moved by 1 ulp."""
    model = JaxMVSNet(sampler="gather")
    task = JaxMVSNetTask(model)

    def run(mesh, b):
        with jax.set_mesh(mesh), jax.default_matmul_precision("highest"):
            st = TrainState.create(
                apply_fn=model.apply,
                params=jax_replicate(mesh, variables["params"]),
                batch_stats=jax_replicate(mesh, variables["batch_stats"]),
                tx=optax.sgd(LR))
            new, metrics = jax_make_train_step(task, donate=False)(
                st, jax_shard_batch(mesh, b))
            upd = jax.tree.map(lambda a, c: np.asarray(a - c), new.params,
                               variables["params"])
        return float(metrics["loss"]), flax_to_state_dict({"params": upd})

    dp = run(jax_make_mesh(data=2, devices=jax.devices()[:2]), batch)
    one_mesh = jax_make_mesh(data=1, devices=jax.devices()[:1])
    one = run(one_mesh, batch)
    nudged = dict(batch, imgs=batch["imgs"] * np.float32(1 + 2e-7))
    return dp, one, run(one_mesh, nudged)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batch = _train_batch()
    batch["mask"][1, :6] = 0.0  # unequal mask counts over the data ranks
    jbatch = jax.tree.map(jnp.asarray, batch)
    variables = jax.tree.map(np.asarray, jax.jit(
        JaxMVSNet(sampler="gather").init, static_argnames=("train",))(
            jax.random.key(0), jbatch["imgs"], jbatch["proj_matrices"],
            jbatch["depth_values"], train=False))
    state = flax_to_state_dict(variables)
    inp = dict(cases=[CASE], state=state, loss="smooth_l1", batch=batch)
    ranks = {}
    launch = threading.Thread(target=lambda: ranks.update(
        out=run_ranks(inp, tmp_path_factory.mktemp("train"))))
    launch.start()
    try:
        steps = _jax_steps(variables, batch)
    finally:
        launch.join()
    return dict(state=state, ranks=ranks["out"], jax=steps)


def test_data_parallel_step_matches_mvs_tpu(runs):
    (jax_loss, jax_dp), (_, jax_one), (_, jax_nudged) = runs["jax"]
    for rank in runs["ranks"]:
        got = rank[CASE]
        np.testing.assert_allclose(got["metrics"]["loss"], jax_loss,
                                   rtol=1e-4)
        for k, want in jax_dp.items():
            if k in ZERO_GRADIENT:  # exact gradient 0: rounding residue
                continue
            u = got["state"][k].double() - runs["state"][k].double()
            dev = float(torch.linalg.norm(u - want.double()))
            floor = float(torch.linalg.norm(jax_nudged[k].double()
                                            - jax_one[k].double()))
            den = float(torch.linalg.norm(jax_one[k].double()))
            assert dev <= 3 * floor + 0.02 * den + 5e-7, (
                f"{k}: deviation {dev:.3e}, floor {floor:.3e}, norm "
                f"{den:.3e}")
