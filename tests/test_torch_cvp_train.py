"""The port's CVP-MVSNet training pieces against mvs_tpu's on the CPU:
pyramid_loss, collate_pyramid (2 and 3 levels), PyramidTask's loss and
metrics (and its zip over the levels the GT has), and one CVP-MVSNet train
step (AACVP-MVSNet's: tests/test_torch_aacvp_train.py, with these checks,
so that each file runs alone in under a minute).

The train step: 2 levels, images 32x40, 3 views, batch 2, the fixed
training interval (the train config's model at a tiny size), the GT from
collate_pyramid with a partial mask, BatchNorm from Flax's initial state
(count 0), both sides from the same variables. Both models share one
feature net and one regularizer over the levels, so every parameter's
gradient carries the coarse level's contribution, which reaches the fine
level's loss through the upsampled depth: through the regression over the
residual hypotheses and through the cost volume's sampling coordinates.
Putting back the port's old depth.detach() moves the gradients far beyond
the bounds below (0.68 of the largest magnitude in float64). Bounds are
those of tests/test_torch_train.py and tests/test_torch_mvsnet_train.py,
with their reasons, all against mvs_tpu's step in float64 (its
jnp.float32 read as float64): the port's f32 loss and metrics rtol 1e-5,
its float64 loss rtol 1e-12; its float64 gradients within 1e-9 of each
parameter's largest magnitude; each of its f32 gradients within 1e-3 of
the float64 gradient's largest magnitude, or within 30x what one f32
rounding of the images moves it; the new BatchNorm statistics within 1e-4
of each vector's largest magnitude, count 2 (one update per level). The
regularizer's score bias is left out: the softmax over depth is invariant
to it, so its exact gradient is 0. mvs_tpu's own f32 step is not a
yardstick here: its gradients lie a median 1.6e-2 of their largest
magnitude from its float64 ones, the port's 1.1e-3 (CVP-MVSNet at this
size; XLA's CPU reductions, as tests/test_torch_train.py shows for
CasMVSNet). Hypotheses: 16 coarse (the config's 48 cut, so that each file
runs alone in under a minute) and 2 x 4 residual.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_tpu.io import dtu as jax_dtu
from mvs_tpu.models.cvp_mvsnet import CVPMVSNet as JaxCVPMVSNet
from mvs_tpu.train import losses as jax_losses
from mvs_tpu.train.tasks import PyramidTask as JaxPyramidTask
from mvs_tpu_torch.convert import flax_to_state_dict
from mvs_tpu_torch.io.dtu import DTUTrainDataset, collate_pyramid
from mvs_tpu_torch.models.cvp_mvsnet import CVPMVSNet
from mvs_tpu_torch.train import losses
from mvs_tpu_torch.train.tasks import PyramidTask, batch_to_device
from mvs_tpu_torch.utils.make_synthetic_dtu import generate
from mvs_tpu_torch.utils.synthetic import make_plane_scene
from test_torch_train import (ROUNDING_FACTOR, _Float64Numpy,
                              _flax_grads_to_torch, _gradient_errors,
                              _to_float64)
from test_torch_train_blocks import random_variables

H, W, VIEWS = 32, 40, 3
FAMILIES = {
    "cvp_mvsnet": dict(num_levels=2, coarse_depths=16),
    "aacvp_mvsnet": dict(num_levels=2, coarse_depths=16, attention=True,
                         cost_mode="group_correlation", num_groups=4),
}
ZERO_GRADIENT = ("PyramidCostRegNet_0.FoldedConv_0.bias",)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _levels(seed, shapes=((2, 8, 10), (2, 4, 5))):
    rng = np.random.default_rng(seed)
    est = [rng.uniform(400, 900, s).astype(np.float32) for s in shapes]
    gt = [(e + rng.normal(0, 3, e.shape)).astype(np.float32) for e in est]
    mask = [(rng.uniform(0, 1, e.shape) > 0.3).astype(np.float32)
            for e in est]
    return est, gt, mask


def test_pyramid_loss_matches_jax():
    est, gt, mask = _levels(0)
    want = jax_losses.pyramid_loss(est, gt, mask)
    got = losses.pyramid_loss([_t(e) for e in est], [_t(g) for g in gt],
                              [_t(m) for m in mask])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # zip: levels past the shortest list are not supervised.
    short = losses.pyramid_loss([_t(e) for e in est], [_t(gt[0])],
                                [_t(mask[0])])
    np.testing.assert_allclose(float(short), float(jax_losses.pyramid_loss(
        est, gt[:1], mask[:1])), rtol=1e-6)
    assert float(short) < float(got)


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    return generate(tmp_path_factory.mktemp("dtu") / "dtu", num_scans=1,
                    num_views=4, height=32, width=48, num_depth=16,
                    num_lights=1, tilt=(0.05, 0.02))


@pytest.mark.parametrize("num_levels", [2, 3])
def test_collate_pyramid_matches_jax(train_root, num_levels):
    """Intrinsics x4, the GT x4 (np.repeat against cv2's nearest), every
    other row and column per coarser level, masks gt > depth_min."""
    kw = dict(num_views=3, num_depth=16, interval_scale=1.06)
    ds = DTUTrainDataset(train_root, ["scan1"], **kw)
    jds = jax_dtu.DTUTrainDataset(train_root, ["scan1"], **kw)
    got = collate_pyramid([ds[0], ds[3]], num_levels)
    want = jax_dtu.collate_pyramid([jds[0], jds[3]], num_levels)
    assert set(got) == set(want)
    for k in ("imgs", "intrinsics", "extrinsics", "depth_min", "depth_max"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    for k in ("depth_gt_levels", "mask_levels"):
        assert len(got[k]) == len(want[k]) == num_levels
        for g, w in zip(got[k], want[k]):
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert [g.shape for g in got["depth_gt_levels"]] == [
        (2, 32 >> i, 48 >> i) for i in range(num_levels)]
    assert 0 < got["mask_levels"][0].mean() <= 1


def test_pyramid_task_supervises_the_levels_the_gt_has():
    """mvs_tpu's cli takes collate_pyramid by name (2 levels): a 3-level
    model's loss zips over its two finest levels; the metrics are the
    finest level's. Both tasks on the same model outputs."""
    est, gt, mask = _levels(1, ((2, 8, 10), (2, 4, 5), (2, 2, 3)))
    outputs = {"depth": est[0], "depth_levels": est}
    batch = {"depth_gt_levels": gt[:2], "mask_levels": mask[:2]}

    class Fixed(torch.nn.Module):
        def forward(self, *args):
            return {"depth": _t(est[0]), "depth_levels": [_t(e) for e in est]}

    tb = {k: [_t(x) for x in v] for k, v in batch.items()}
    tb.update({k: None for k in ("imgs", "intrinsics", "extrinsics",
                                 "depth_min", "depth_max")})
    loss, metrics = PyramidTask(Fixed()).loss_and_metrics(tb)
    jtask = JaxPyramidTask(None)
    jtask.forward = lambda *a, **k: (
        jax.tree.map(jnp.asarray, outputs), None)
    want, (_, want_metrics) = jtask.loss_and_metrics(None, None, batch)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(jax_losses.pyramid_loss(
        est[:2], gt[:2], mask[:2])), rtol=1e-6)
    assert set(metrics) == set(want_metrics)
    for k in want_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(want_metrics[k]),
                                   rtol=1e-6, err_msg=k)


def test_cli_task_takes_the_two_level_collate(train_root):
    """cli train's build_task gives both names PyramidTask and
    collate_pyramid at its default 2 levels, as mvs_tpu's cli takes it by
    name: with model.num_levels=3 the GT pyramid has 2 levels, so only the
    two finest are supervised."""
    from mvs_tpu_torch.cli.train import build_task
    from mvs_tpu_torch.utils.config import load_config

    ds = DTUTrainDataset(train_root, ["scan1"], num_views=3, num_depth=16)
    for name in FAMILIES:
        cfg = load_config(None, [f"model.name={name}", "model.num_levels=3"])
        task, collate = build_task(cfg, torch.nn.Identity())
        assert isinstance(task, PyramidTask) and collate is collate_pyramid
        assert len(collate([ds[0]])["depth_gt_levels"]) == 2


def _train_batch():
    """2 plane scenes in the DTU training layout's form (intrinsics and GT
    at 1/4 of the images) through collate_pyramid; sample 1's depth_min
    masks part of its GT out."""
    samples = []
    for seed, dmin in ((0, 8.0), (1, 9.95)):
        scene = make_plane_scene(num_views=VIEWS, height=H, width=W, z0=10.0,
                                 seed=seed, tilt=(0.05, 0.02))
        intr = scene.intrinsics.copy()
        intr[:, :2] /= 4.0
        gt = scene.depths[0][::4, ::4].astype(np.float32)
        samples.append(dict(
            imgs=scene.images, intrinsics=intr, extrinsics=scene.extrinsics,
            depth_min=np.float32(dmin), depth_max=np.float32(12.0),
            depth_gt=gt))
    return collate_pyramid(samples)


_INPUTS = ("imgs", "intrinsics", "extrinsics", "depth_min", "depth_max")


def _jax_step(family, dtype):
    """jit(batch, params, stats) -> ((loss, (new stats, metrics)), grads)
    of mvs_tpu's PyramidTask in train mode."""
    task = JaxPyramidTask(JaxCVPMVSNet(sampler="gather", compute_dtype=dtype,
                                       **FAMILIES[family]))
    return jax.jit(jax.value_and_grad(
        lambda p, s, b: task.loss_and_metrics(p, s, b, train=True),
        has_aux=True))


def _port_step(family, state, batch, dtype=torch.float32):
    """Loss, metrics, gradients and state after one train-mode forward and
    backward of the port."""
    model = CVPMVSNet(compute_dtype=dtype, **FAMILIES[family]).to(dtype)
    model.load_state_dict(state)
    model.train()
    tb = batch_to_device(batch, "cpu")
    tb = {k: [t.to(dtype) for t in v] if isinstance(v, list) else v.to(dtype)
          for k, v in tb.items()}
    value, metrics = PyramidTask(model).loss_and_metrics(tb)
    value.backward()
    return dict(loss=value.item(),
                metrics={k: float(v) for k, v in metrics.items()},
                grads={k: p.grad for k, p in model.named_parameters()},
                state={k: v.clone() for k, v in model.state_dict().items()})


def make_step(family):
    """One family's step: mvs_tpu's loss, metrics, gradients and new
    statistics in float64; the port's f32 and float64 step and how far one
    f32 rounding of the images moves its f32 gradients."""
    batch = _train_batch()
    jbatch = jax.tree.map(jnp.asarray, batch)
    variables = jax.tree.map(np.asarray, random_variables(
        JaxCVPMVSNet(sampler="gather", **FAMILIES[family]),
        *(jbatch[k] for k in _INPUTS), seed=5, count=0))
    state = flax_to_state_dict(variables)
    out = dict(family=family, port=_port_step(family, state, batch))
    moved = {}
    for seed in range(3):
        sign = np.random.default_rng(seed).choice([-1.0, 1.0],
                                                  size=batch["imgs"].shape)
        nudged = dict(batch, imgs=(batch["imgs"] * (1 + sign * 2.0 ** -24)
                                   ).astype(np.float32))
        for k, g in _port_step(family, state, nudged)["grads"].items():
            moved.setdefault(k, []).append(g)
    out["moved"] = moved

    with pytest.MonkeyPatch.context() as mp:
        # mvs_tpu pins its moments, convs' sums and regression to
        # jnp.float32: read as float64 there; and torch's .float() keeps
        # float64 for the port's float64 step.
        for name, module in list(sys.modules.items()):
            if name.split(".")[0] == "mvs_tpu" and \
                    getattr(module, "jnp", None) is jnp:
                mp.setattr(module, "jnp", _Float64Numpy())
        mp.setattr(torch.Tensor, "float", lambda t: t if t.dtype ==
                   torch.float64 else t.to(torch.float32))
        x64 = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)
        try:
            v = _to_float64(variables)
            (loss, (new_stats, metrics)), grads = _jax_step(
                family, jnp.float64)(v["params"], v["batch_stats"],
                                     _to_float64(batch))
            out.update(
                jax_loss=float(loss),
                jax_metrics={k: float(x) for k, x in metrics.items()},
                jax_grads=_flax_grads_to_torch(jax.tree.map(np.asarray,
                                                            grads)),
                jax_stats=flax_to_state_dict(jax.tree.map(np.asarray, {
                    "params": variables["params"],
                    "batch_stats": new_stats})),
                port64=_port_step(
                    family, {k: t.double() for k, t in state.items()}, batch,
                    torch.float64))
        finally:
            jax.config.update("jax_enable_x64", x64)
    return out


@pytest.fixture(scope="module")
def step():
    return make_step("cvp_mvsnet")


def test_train_step_loss_and_metrics(step):
    got, want = step["port"]["metrics"], step["jax_metrics"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(step["port"]["loss"], step["jax_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(step["port64"]["loss"], step["jax_loss"],
                               rtol=1e-12)
    assert 0 < step["jax_loss"] < 10


def test_train_step_float64_gradients_agree(step):
    port, want = step["port64"]["grads"], step["jax_grads"]
    assert set(port) == set(want)
    assert ("PyramidFeatureNet_0.AttentionConv_0.rel_h" in want) == (
        step["family"] == "aacvp_mvsnet")
    top = max(float(w.abs().max()) for w in want.values())
    for k, (err, _, _) in _gradient_errors(port, want).items():
        if k in ZERO_GRADIENT:
            assert float(port[k].abs().max()) <= 1e-12 * top, k
        else:
            assert err <= 1e-9, (k, err)


def test_train_step_gradients(step):
    got, exact = step["port"]["grads"], step["jax_grads"]
    assert set(got) == set(exact)
    beyond = {}
    for k, (err, _, _) in _gradient_errors(got, exact).items():
        if k in ZERO_GRADIENT:
            continue
        scale = float(exact[k].abs().max())
        moved = max(float((g - got[k]).abs().max()) for g in step["moved"][k])
        if err > 1e-3 and err > ROUNDING_FACTOR * moved / scale:
            beyond[k] = (err, moved / scale)
    assert beyond == {}


def test_train_step_batch_stats(step):
    want, got = step["jax_stats"], step["port"]["state"]
    stats = [k for k in want if k.rsplit(".", 1)[-1] in ("mean", "var",
                                                         "count")]
    # 9 feature-net blocks (8 with attention) and 10 regularizer blocks.
    blocks = 9 - (step["family"] == "aacvp_mvsnet") + 10
    assert len(stats) == 3 * blocks
    for k in stats:
        w = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
        if k.endswith("count"):
            assert float(got[k]) == 2.0
