"""The port's MVSNet training pieces against mvs_tpu's on the CPU: the OHEM
loss, collate_mvsnet, and one train step of MVSNetTask for both losses
(smooth_l1 with RefineNet, ohem without).

The train step: 64x64 images, 3 views, batch 2, an 8-hypothesis ladder,
the GT at 1/4 resolution with a partial mask, non-trivial BatchNorm (count
3), both sides from the same variables (jax.jit(model.init)). Bounds are
those of tests/test_torch_train.py, with its reasons: loss and metrics rtol
1e-5; the new statistics within 1e-4 of each vector's largest magnitude;
in float64 the port's and mvs_tpu's gradients agree to 1e-9 of each
parameter's largest magnitude; each of the port's f32 gradients lies
within 1e-3 of mvs_tpu's float64 gradient's largest magnitude, or within
30x what one f32 rounding of the images moves it, and points as jax.grad's
f32 gradient does (cosine > 0.999, norm within 1%). The regularizer's score
bias is left out: the softmax over depth is invariant to it, so its exact
gradient is 0 and both sides hold rounding residue.

The bf16 step (f32 parameters) of both packages for both losses is held
against the float64 step by tests/test_torch_train.py's rule for
CasMVSNet's (check_bf16_step; each figure averaged over the batch and two
copies with the images moved by one bf16 rounding): each of the port's
parameters within twice mvs_tpu's mean error or under 0.05 (mvs_tpu's
median is ~0.81 / ~0.95 of the largest magnitude with / without
RefineNet, and the float64 gradient on the moved images lies as far from
the batch's; the port's ratio to mvs_tpu's 0.57-1.44 / 0.71-1.34); where
mvs_tpu's mean cosine is at least 0.5 (39 of 66 / 29 of 54 parameters),
the mean norm within a factor 1.5 of mvs_tpu's (0.96-1.10 / 0.95-1.12)
and the mean cosine at most 0.5 under it (-0.22 to +0.15 / -0.10 to
+0.05); each draw's loss within 0.1 relative (mvs_tpu's lie up to 8.3%
off), its mean error within twice mvs_tpu's or under 1e-2. Each side's
bf16 / f32 gradient norm per draw is printed: with RefineNet 1.00-1.20
for the port and 0.96-1.16 for mvs_tpu.

OHEM sorts, so its gradient reaches the pixels it selects: the test inputs
are continuous draws, free of ties at rank k, so that jax.grad and autograd
select the same pixels.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_tpu.io import dtu as jax_dtu
from mvs_tpu.models.mvsnet import MVSNet as JaxMVSNet
from mvs_tpu.train import losses as jax_losses
from mvs_tpu.train import metrics as jax_metrics
from mvs_tpu.train.tasks import MVSNetTask as JaxMVSNetTask
from mvs_tpu_torch.convert import flax_to_state_dict
from mvs_tpu_torch.io.dtu import DTUTrainDataset, collate_mvsnet
from mvs_tpu_torch.models.mvsnet import MVSNet
from mvs_tpu_torch.train import losses
from mvs_tpu_torch.train.tasks import MVSNetTask, batch_to_device
from mvs_tpu_torch.utils.make_synthetic_dtu import generate
from mvs_tpu_torch.utils.synthetic import make_plane_scene
from test_torch_blocks import perturb_batch_norm
from test_torch_train import (BF16_DRAWS, BF16_ROUNDING, F32_ROUNDING,
                              ROUNDING_FACTOR, _Float64Numpy,
                              _flax_grads_to_torch, _gradient_errors,
                              _nudged, _to_float64, check_bf16_step)

SIZE, VIEWS, DEPTHS = 64, 3, 8
CASES = {"smooth_l1": True, "ohem": False}  # loss name: refine
ZERO_GRADIENT = ("UNetCostRegNet_0.FoldedConv_0.bias",)


def _errors(seed, shape=(2, 9, 11), valid=0.6):
    rng = np.random.default_rng(seed)
    est = rng.uniform(400, 900, shape).astype(np.float32)
    gt = (est + rng.normal(0, 3, shape)).astype(np.float32)
    mask = (rng.uniform(0, 1, shape) < valid).astype(np.float32)
    return est, gt, mask


@pytest.mark.parametrize("seed,valid,topk", [
    (0, 0.6, 0.6), (1, 0.2, 0.6), (2, 1.0, 0.3),
    (3, 0.6, 1e-3),  # k = max(floor(topk * n_valid), 1) = 1
    (4, 0.0, 0.6),  # all masked: 0, and no gradient
])
def test_ohem_matches_jax(seed, valid, topk):
    est, gt, mask = _errors(seed, valid=valid)
    want, want_grad = jax.value_and_grad(
        lambda e: jax_losses.ohem_smooth_l1(e, gt, mask, topk))(
            jnp.asarray(est))
    t_est = torch.tensor(est, requires_grad=True)
    got = losses.ohem_smooth_l1(t_est, torch.tensor(gt), torch.tensor(mask),
                                topk)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(t_est.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-6, atol=1e-9)
    n_valid = int(mask.sum())
    k = max(int(np.floor(np.float32(topk) * np.float32(n_valid))), 1)
    selected = int((t_est.grad != 0).sum())
    assert selected == (min(k, n_valid) if n_valid else 0)
    if not n_valid:
        assert got.item() == 0.0


def test_ohem_is_mean_of_the_hardest_valid_errors():
    est, gt, mask = _errors(5)
    err = np.asarray(losses.smooth_l1(torch.tensor(est - gt)))[mask > 0.5]
    k = int(np.floor(np.float32(0.6) * np.float32(err.size)))
    want = np.sort(err)[::-1][:k].mean()
    got = losses.ohem_smooth_l1(torch.tensor(est), torch.tensor(gt),
                                torch.tensor(mask))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_collate_mvsnet_matches_jax(tmp_path):
    """The stored (1/4-resolution) intrinsics composed as they are; GT and
    mask at that resolution."""
    root = generate(tmp_path / "dtu", num_scans=1, num_views=4, height=32,
                    width=48, num_depth=16, num_lights=1, tilt=(0.05, 0.02))
    kw = dict(num_views=3, num_depth=16, interval_scale=1.06)
    ds = DTUTrainDataset(root, ["scan1"], **kw)
    jds = jax_dtu.DTUTrainDataset(root, ["scan1"], **kw)
    got = collate_mvsnet([ds[0], ds[3]])
    want = jax_dtu.collate_mvsnet([jds[0], jds[3]])
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
    assert got["depth_gt"].shape == got["mask"].shape == (2, 8, 12)
    assert got["proj_matrices"].shape == (2, 3, 4, 4)


def _train_batch():
    """2 plane scenes in the DTU training layout's form: intrinsics and GT
    at 1/4 of the images, a partial mask."""
    samples = []
    for seed in range(2):
        scene = make_plane_scene(num_views=VIEWS, height=SIZE, width=SIZE,
                                 z0=10.0, seed=seed, tilt=(0.05, 0.02))
        intr = scene.intrinsics.copy()
        intr[:, :2] /= 4.0
        gt = scene.depths[0][::4, ::4].astype(np.float32)
        samples.append(dict(
            imgs=scene.images, intrinsics=intr, extrinsics=scene.extrinsics,
            depth_values=np.linspace(8.0, 12.0, DEPTHS, dtype=np.float32),
            depth_gt=gt, mask=(gt < 10.1).astype(np.float32)))
    return collate_mvsnet(samples)


def _jax_step(dtype):
    """mvs_tpu's train step for both cases from one train-mode forward of
    MVSNet with RefineNet: smooth_l1 of refined_depth is
    MVSNetTask(loss_name="smooth_l1")'s loss of that model; ohem of depth is
    MVSNetTask(loss_name="ohem")'s loss of the model without RefineNet,
    whose depth, statistics and gradients it shares (RefineNet reads the
    depth and writes nothing back). Returns run(params, stats, batch) ->
    (losses, (new statistics, metrics), gradients), one per case."""
    task = JaxMVSNetTask(JaxMVSNet(refine=True, sampler="gather",
                                   compute_dtype=dtype))

    def forward(params, stats, b):
        out, new_stats = task.forward(params, stats, b, train=True)
        values = (jax_losses.masked_smooth_l1(out["refined_depth"],
                                              b["depth_gt"], b["mask"]),
                  jax_losses.ohem_smooth_l1(out["depth"], b["depth_gt"],
                                            b["mask"], task.ohem_topk))
        return values, (new_stats, jax_metrics.standard_metrics(
            out["depth"], b["depth_gt"], b["mask"]))

    def run(params, stats, b):
        values, vjp, aux = jax.vjp(lambda p: forward(p, stats, b), params,
                                   has_aux=True)
        one, zero = jnp.ones_like(values[0]), jnp.zeros_like(values[0])
        return values, aux, (vjp((one, zero))[0], vjp((zero, one))[0])

    return jax.jit(run)


def _case(tree: dict, refine: bool) -> dict:
    """A state_dict-like {name: tensor} without RefineNet's entries for the
    case without it."""
    return {k: v for k, v in tree.items()
            if refine or not k.startswith("RefineNet")}


def _port_step(state, batch, loss, refine, dtype=torch.float32):
    """Loss, metrics, gradients and state after one train-mode forward and
    backward of the port (in bf16 with f32 parameters and batch, as cli
    train's)."""
    store = torch.float32 if dtype == torch.bfloat16 else dtype
    model = MVSNet(refine=refine, compute_dtype=dtype).to(store)
    model.load_state_dict(_case(state, refine))
    model.train()
    tb = {k: v.to(store) for k, v in batch_to_device(batch, "cpu").items()}
    value, metrics = MVSNetTask(model, loss_name=loss).loss_and_metrics(tb)
    value.backward()
    return dict(loss=value.item(),
                metrics={k: float(v) for k, v in metrics.items()},
                grads={k: p.grad for k, p in model.named_parameters()},
                state={k: v.clone() for k, v in model.state_dict().items()})


@pytest.fixture(scope="module")
def steps():
    """For each loss: mvs_tpu's loss, metrics, f32 and float64 gradients
    and new statistics; the port's f32 and float64 step and how far one f32
    rounding of the images moves its gradients."""
    batch = _train_batch()
    jbatch = jax.tree.map(jnp.asarray, batch)
    init = JaxMVSNet(refine=True, sampler="gather")
    variables = jax.tree.map(np.asarray, perturb_batch_norm(
        jax.jit(init.init, static_argnames=("train",))(
            jax.random.key(0), jbatch["imgs"], jbatch["proj_matrices"],
            jbatch["depth_values"], train=False), 1))
    state = flax_to_state_dict(variables)
    values, (new_stats, metrics), grads = _jax_step(jnp.float32)(
        variables["params"], variables["batch_stats"], jbatch)
    jax_stats = flax_to_state_dict(jax.tree.map(np.asarray, {
        "params": variables["params"], "batch_stats": new_stats}))
    out = {}
    for i, (loss, refine) in enumerate(CASES.items()):
        moved = {}
        for seed in range(3):
            nudged = _nudged(batch, seed, F32_ROUNDING)
            for k, g in _port_step(state, nudged, loss, refine)[
                    "grads"].items():
                moved.setdefault(k, []).append(g)
        out[loss] = dict(
            port=_port_step(state, batch, loss, refine), moved=moved,
            jax_loss=float(values[i]),
            jax_metrics={k: float(x) for k, x in metrics.items()},
            jax_grads=flax_to_state_dict({"params": jax.tree.map(
                np.asarray, grads[i])}),
            jax_stats=_case(jax_stats, refine))

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
            *_, grads = _jax_step(jnp.float64)(
                v["params"], v["batch_stats"], _to_float64(batch))
            state64 = {k: t.double() for k, t in state.items()}
            for i, (loss, refine) in enumerate(CASES.items()):
                out[loss]["jax_grads64"] = _flax_grads_to_torch(
                    jax.tree.map(np.asarray, grads[i]))
                out[loss]["port64"] = _port_step(state64, batch, loss, refine,
                                                 torch.float64)
        finally:
            jax.config.update("jax_enable_x64", x64)
    out["variables"], out["state"] = variables, state
    return out


@pytest.fixture(scope="module")
def bf16_steps(steps):
    """For each loss, mvs_tpu's and the port's bf16 step (f32 parameters)
    from the same variables: losses and gradients on the batch and on
    BF16_DRAWS - 1 copies of it with the images moved by one bf16
    rounding; and the port's float64 gradients on those copies."""
    run = _jax_step(jnp.bfloat16)
    variables, state = steps["variables"], steps["state"]
    state64 = {k: t.double() for k, t in state.items()}
    out = {loss: {"port": [], "jax": [], "port_loss": [], "jax_loss": [],
                  "moved64": []} for loss in CASES}
    for seed in (None,) + tuple(range(BF16_DRAWS - 1)):
        batch = _nudged(_train_batch(), seed, BF16_ROUNDING)
        values, _, grads = run(variables["params"], variables["batch_stats"],
                               jax.tree.map(jnp.asarray, batch))
        for i, (loss, refine) in enumerate(CASES.items()):
            port = _port_step(state, batch, loss, refine, torch.bfloat16)
            case = out[loss]
            case["port"].append(port["grads"])
            case["port_loss"].append(port["loss"])
            case["jax"].append(_refine_free(flax_to_state_dict(
                {"params": jax.tree.map(np.asarray, grads[i])}), refine))
            case["jax_loss"].append(float(values[i]))
            if seed is not None:
                with pytest.MonkeyPatch.context() as mp:
                    mp.setattr(torch.Tensor, "float", lambda t: t if
                               t.dtype == torch.float64 else
                               t.to(torch.float32))
                    case["moved64"].append(_port_step(
                        state64, batch, loss, refine, torch.float64)["grads"])
    return out


def _refine_free(grads: dict, refine: bool) -> dict:
    """mvs_tpu's gradients of one case: without RefineNet's (all zero) for
    the case without it."""
    if not refine:
        assert all(float(g.abs().max()) == 0 for k, g in grads.items()
                   if k.startswith("RefineNet"))
    return _case(grads, refine)


@pytest.mark.parametrize("loss", list(CASES))
def test_train_step_loss_and_metrics(steps, loss):
    case = steps[loss]
    got, want = case["port"]["metrics"], case["jax_metrics"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(case["port"]["loss"], case["jax_loss"],
                               rtol=1e-5)
    assert 0 < case["jax_loss"] < 10


@pytest.mark.parametrize("loss", list(CASES))
def test_train_step_float64_gradients_agree(steps, loss):
    port = steps[loss]["port64"]["grads"]
    want = _refine_free(steps[loss]["jax_grads64"], CASES[loss])
    assert set(port) == set(want)
    assert ("RefineNet_0.ConvBlock_3.Conv_0.kernel" in want) == CASES[loss]
    top = max(float(w.abs().max()) for w in want.values())
    for k, (err, _, _) in _gradient_errors(port, want).items():
        if k in ZERO_GRADIENT:
            assert float(port[k].abs().max()) <= 1e-12 * top, k
        else:
            assert err <= 1e-9, (k, err)


@pytest.mark.parametrize("loss", list(CASES))
def test_train_step_gradients(steps, loss):
    case = steps[loss]
    got = case["port"]["grads"]
    exact = _refine_free(case["jax_grads64"], CASES[loss])
    f32 = _refine_free(case["jax_grads"], CASES[loss])
    assert set(got) == set(exact) == set(f32)
    beyond = {}
    for k, (err, _, _) in _gradient_errors(got, exact).items():
        if k in ZERO_GRADIENT:
            continue
        scale = float(exact[k].abs().max())
        moved = max(float((g - got[k]).abs().max()) for g in case["moved"][k])
        if err > 1e-3 and err > ROUNDING_FACTOR * moved / scale:
            beyond[k] = (err, moved / scale)
    assert beyond == {}
    for k, (_, cos, ratio) in _gradient_errors(got, f32).items():
        if k not in ZERO_GRADIENT:
            assert cos > 0.999 and abs(ratio - 1) < 1e-2, (k, cos, ratio)


@pytest.mark.parametrize("loss", list(CASES))
def test_bf16_train_step_against_mvs_tpus_bf16(steps, bf16_steps, loss):
    """The bf16 step against float64, each side's error held to the
    other's (module docstring)."""
    refine = CASES[loss]
    check_bf16_step(bf16_steps[loss],
                    _refine_free(steps[loss]["jax_grads64"], refine),
                    steps[loss]["port64"]["loss"],
                    {"port": steps[loss]["port"]["grads"],
                     "jax": _refine_free(steps[loss]["jax_grads"], refine)},
                    ZERO_GRADIENT)


@pytest.mark.parametrize("loss", list(CASES))
def test_train_step_batch_stats(steps, loss):
    want, got = steps[loss]["jax_stats"], steps[loss]["port"]["state"]
    stats = [k for k in want if k.rsplit(".", 1)[-1] in ("mean", "var",
                                                         "count")]
    assert len(stats) == 3 * (7 + 10 + 4 * CASES[loss])
    for k in stats:
        w = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
        if k.endswith("count"):
            assert float(got[k]) == 4.0


def test_unknown_loss_raises():
    """mvs_tpu raises once the model has run; the port before it runs."""
    with pytest.raises(ValueError, match="unknown loss 'l2'"):
        MVSNetTask(MVSNet(), loss_name="l2")
    jtask = JaxMVSNetTask(JaxMVSNet(), loss_name="l2")
    jtask.forward = lambda *a: ({"depth": jnp.zeros((1, 2, 2))}, None)
    with pytest.raises(ValueError, match="unknown loss 'l2'"):
        jtask.loss_and_metrics(None, None, {})
