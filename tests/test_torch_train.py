"""The port's training pieces against mvs_tpu's on the CPU in f32: losses,
metrics, schedules, the optimizer chain, one CasMVSNet train step, the DTU
training split and its collate, the loader's order, meters and checkpoint
retention.

Tolerances, with their reasons:
  * losses and metrics: rtol 1e-6 (the same f32 arithmetic);
  * schedules: rtol 1e-5 (optax evaluates them in f32, the port in f64);
  * optimizers over 10 steps at lr 0.01: rtol 1e-5, atol 1e-6 (each step
    rounds p - lr * u in f32, an ulp being 6e-8 at 0.5, and optax takes its
    bias corrections and schedule in f32, the port in f64);
  * the train step (32x32, 3 views, 8/8/8 hypotheses, batch 2, non-trivial
    BatchNorm with count 3, Adam 1e-3): loss and metrics rtol 1e-5; the new
    statistics within 1e-4 of each vector's largest magnitude; after the
    Adam step every parameter within 1e-6 where its gradient's sign is
    certain (|g| over twice the tensor's largest port vs JAX difference)
    and |g| > 1e-5 (eps = 1e-8 then moves the step by under lr * eps / |g|
    = 1e-6), and every update at most the learning rate (plus f32 rounding)
    elsewhere (Adam's first step is lr * g / (|g| + eps), whose sign
    follows the gradient's).
  * the gradients. In float64 (mvs_tpu's modules read jnp.float32 as
    float64, _Float64Numpy) the port's and mvs_tpu's gradients agree to
    1e-9 of each parameter's largest magnitude: the same function. In f32
    the backward pass through 30 BatchNorms amplifies rounding, parameter
    by parameter: one f32 rounding of the images (x * (1 +- 2^-24), three
    sign patterns) moves the port's f32 gradient of an early feature-net
    layer by ~1e-3 of its largest magnitude. So each of the port's f32
    gradients is held against mvs_tpu's float64 gradient within 1e-3 of
    its largest magnitude, or within 30x what that rounding moves it (the
    rule of chip_smoke.py's phase 7b; the port's worst is ~4.6x, with 70 of
    124 parameters within 1e-3 and a median of ~4.9e-5), and by direction
    (cosine > 0.999) and norm (1%) against jax.grad in f32. mvs_tpu's own
    f32 gradients fail that rule for ~24 parameters (median ~3.7e-3, up to
    ~1000x the rounding's move): its f32 BatchNorm moments take XLA's CPU
    reductions, which round coarser than torch's
    (test_train_step_gradient_accuracy prints both means of 24,576 values
    against float64).
  * the bf16 step (configs/cas_train_dtu.yaml's compute dtype, f32
    parameters) of both packages, held against the float64 gradients and
    loss. At this size the step's exact gradient is itself chaotic: the
    port's float64 gradient on the images moved by one bf16 rounding
    (x * (1 +- 2^-9)) lies a median ~0.62 of each parameter's largest
    magnitude from the batch's (stage 1's U-Net bottoms out at 1x1x1, so
    its deepest BatchNorms normalize two values), and each package's bf16
    gradients lie about as far (median ~0.66, the port's per-parameter
    ratio to mvs_tpu's 0.70-1.58). So each side's figures against float64
    (error over the largest magnitude, cosine, norm ratio) are averaged
    over BF16_DRAWS draws (the batch and two such moved copies), and each
    of the port's parameters must hold: its mean error at most twice
    mvs_tpu's (the rule of tests/test_torch_mvsnet.py's bf16 inference
    test) or under 0.05; and where mvs_tpu's own mean cosine is at least
    0.5 (79 of 124 parameters: stages 2 and 3, stage 1's upper levels and
    the feature net's output convs), its mean norm within a factor 1.5 of
    mvs_tpu's (0.94-1.20 here) and its mean cosine at most 0.5 under
    mvs_tpu's (-0.02 to +0.09 here). Zeroed or negated bf16 kernel
    gradients (_ConvToF32's backward) break that rule at the fused 3D
    blocks of stages 2 and 3. The loss: each draw within 0.1 relative of
    float64's (mvs_tpu's lie up to 7.7e-3 off here, and up to 8.3% in
    tests/test_torch_mvsnet_train.py), and the mean error at most twice
    mvs_tpu's or under 1e-2. A single extra bf16 rounding is below what
    this step can see: a conv's output rounded to bf16 before its
    BatchNorm moments (the fault that
    tests/test_torch_train_blocks.py::test_fused_conv_block_3d_train_bf16
    catches) passes it. The test prints each side's bf16 / f32 gradient
    norm per draw (SGD's update-norm ratio): 0.20-0.73 (port) and
    0.21-0.42 (mvs_tpu) here, the stage-1 gradients that chaos shrinks
    by up to 25x on either side, on different draws.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvs_tpu.cli.train import build_optimizer as jax_build_optimizer
from mvs_tpu.io import dtu as jax_dtu
from mvs_tpu.io.pipeline import DataLoader as JaxDataLoader
from mvs_tpu.models.cas_mvsnet import CasMVSNet as JaxCasMVSNet
from mvs_tpu.train import CascadeTask as JaxCascadeTask
from mvs_tpu.train import TrainState, make_train_step as jax_make_train_step
from mvs_tpu.train import losses as jax_losses
from mvs_tpu.train import metrics as jax_metrics
from mvs_tpu.train import schedule as jax_schedule
from mvs_tpu.utils.config import load_config as jax_load_config
from mvs_tpu.utils.meters import ScalarLogger as JaxScalarLogger
from mvs_tpu_torch import convert
from mvs_tpu_torch.cli.train import build_optimizer
from mvs_tpu_torch.convert import flax_to_state_dict
from mvs_tpu_torch.io.dtu import DTUTrainDataset, collate_cascade
from mvs_tpu_torch.io.pipeline import DataLoader
from mvs_tpu_torch.models.cas_mvsnet import CasMVSNet
from mvs_tpu_torch.train import losses, metrics, schedule
from mvs_tpu_torch.train.checkpoint import MAX_TO_KEEP, CheckpointManager
from mvs_tpu_torch.train.optim import OptaxChain
from mvs_tpu_torch.train.state import make_train_step
from mvs_tpu_torch.train.tasks import CascadeTask, batch_to_device
from mvs_tpu_torch.utils.config import load_config
from mvs_tpu_torch.utils.make_synthetic_dtu import generate
from mvs_tpu_torch.utils.meters import DictAverageMeter, ScalarLogger
from mvs_tpu_torch.utils.synthetic import make_plane_scene
from test_torch_train_blocks import random_variables


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _depths(seed, shape=(2, 6, 7)):
    rng = np.random.default_rng(seed)
    est = rng.uniform(400, 900, shape).astype(np.float32)
    gt = (est + rng.normal(0, 3, shape)).astype(np.float32)
    mask = (rng.uniform(0, 1, shape) > 0.3).astype(np.float32)
    return est, gt, mask


@pytest.mark.parametrize("beta", [1.0, 2.5])
def test_losses_match_jax(beta):
    est, gt, mask = _depths(0)
    np.testing.assert_allclose(
        losses.smooth_l1(_t(est - gt), beta).numpy(),
        np.asarray(jax_losses.smooth_l1(jnp.asarray(est - gt), beta)),
        rtol=1e-6)
    np.testing.assert_allclose(
        float(losses.masked_smooth_l1(_t(est), _t(gt), _t(mask), beta)),
        float(jax_losses.masked_smooth_l1(est, gt, mask, beta)), rtol=1e-6)
    stages = {f"stage{i}": _depths(i) for i in (1, 2, 3)}
    outs = {k: {"depth": _t(v[0])} for k, v in stages.items()}
    got = losses.cascade_loss(outs, {k: _t(v[1]) for k, v in stages.items()},
                              {k: _t(v[2]) for k, v in stages.items()})
    want = jax_losses.cascade_loss(
        {k: {"depth": jnp.asarray(v[0])} for k, v in stages.items()},
        {k: jnp.asarray(v[1]) for k, v in stages.items()},
        {k: jnp.asarray(v[2]) for k, v in stages.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)
    # An all-masked batch gives 0, not NaN.
    assert float(losses.masked_smooth_l1(_t(est), _t(gt), _t(0 * mask))) == 0


def test_metrics_match_jax():
    est, gt, mask = _depths(4)
    got = metrics.standard_metrics(_t(est), _t(gt), _t(mask), prefix="v/")
    want = jax_metrics.standard_metrics(est, gt, mask, prefix="v/")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)


@pytest.mark.parametrize("name", ["multistep", "warmup_multistep", "cosine",
                                  "poly", "poly_warmup"])
def test_schedules_match_optax(name):
    make = {
        "multistep": lambda m: m.multistep_lr(1e-3, [2, 5], 0.5, 3),
        "warmup_multistep": lambda m: m.warmup_multistep_lr(
            1e-3, [10, 14], 0.25, warmup_steps=8),
        "cosine": lambda m: m.warmup_cosine_lr(2e-3, 30, warmup_steps=6),
        "poly": lambda m: m.poly_lr(1e-3, 25, poly_exp=0.9),
        "poly_warmup": lambda m: m.poly_lr(1e-3, 25, 0.9, warmup_steps=5),
    }[name]
    got, want = make(schedule), make(jax_schedule)
    for step in range(32):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5,
                                   atol=1e-12, err_msg=f"step {step}")
    assert schedule.parse_milestones("10,12,14:2") == \
        jax_schedule.parse_milestones("10,12,14:2")
    assert schedule.parse_milestones("3,4") == ([3, 4], 0.5)


@pytest.mark.parametrize("optimizer,clip,decay,spec", [
    ("adam", 0.0, 0.0, "2,3:2"),
    ("adam", 0.5, 1e-2, "poly"),
    ("rmsprop", 0.0, 0.0, "cosine"),
    ("sgd", 1.0, 1e-3, "2,3:2"),
    ("radam", 0.0, 0.0, "2,3:2"),
])
def test_optimizer_chain_matches_optax(optimizer, clip, decay, spec):
    """build_optimizer of both CLIs from the same config, over 10 updates
    with the same gradients (the first ones large enough to clip)."""
    overrides = [f"train.optimizer={optimizer}", f"train.grad_clip={clip}",
                 f"train.weight_decay={decay}", f"train.lr_schedule={spec}",
                 "train.lr=0.01", "train.warmup_steps=3", "train.epochs=4"]
    rng = np.random.default_rng(1)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * (2.0 if i < 3 else 0.1)
                  ).astype(np.float32) for k, v in params.items()}
             for i in range(10)]
    tx = jax_build_optimizer(jax_load_config(None, overrides), 3)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    port = [torch.tensor(params[k]) for k in ("a", "b")]
    chain = build_optimizer(load_config(None, overrides), port, 3)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        chain.step([torch.tensor(g[k]) for k in ("a", "b")])
        for k, p in zip(("a", "b"), port):
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-6)
    assert chain.count == 10


def test_ranger_is_a_jax_fault_and_raises():
    """optax.lookahead over plain parameters (what mvs_tpu.cli.train passes
    it) raises in optax 0.2.6; the port's 'ranger' raises and says so."""
    tx = jax_build_optimizer(jax_load_config(None, ["train.optimizer=ranger"]),
                             3)
    params = {"w": jnp.ones(3)}
    with pytest.raises(AttributeError, match="fast"):
        tx.update(params, tx.init(params), params)
    with pytest.raises(NotImplementedError, match="lookahead"):
        build_optimizer(load_config(None, ["train.optimizer=ranger"]),
                        [torch.ones(3)], 3)


def _train_batch(size=32):
    """2 samples at 32x32, 3 views, in the DTU training layout's form."""
    samples = []
    for seed in range(2):
        scene = make_plane_scene(num_views=3, height=size, width=size, z0=10.0,
                                 seed=seed, tilt=(0.05, 0.02))
        intr = scene.intrinsics.copy()
        intr[:, :2] /= 4.0
        gt = scene.depths[0][::4, ::4].astype(np.float32)
        samples.append(dict(
            imgs=scene.images, intrinsics=intr, extrinsics=scene.extrinsics,
            depth_values=np.linspace(8.0, 12.0, 16, dtype=np.float32),
            depth_gt=gt, mask=(gt < 10.1).astype(np.float32)))
    return collate_cascade(samples)


@pytest.fixture(scope="module")
def train_step():
    """One Adam step of mvs_tpu's make_train_step and the port's, from the
    same variables and batch; JAX's gradients from the same program."""
    batch = _train_batch()
    jbatch = jax.tree.map(jnp.asarray, batch)
    jmodel = JaxCasMVSNet(ndepths=(8, 8, 8), sampler="gather")
    variables = random_variables(jmodel, jbatch["imgs"],
                                 jbatch["proj_matrices"],
                                 jbatch["depth_values"], seed=3)
    jtask = JaxCascadeTask(jmodel)
    state = TrainState.create(apply_fn=jmodel.apply,
                              params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              tx=optax.adam(1e-3))
    jstep = jax_make_train_step(jtask, donate=False)

    @jax.jit
    def run(st, b):
        grads = jax.grad(lambda p: jtask(p, st.batch_stats, b)[0])(st.params)
        return jstep(st, b), grads

    (new_state, jmetrics), jgrads = run(state, jbatch)

    class Recording(OptaxChain):
        def step(self, grads=None):
            self.grads = [g.clone() for g in grads]
            return super().step(grads)

    model = CasMVSNet(ndepths=(8, 8, 8))
    model.load_state_dict(flax_to_state_dict(variables))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = Recording(model.parameters(), "adam", lambda step: 1e-3)
    got = make_train_step(CascadeTask(model), opt)(
        batch_to_device(batch, "cpu"))
    names = [k for k, _ in model.named_parameters()]
    return dict(
        want_metrics={k: float(v) for k, v in jmetrics.items()},
        got_metrics={k: float(v) for k, v in got.items()},
        want_grads=flax_to_state_dict({"params": jax.tree.map(np.asarray,
                                                              jgrads)}),
        got_grads=dict(zip(names, opt.grads)),
        want_state=flax_to_state_dict(jax.tree.map(np.asarray, {
            "params": new_state.params,
            "batch_stats": new_state.batch_stats})),
        got_state=model.state_dict(), before=before, variables=variables)


def test_train_step_loss_and_metrics(train_step):
    want, got = train_step["want_metrics"], train_step["got_metrics"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert 0 < want["loss"] < 10


# The score convs' biases: the softmax over depth is invariant to a constant
# added to every score, so their exact gradient is 0 and both sides hold
# rounding residue (about 1e-8 of the model's largest gradient).
ZERO_GRADIENT = tuple(f"cost_reg_stage{i}.FoldedConv_0.bias" for i in (1, 2, 3))
# See the module docstring: the largest multiple of one rounding's move that
# a port f32 gradient's error against float64 may reach where it is over
# 1e-3 of its largest magnitude.
ROUNDING_FACTOR = 30.0


def _gradient_errors(got: dict, want: dict) -> dict:
    """{name: (largest error / largest magnitude, cosine, norm ratio)}."""
    out = {}
    for k, w in want.items():
        g, w = got[k].double().flatten(), w.double().flatten()
        out[k] = (float((g - w).abs().max() / w.abs().max()),
                  float(torch.nn.functional.cosine_similarity(g, w, dim=0)),
                  float(g.norm() / w.norm()))
    return out


class _Float64Numpy:
    """jax.numpy with float32 read as float64. mvs_tpu pins its BatchNorm
    moments, its convs' accumulation and the depth regression to
    jnp.float32; with this in its modules' place (and jax_enable_x64) its
    train step runs in float64 throughout."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _flax_grads_to_torch(grads) -> dict:
    """flax_to_state_dict's names and layouts for a params tree, keeping
    float64."""
    return {".".join(path): torch.from_numpy(np.ascontiguousarray(
        convert._kernel(path, v) if path[-1] == "kernel" else v))
        for path, v in convert._flatten(grads)}


def _to_float64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _port_float64_grads(state, batch):
    """The port's CasMVSNet train-step loss and gradients in float64."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "float", lambda t: t if t.dtype ==
                   torch.float64 else t.to(torch.float32))
        model = CasMVSNet(ndepths=(8, 8, 8), compute_dtype=torch.float64)
        model.load_state_dict(state)
        model.double().train()
        tb = batch_to_device(batch, "cpu")
        tb = {k: {s: t.double() for s, t in v.items()} if isinstance(v, dict)
              else v.double() for k, v in tb.items()}
        loss, _ = CascadeTask(model).loss_and_metrics(tb)
        loss.backward()
    return loss.item(), {k: p.grad for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def float64_grads(train_step):
    """The train step's gradients in float64: mvs_tpu's (jax.grad) and the
    port's (autograd), from the same variables and batch."""
    batch = _train_batch()
    loss, port = _port_float64_grads(train_step["before"], batch)
    with pytest.MonkeyPatch.context() as mp:
        numpy64 = _Float64Numpy()
        for name, module in list(sys.modules.items()):
            if name.split(".")[0] == "mvs_tpu" and \
                    getattr(module, "jnp", None) is jnp:
                mp.setattr(module, "jnp", numpy64)
        x64 = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)
        try:
            jtask = JaxCascadeTask(JaxCasMVSNet(
                ndepths=(8, 8, 8), sampler="gather",
                compute_dtype=jnp.float64))
            variables = _to_float64(train_step["variables"])
            jloss, jgrads = jax.jit(jax.value_and_grad(
                lambda p, b: jtask(p, variables["batch_stats"], b)[0]))(
                    variables["params"], _to_float64(batch))
            assert jgrads["cost_reg_stage3"]["FoldedConv_0"][
                "kernel"].dtype == jnp.float64
            jgrads = jax.tree.map(np.asarray, jgrads)
        finally:
            jax.config.update("jax_enable_x64", x64)
    return dict(port=port, jax=_flax_grads_to_torch(jgrads),
                port_loss=loss, jax_loss=float(jloss))


def test_train_step_float64_gradients_agree(float64_grads):
    """The port and mvs_tpu compute the same gradient: in float64 every
    parameter's agrees to 1e-9 of its largest magnitude."""
    port, want = float64_grads["port"], float64_grads["jax"]
    assert set(port) == set(want)
    np.testing.assert_allclose(float64_grads["port_loss"],
                               float64_grads["jax_loss"], rtol=1e-12)
    top = max(float(w.abs().max()) for w in want.values())
    for k, (err, _, _) in _gradient_errors(port, want).items():
        if k in ZERO_GRADIENT:
            assert float(port[k].abs().max()) <= 1e-12 * top, k
        else:
            assert err <= 1e-9, (k, err)


# One relative rounding of f32 and of bf16.
F32_ROUNDING, BF16_ROUNDING = 2.0 ** -24, 2.0 ** -9


def _nudged(batch, seed, rel):
    """The batch with its images moved by one relative rounding `rel`,
    x * (1 +- rel) with random signs from `seed` (seed None: the batch
    itself)."""
    if seed is None:
        return batch
    sign = np.random.default_rng(seed).choice([-1.0, 1.0],
                                              size=batch["imgs"].shape)
    return dict(batch, imgs=(batch["imgs"] * (1 + sign * rel)).astype(
        np.float32))


@pytest.fixture(scope="module")
def rounding_moves(train_step, float64_grads):
    """{name: how far one f32 rounding of the images (x * (1 +- 2^-24),
    three sign patterns) moves the port's f32 gradient, largest element
    over the f64 gradient's largest magnitude}: the f32 step's own noise
    floor, which the BatchNorms amplify parameter by parameter."""
    moved = {}
    for seed in range(3):
        model = CasMVSNet(ndepths=(8, 8, 8))
        model.load_state_dict(train_step["before"])
        model.train()
        batch = _nudged(_train_batch(), seed, F32_ROUNDING)
        loss, _ = CascadeTask(model).loss_and_metrics(
            batch_to_device(batch, "cpu"))
        loss.backward()
        for k, p in model.named_parameters():
            d = float((p.grad - train_step["got_grads"][k]).abs().max()
                      / float64_grads["jax"][k].abs().max())
            moved[k] = max(moved.get(k, 0.0), d)
    return moved


def _beyond_rounding(grads: dict, exact: dict, moved: dict) -> dict:
    """{name: (error, moved)} of the f32 gradients whose largest error
    against `exact` (over its largest magnitude) is over 1e-3 and over
    ROUNDING_FACTOR times what one rounding of the images moves them."""
    out = {}
    for k, (err, _, _) in _gradient_errors(grads, exact).items():
        if k not in ZERO_GRADIENT and err > 1e-3 and \
                err > ROUNDING_FACTOR * moved[k]:
            out[k] = (err, moved[k])
    return out


def test_train_step_gradients(train_step, float64_grads, rounding_moves):
    """Every f32 gradient of the port against mvs_tpu's float64 gradient:
    within 1e-3 of its largest magnitude, or within ROUNDING_FACTOR times
    its own f32 noise floor; and pointing as jax.grad's f32 one does."""
    got, exact = train_step["got_grads"], float64_grads["jax"]
    assert set(got) == set(exact) and len(exact) > 100
    top = max(float(w.abs().max()) for w in exact.values())
    for k in ZERO_GRADIENT:
        assert float(got[k].abs().max()) <= 1e-6 * top
        assert float(train_step["want_grads"][k].abs().max()) <= 1e-6 * top
    assert _beyond_rounding(got, exact, rounding_moves) == {}
    for k, (_, cos, ratio) in _gradient_errors(
            got, train_step["want_grads"]).items():
        if k not in ZERO_GRADIENT:
            assert cos > 0.999 and abs(ratio - 1) < 1e-2, (k, cos, ratio)


def test_train_step_gradient_accuracy(train_step, float64_grads,
                                      rounding_moves):
    """The same rule fails mvs_tpu's own f32 gradients: XLA's CPU
    reductions round its BatchNorm moments coarser than torch's (the
    printed means of 24,576 values), which moves its cost-regularization
    gradients far beyond what one rounding of the images does."""
    exact = {k: v for k, v in float64_grads["jax"].items()
             if k not in ZERO_GRADIENT}
    port = _gradient_errors(train_step["got_grads"], exact)
    ref = _gradient_errors(train_step["want_grads"], exact)
    beyond = _beyond_rounding(train_step["want_grads"], exact,
                              rounding_moves)
    print(f"largest error / largest magnitude against the f64 gradient, "
          f"worst / median over {len(exact)} parameters: port f32 "
          f"{max(e[0] for e in port.values()):.2e} / "
          f"{np.median([e[0] for e in port.values()]):.2e} "
          f"({sum(e[0] <= 1e-3 for e in port.values())} within 1e-3, worst "
          f"{max(e[0] / rounding_moves[k] for k, e in port.items()):.1f}x "
          f"one rounding's move), mvs_tpu f32 "
          f"{max(e[0] for e in ref.values()):.2e} / "
          f"{np.median([e[0] for e in ref.values()]):.2e} "
          f"({sum(e[0] <= 1e-3 for e in ref.values())} within 1e-3, "
          f"{len(beyond)} beyond {ROUNDING_FACTOR}x one rounding's move)")
    x = np.random.default_rng(0).uniform(1, 2, (6, 64, 64, 8)).astype(
        np.float32)
    mean = x.astype(np.float64).mean((0, 1, 2))
    print("relative error of a mean over 24,576 f32 values: torch",
          np.abs(torch.tensor(x).mean((0, 1, 2)).numpy() - mean).max()
          / mean.max(), "jax", np.abs(np.asarray(
              jnp.mean(jnp.asarray(x), axis=(0, 1, 2))) - mean).max()
          / mean.max())
    assert np.median([e[0] for e in port.values()]) < 1e-4
    assert len(beyond) > 10


def test_train_step_batch_stats(train_step):
    want, got = train_step["want_state"], train_step["got_state"]
    stats = [k for k in want if k.rsplit(".", 1)[-1] in ("mean", "var",
                                                         "count")]
    assert len(stats) > 60
    for k in stats:
        w = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
        if k.endswith("count"):
            assert float(got[k]) == 4.0


def test_train_step_adam_update(train_step):
    want, got, before = (train_step[k] for k in ("want_state", "got_state",
                                                 "before"))
    for k, grad in train_step["want_grads"].items():
        g = grad.numpy()
        spread = np.abs(train_step["got_grads"][k].numpy() - g).max()
        certain = (np.abs(g) > 2 * spread) & (np.abs(g) > 1e-5)
        delta = got[k].numpy() - before[k].numpy()
        np.testing.assert_allclose(got[k].numpy()[certain],
                                   want[k].numpy()[certain], rtol=0,
                                   atol=1e-6, err_msg=k)
        assert np.abs(delta).max() <= 1.001e-3, k


# The bf16 step (module docstring): draws over which each side's figures
# are averaged; a parameter's mean error: factor and floor; mvs_tpu's mean
# cosine from which a parameter's direction counts as held; there, its
# mean gradient norm against mvs_tpu's: factor, and its mean cosine:
# margin under mvs_tpu's; the loss's relative error: floor and limit.
BF16_DRAWS, BF16_FACTOR, BF16_FLOOR = 3, 2.0, 0.05
BF16_HELD, BF16_NORM_FACTOR, BF16_COS_MARGIN = 0.5, 1.5, 0.5
BF16_LOSS_FLOOR, BF16_LOSS_RTOL = 1e-2, 0.1


@pytest.fixture(scope="module")
def bf16_grads(train_step):
    """The train step's gradients in bf16 (configs/cas_train_dtu.yaml's
    compute dtype, f32 parameters), mvs_tpu's (jax.grad) and the port's
    (autograd), from the same variables, on the batch and on BF16_DRAWS - 1
    copies of it with the images moved by one bf16 rounding; and the
    port's float64 gradients on those copies."""
    jtask = JaxCascadeTask(JaxCasMVSNet(ndepths=(8, 8, 8), sampler="gather",
                                        compute_dtype=jnp.bfloat16))
    variables = train_step["variables"]
    jfn = jax.jit(jax.value_and_grad(
        lambda p, b: jtask(p, variables["batch_stats"], b)[0]))
    out = {"port": [], "jax": [], "port_loss": [], "jax_loss": [],
           "moved64": []}
    for seed in (None,) + tuple(range(BF16_DRAWS - 1)):
        batch = _nudged(_train_batch(), seed, BF16_ROUNDING)
        jloss, jgrads = jfn(variables["params"],
                            jax.tree.map(jnp.asarray, batch))
        model = CasMVSNet(ndepths=(8, 8, 8), compute_dtype=torch.bfloat16)
        model.load_state_dict(train_step["before"])
        model.train()
        loss, _ = CascadeTask(model).loss_and_metrics(
            batch_to_device(batch, "cpu"))
        loss.backward()
        out["port"].append({k: p.grad for k, p in model.named_parameters()})
        out["jax"].append(flax_to_state_dict(
            {"params": jax.tree.map(np.asarray, jgrads)}))
        out["port_loss"].append(loss.item())
        out["jax_loss"].append(float(jloss))
        if seed is not None:
            out["moved64"].append(_port_float64_grads(train_step["before"],
                                                      batch)[1])
    return out


def bf16_figures(got: dict, exact: dict, keys) -> dict:
    """{side: {name: (error, cosine, norm ratio)}}: each side's bf16
    gradients against the float64 ones (_gradient_errors), each figure
    averaged over the draws."""
    return {side: {k: tuple(np.mean([_gradient_errors(
        {k: g[k]}, {k: exact[k]})[k] for g in got[side]], axis=0))
        for k in keys} for side in ("port", "jax")}


def bf16_departures(fig: dict) -> dict:
    """{name: (port's, mvs_tpu's)} of the parameters whose figures break
    the bf16 rule (module docstring): the mean error over twice mvs_tpu's
    and over the floor; or, where mvs_tpu's mean cosine is at least
    BF16_HELD, the mean norm outside a factor 1.5 of mvs_tpu's or the mean
    cosine more than 0.5 under mvs_tpu's."""
    out = {}
    for k, (err, cos, norm) in fig["port"].items():
        jerr, jcos, jnorm = fig["jax"][k]
        held = jcos >= BF16_HELD
        if err > max(BF16_FACTOR * jerr, BF16_FLOOR) or held and (
                not 1 / BF16_NORM_FACTOR <= norm / jnorm <= BF16_NORM_FACTOR
                or cos < jcos - BF16_COS_MARGIN):
            out[k] = (fig["port"][k], fig["jax"][k])
    return out


def check_bf16_step(got: dict, exact: dict, exact_loss: float,
                    f32: dict, zero=()) -> None:
    """The bf16 rule of the module docstring for one train step: `got`
    {"port" / "jax": [gradients per draw], "port_loss" / "jax_loss":
    [loss per draw], "moved64": [the float64 gradients on the moved
    copies]}, against the float64 gradients `exact` and loss; `f32`
    {"port" / "jax": f32 gradients} for the printed update-norm ratios
    (SGD's update is -lr x the gradient)."""
    keys = [k for k in exact if k not in zero]
    fig = bf16_figures(got, exact, keys)
    beyond = bf16_departures(fig)
    moved = bf16_figures({"port": got["moved64"], "jax": got["moved64"]},
                         exact, keys)["port"]
    loss = {side: [abs(x / exact_loss - 1) for x in got[side + "_loss"]]
            for side in ("port", "jax")}

    def norm(g):
        return float(torch.sqrt(sum((g[k].double() ** 2).sum()
                                    for k in keys)))

    def spread(figures, i):
        v = np.array([f[i] for f in figures.values()])
        return (f"median {np.median(v):.3f} [{v.min():.3f}, "
                f"{v.max():.3f}]")

    held = [k for k in keys if fig["jax"][k][1] >= BF16_HELD]

    def against_jax(i, names):
        v = np.array([fig["port"][k][i] - fig["jax"][k][i] if i == 1 else
                      fig["port"][k][i] / fig["jax"][k][i] for k in names])
        return f"median {np.median(v):.3f} [{v.min():.3f}, {v.max():.3f}]"

    ratios = {side: [norm(g) / norm(f32[side]) for g in got[side]]
              for side in ("port", "jax")}
    print(f"bf16 step over {len(got['port'])} draws, {len(keys)} "
          f"parameters, each figure against float64 averaged over the draws;"
          f" error / largest magnitude: port {spread(fig['port'], 0)}, "
          f"mvs_tpu {spread(fig['jax'], 0)}, the float64 gradient on the "
          f"images moved by one bf16 rounding {spread(moved, 0)}; cosine: "
          f"port {spread(fig['port'], 1)}, mvs_tpu {spread(fig['jax'], 1)}, "
          f"moved float64 {spread(moved, 1)}; port / mvs_tpu: error "
          f"{against_jax(0, keys)}; on the {len(held)} parameters where "
          f"mvs_tpu's mean cosine is at least {BF16_HELD}, norm "
          f"{against_jax(2, held)}, cosine difference "
          f"{against_jax(1, held)}; loss relative errors port "
          + " ".join(f"{x:.2e}" for x in loss["port"]) + ", mvs_tpu "
          + " ".join(f"{x:.2e}" for x in loss["jax"])
          + "; bf16 / f32 gradient norm per draw: port "
          + " ".join(f"{x:.4f}" for x in ratios["port"]) + ", mvs_tpu "
          + " ".join(f"{x:.4f}" for x in ratios["jax"]))
    assert beyond == {}
    assert np.mean(loss["port"]) <= max(BF16_FACTOR * np.mean(loss["jax"]),
                                        BF16_LOSS_FLOOR)
    assert max(loss["port"]) < BF16_LOSS_RTOL


def test_bf16_train_step_against_mvs_tpus_bf16(train_step, float64_grads,
                                               bf16_grads):
    """The bf16 step (configs/cas_train_dtu.yaml's dtype) against float64,
    each side's error held to the other's (module docstring)."""
    check_bf16_step(bf16_grads, float64_grads["jax"],
                    float64_grads["jax_loss"],
                    {"port": train_step["got_grads"],
                     "jax": train_step["want_grads"]}, ZERO_GRADIENT)


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    return generate(tmp_path_factory.mktemp("dtu") / "dtu", num_scans=2,
                    num_views=4, height=32, width=48, num_depth=16,
                    num_lights=2, tilt=(0.05, 0.02))


def test_dtu_train_dataset_and_collate_match_jax(train_root):
    kw = dict(num_views=3, num_depth=16, interval_scale=1.06)
    ds = DTUTrainDataset(train_root, ["scan1", "scan2"], **kw)
    jds = jax_dtu.DTUTrainDataset(train_root, ["scan1", "scan2"], **kw)
    assert len(ds) == len(jds) == 2 * 2 * 4 and ds.metas == jds.metas
    samples, jsamples = [], []
    for i in (0, 5, 13):
        got, want = ds[i], jds[i]
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray) or np.isscalar(v) and not \
                    isinstance(v, str):
                np.testing.assert_allclose(np.asarray(got[k]), v, rtol=1e-6,
                                           err_msg=k)
            else:
                assert got[k] == v, k
        samples.append(got)
        jsamples.append(want)
    got, want = collate_cascade(samples), jax_dtu.collate_cascade(jsamples)
    for key in ("proj_matrices", "depth_gt", "mask"):
        for stage in ("stage1", "stage2", "stage3"):
            np.testing.assert_array_equal(got[key][stage], want[key][stage])
    np.testing.assert_array_equal(got["imgs"], want["imgs"])
    assert got["depth_gt"]["stage3"].shape == (3, 32, 48)


@pytest.mark.parametrize("factor,shape", [(2, (5, 7)), (4, (6, 3))])
def test_repeat_is_cv2_nearest_at_integer_factors(factor, shape):
    import cv2

    a = np.random.default_rng(factor).uniform(0, 9, shape).astype(np.float32)
    want = cv2.resize(a, (shape[1] * factor, shape[0] * factor),
                      interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(
        a.repeat(factor, axis=0).repeat(factor, axis=1), want)


class _Items:
    """Items are their index; `bad` ones fail to load."""

    def __init__(self, bad=()):
        self.bad = bad

    def __len__(self):
        return 11

    def __getitem__(self, i):
        if i in self.bad:
            raise OSError("unreadable")
        return i


def _collate(items):
    return {"idx": np.asarray(items)}


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_order_matches_jax(shuffle):
    kw = dict(shuffle=shuffle, seed=5, num_threads=3)
    port = DataLoader(_Items(), 3, _collate, **kw)
    ref = JaxDataLoader(_Items(), 3, _collate, **kw)
    assert len(port) == len(ref) == 3  # drop_last
    for _ in range(2):  # epoch e shuffles with seed + e
        got = [b["idx"].tolist() for b in port]
        assert got == [b["idx"].tolist() for b in ref]
        assert len(set(sum(got, []))) == 9


def test_loader_replaces_unreadable_samples():
    got = sum((b["idx"].tolist() for b in DataLoader(
        _Items(bad=(3,)), 3, _collate, shuffle=False)), [])
    assert len(got) == 9 and 3 not in got
    assert got[:3] + got[4:] == [0, 1, 2, 4, 5, 6, 7, 8]
    with pytest.raises(OSError):  # every replacement fails too
        list(DataLoader(_Items(bad=range(11)), 3, _collate, shuffle=False))


def test_meters_match_jax(tmp_path):
    meter = DictAverageMeter()
    meter.update({"a": 1.0, "b": 2.0})
    meter.update({"a": 3.0, "b": 6.0}, n=3)
    assert meter.mean() == {"a": 2.5, "b": 5.0}
    port = ScalarLogger(tmp_path / "port", use_tensorboard=False)
    ref = JaxScalarLogger(tmp_path / "jax", use_tensorboard=False)
    for logger in (port, ref):
        logger.log(7, {"loss": 0.5, "x": 2}, prefix="train/")
        logger.close()
    import json
    got, want = (json.loads((tmp_path / d / "scalars.jsonl").read_text())
                 for d in ("port", "jax"))
    assert {k: v for k, v in got.items() if k != "time"} == \
        {k: v for k, v in want.items() if k != "time"}


def test_checkpoint_keeps_best_and_latest(tmp_path):
    ckpt = CheckpointManager(tmp_path, best_metric="abs_depth_error")
    assert ckpt.best_step() is None and ckpt.restore() is None
    errors = {1: 0.5, 2: 0.2, 3: 0.3, 4: 0.9, 5: 0.8, 6: 0.1, 7: 0.4,
              8: 0.7}
    for step, err in errors.items():
        ckpt.save(step, {"model": {"w": torch.full((2,), float(step))}},
                  metrics={"abs_depth_error": err})
    # The best MAX_TO_KEEP (6, 2, 3, 7, 1) and the latest (8), which is not.
    assert MAX_TO_KEEP == 5 and ckpt.steps() == [1, 2, 3, 6, 7, 8]
    assert ckpt.best_step() == 6 and ckpt.latest_step() == 8
    assert float(ckpt.restore("best")["model"]["w"][0]) == 6.0
    assert ckpt.restore("latest")["metrics"] == {"abs_depth_error": 0.7}
    assert ckpt.restore(3)["step"] == 3
    with pytest.raises(FileNotFoundError):
        ckpt.restore(4)
    assert len(list(tmp_path.glob("*.pt"))) == 6


def test_checkpoint_unranked_saves(tmp_path):
    """Saves without metrics stay unranked: best_step is None (and 'best'
    resolves to the latest); without a best metric, recency keeps
    MAX_TO_KEEP."""
    ckpt = CheckpointManager(tmp_path / "a", best_metric="abs_depth_error")
    for step in range(1, 8):
        ckpt.save(step, {"x": torch.zeros(1)})
    assert ckpt.best_step() is None and ckpt.resolve("best") == 7
    assert ckpt.steps() == [3, 4, 5, 6, 7]
    ckpt.save(8, {"x": torch.zeros(1)}, metrics={"abs_depth_error": 1.0})
    ckpt.save(9, {"x": torch.zeros(1)})
    assert ckpt.best_step() == 8 and ckpt.steps() == [4, 5, 6, 7, 8, 9]
    plain = CheckpointManager(tmp_path / "b")
    for step in range(1, 8):
        plain.save(step, {"x": torch.zeros(1)}, metrics={"loss": 1.0 / step})
    assert plain.steps() == [3, 4, 5, 6, 7] and plain.best_step() is None
