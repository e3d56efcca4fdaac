"""Train mode of the port's blocks and the warp's gradient, against mvs_tpu
on the CPU in f32.

Blocks: the Flax module's apply(train=True, mutable=["batch_stats"]) and
jax.grad of sum(out * w) for a random w, against module.train() and
autograd in the port, from the same variables (convert.flax_to_state_dict,
non-trivial BatchNorm, count 0 or 3): outputs at rtol/atol 2e-4 (f32 convs
summed in another order, as tests/test_torch_blocks.py), each gradient
within 1e-4 of its largest magnitude (the same sums, once more through the
transposed convs and the batch moments), and the debiased statistics and
count after two updates at rtol 1e-5 / atol 1e-6 (the port updates the
debiased form, JAX the zero-started accumulator it divides when read).

Warp: dref / dsrc of ops.warp_variance.fused_variance_volume (on the CPU,
autograd through the plain gather path) and of fused_variance_volume_grad
against jax.grad of mvs_tpu's variance_cost_volume(sampler="gather"), at
1e-5 of the largest magnitude (f32 scatter-adds in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_tpu.nn import blocks as jblocks
from mvs_tpu.ops.cost_volume import variance_cost_volume as jax_variance
from mvs_tpu_torch.convert import flax_to_state_dict
from mvs_tpu_torch.nn import blocks
from mvs_tpu_torch.ops.warp_variance import (fused_variance_volume,
                                             fused_variance_volume_grad)
from test_torch_blocks import perturb_batch_norm

GRAD_TOL = 1e-4


def random_variables(module, *args, seed=0, count=3.0):
    """Variables of `module` (shapes by jax.eval_shape, no compile): kernels
    N(0, 1/fan_in), then perturb_batch_norm's BatchNorm with `count`; at
    count 0 the accumulators are zero, as Flax's init leaves them."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args,
                                                train=False))
    rng = np.random.default_rng(seed)
    variables = jax.tree.map(
        lambda s: (rng.normal(0.0, 1.0, s.shape) / np.sqrt(
            np.prod(s.shape[:-1]))).astype(np.float32)
        if len(s.shape) > 1 else np.zeros(s.shape, np.float32), shapes)
    variables = perturb_batch_norm(variables, seed + 1)
    def stat(path, x):
        if path[-1].key == "count":
            return np.full_like(x, count)
        if count == 0 and path[0].key == "batch_stats":
            return np.zeros_like(x)
        return x

    return jax.tree_util.tree_map_with_path(stat, variables)


def run_jax(module, variables, x, w, x2, dtype=jnp.float32):
    """(out, param grads, input grad, stats after updates on x then x2), for
    x and x2 cast to `dtype`; out and the input grad as f32."""
    def loss(params, xin):
        y, upd = module.apply({"params": params,
                               "batch_stats": variables["batch_stats"]},
                              xin, train=True, mutable=["batch_stats"])
        return jnp.sum(y * w), (y, upd["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x, dtype))
    _, upd = module.apply({"params": variables["params"],
                           "batch_stats": stats}, jnp.asarray(x2, dtype),
                          train=True, mutable=["batch_stats"])
    assert y.dtype == gx.dtype == dtype
    return (np.asarray(y, np.float32), jax.tree.map(np.asarray, gp),
            np.asarray(gx, np.float32),
            jax.tree.map(np.asarray, upd["batch_stats"]))


def run_port(port, variables, x, w, x2, dtype=torch.float32):
    port.load_state_dict(flax_to_state_dict(variables))
    port.train()
    xt = torch.tensor(x).to(dtype).requires_grad_()
    y = port(xt)
    (y * torch.tensor(w)).sum().backward()
    with torch.no_grad():
        port(torch.tensor(x2).to(dtype))
    grads = {k: p.grad for k, p in port.named_parameters()}
    assert y.dtype == xt.grad.dtype == dtype
    return (y.detach().float().numpy(), grads, xt.grad.float().numpy(),
            port.state_dict())


def close_in_max(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-12), (what, err)


def check_block(jmodule, port, x_shape, out_ch, seed, count):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32)
    x2 = (rng.standard_normal(x_shape) * 2 + 0.5).astype(np.float32)
    variables = random_variables(jmodule, jnp.asarray(x), seed=seed,
                                 count=count)
    y_shape = jax.eval_shape(lambda: jmodule.apply(
        variables, jnp.asarray(x), train=True,
        mutable=["batch_stats"]))[0].shape
    w = rng.standard_normal(y_shape).astype(np.float32)
    y, gp, gx, stats = run_jax(jmodule, variables, x, w, x2)
    got_y, got_g, got_gx, got_state = run_port(port, variables, x, w, x2)
    assert y.shape[-1] == out_ch
    np.testing.assert_allclose(got_y, y, rtol=2e-4, atol=2e-4)
    close_in_max(got_gx, gx, GRAD_TOL, "input grad")
    want_g = flax_to_state_dict({"params": gp})
    assert set(got_g) == set(want_g)
    for k, g in want_g.items():
        close_in_max(got_g[k].numpy(), g.numpy(), GRAD_TOL, k)
    want_stats = flax_to_state_dict({"batch_stats": stats})
    for k, v in want_stats.items():
        np.testing.assert_allclose(got_state[k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(got_state[next(k for k in want_stats
                                if k.endswith("count"))]) == count + 2


@pytest.mark.parametrize("count", [0.0, 3.0])
def test_norm_train(count):
    check_block(jblocks.Norm(), blocks.Norm(8), (2, 5, 6, 8), 8, 10, count)


@pytest.mark.parametrize("rank,kernel,stride,shape", [
    (2, 3, 1, (2, 9, 11, 8)),     # feature net stride-1 conv
    (2, 5, 2, (2, 12, 16, 8)),    # feature net downsampling conv
    (3, 3, 2, (2, 4, 6, 8, 8)),   # cost-reg downsampling conv
])
def test_conv_block_train(rank, kernel, stride, shape):
    ks = (kernel,) * rank
    check_block(jblocks.ConvBlock(16, ks, strides=stride),
                blocks.ConvBlock(8, 16, ks, stride=stride), shape, 16,
                20 + rank, 3.0)


def test_conv_transpose_block_train():
    check_block(jblocks.ConvTransposeBlock(8, (3, 3, 3), strides=2),
                blocks.ConvTransposeBlock(16, 8), (2, 3, 4, 5, 16), 8, 30,
                3.0)


def test_stride1_conv_transpose_block_train():
    """PyramidCostRegNet's channel-halving block: flax's stride-1 SAME
    transposed conv, through torch's conv_transpose over the stored
    (flipped) kernel."""
    check_block(jblocks.ConvTransposeBlock(8, (3, 3, 3), strides=1),
                blocks.ConvTransposeBlock(16, 8, stride=1), (2, 3, 4, 5, 16),
                8, 31, 3.0)


@pytest.mark.parametrize("relu,count", [(True, 3.0), (False, 0.0)])
def test_fused_conv_block_3d_train(relu, count):
    check_block(jblocks.FusedConvBlock3D(8, relu=relu),
                blocks.FusedConvBlock3D(8, 8, relu=relu), (2, 4, 6, 7, 8), 8,
                40, count)


def test_fused_conv_block_3d_train_bf16():
    """bf16 compute, as configs/cas_train_dtu.yaml trains: the conv's result
    stays f32 into the batch moments (JAX's conv_folded(out_dtype=f32)).
    A conv rounded to bf16 first moves the statistics by ~2e-4 and the
    scale's and kernel's gradients by ~3e-3 of their largest magnitude at
    this shape; an f32 result agrees with JAX's to f32 rounding (~6e-7)
    and the bf16 output and input gradient bit for bit, up to a rounding
    flip of one bf16 ulp (2^-8 of the value) where the two f32 sums straddle
    a bf16 boundary."""
    rng = np.random.default_rng(40)
    shape = (2, 4, 6, 7, 8)
    x = rng.standard_normal(shape).astype(np.float32)
    x2 = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    jmodule = jblocks.FusedConvBlock3D(8)
    variables = random_variables(jmodule, jnp.asarray(x), seed=40, count=3.0)
    y, gp, gx, stats = run_jax(jmodule, variables, x, w, x2, jnp.bfloat16)
    got_y, got_g, got_gx, got_state = run_port(
        blocks.FusedConvBlock3D(8, 8), variables, x, w, x2, torch.bfloat16)
    for got, want in ((got_y, y), (got_gx, gx)):
        assert np.mean(got == want) > 0.99
        np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=0)
    want_g = flax_to_state_dict({"params": gp})
    for k, g in want_g.items():
        close_in_max(got_g[k].numpy(), g.numpy(), 2.0 ** -9, k)
    for k, v in flax_to_state_dict({"batch_stats": stats}).items():
        close_in_max(got_state[k].numpy().reshape(v.shape), v.numpy(), 1e-5,
                     k)


def test_score_conv_trains_through_torch():
    """The biased 3x3x3 score conv: in train mode it is differentiable in
    its kernel and bias (torch's conv, not the fused kernel)."""
    conv = blocks.Conv(8, 1, (3, 3, 3))
    blocks.init_random_(conv, torch.Generator().manual_seed(0))
    conv.train()
    conv(torch.randn(1, 4, 5, 6, 8)).sum().backward()
    assert conv.kernel.grad.abs().sum() > 0 and conv.bias.grad.abs().sum() > 0


def test_stats_without_count_load_as_converged():
    """A state_dict written before the statistics had a count loads with a
    large count: the next update weighs the old statistics by the momentum."""
    norm = blocks.Norm(4)
    state = {k: v for k, v in norm.state_dict().items() if k != "count"}
    state["mean"] = torch.full((4,), 2.0)
    norm.load_state_dict(state)
    assert float(norm.count) == 1.0e4
    norm.train()
    norm(torch.zeros(3, 4))
    np.testing.assert_allclose(norm.mean.numpy(), 0.9 * 2.0, rtol=1e-6)


def _warp_inputs(seed, b=2, v=3, d=5, h=9, w=11, c=8):
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((b, h, w, c)).astype(np.float32)
    src = rng.standard_normal((b, v, h, w, c)).astype(np.float32)
    rel = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
    rel[:, :, :3, :3] += rng.normal(0, 0.05, (b, v, 3, 3))
    # Shifts of a few pixels, and some views pushed behind the camera.
    rel[:, :, :3, 3] = rng.normal(0, 1, (b, v, 3)) * [3.0, 3.0, 0.5]
    hyp = (np.linspace(0.5, 4.0, d)[None, :, None, None]
           + rng.uniform(0, 0.3, (b, d, h, w))).astype(np.float32)
    g = rng.standard_normal((b, d, h, w, c)).astype(np.float32)
    return ref, src, rel.astype(np.float32), hyp, g


def _jax_warp_grads(ref, src, rel, hyp, g):
    def loss(r, s):
        vol = jax.vmap(lambda a, b_, c_, e: jax_variance(
            a, b_, c_, e, sampler="gather"))(r, s, jnp.asarray(rel),
                                             jnp.asarray(hyp))
        return jnp.sum(vol * g)

    return [np.asarray(t) for t in jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(ref), jnp.asarray(src))]


@pytest.mark.parametrize("seed,c", [(50, 8), (51, 3)])
def test_warp_gradient_matches_jax(seed, c):
    ref, src, rel, hyp, g = _warp_inputs(seed, c=c)
    want_ref, want_src = _jax_warp_grads(ref, src, rel, hyp, g)
    r = torch.tensor(ref, requires_grad=True)
    s = torch.tensor(src, requires_grad=True)
    out = fused_variance_volume(r, s, torch.tensor(rel), torch.tensor(hyp))
    (out * torch.tensor(g)).sum().backward()
    direct = fused_variance_volume_grad(torch.tensor(g), torch.tensor(ref),
                                        torch.tensor(src), torch.tensor(rel),
                                        torch.tensor(hyp))
    for got, want, what in ((r.grad, want_ref, "dref"),
                            (s.grad, want_src, "dsrc"),
                            (direct[0], want_ref, "grad fn dref"),
                            (direct[1], want_src, "grad fn dsrc")):
        close_in_max(got.numpy(), want, 1e-5, what)
    assert np.abs(want_src).max() > 0.1  # samples do land in the images


def test_warp_refuses_geometry_gradients():
    """The cameras take no gradient (rel_projs raises); the hypotheses do
    (tests/test_torch_cost_volume_grad.py holds that gradient)."""
    ref, src, rel, hyp, _ = (torch.tensor(a) for a in _warp_inputs(52))
    with pytest.raises(ValueError, match="rel_projs requires grad"):
        fused_variance_volume(ref, src, rel.requires_grad_(), hyp)
    hyp.requires_grad_()
    fused_variance_volume(ref, src, rel.detach(), hyp).sum().backward()
    assert hyp.grad is not None and hyp.grad.abs().max() > 0


# Flax's lecun_normal: a unit normal truncated to [-2, 2], rescaled to
# variance 1 / fan_in; 0.8796... is the truncated normal's std.
LECUN_BOUND = 2.0 / 0.87962566103423978


@pytest.mark.parametrize("jmodule,port,x_shape", [
    (jblocks.ConvBlock(32, (3, 3)), blocks.ConvBlock(16, 32, (3, 3)),
     (1, 9, 11, 16)),
    (jblocks.ConvTransposeBlock(16, (3, 3, 3), strides=2),
     blocks.ConvTransposeBlock(32, 16), (1, 3, 4, 5, 32)),
    (jblocks.FusedConvBlock3D(32), blocks.FusedConvBlock3D(32, 32),
     (1, 4, 6, 7, 32)),
])
def test_training_init_is_flax_initial_state(jmodule, port, x_shape):
    """cli train starts from init_random_(trained=False): every kernel
    drawn as Flax's module.init draws it (lecun_normal), the rest Flax's
    initial values. Both sides' kernels, scaled by sqrt(fan_in) of the Flax
    layout, stay within the truncation bound and have unit variance; a
    plain normal (the port's first training init) exceeds the bound."""
    variables = jax.tree.map(np.asarray, jmodule.init(
        jax.random.key(0), jnp.zeros(x_shape), train=False))
    want = flax_to_state_dict(variables)
    fan_in = {".".join(k.key for k in path): int(np.prod(leaf.shape[:-1]))
              for path, leaf in jax.tree_util.tree_leaves_with_path(
                  variables["params"]) if path[-1].key == "kernel"}
    assert fan_in
    blocks.init_random_(port, torch.Generator().manual_seed(0),
                        trained=False)
    got = port.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        if not key.endswith("kernel"):
            np.testing.assert_array_equal(got[key].numpy(), value.numpy(),
                                          err_msg=key)
            continue
        for w in (got[key].numpy(), value.numpy()):
            scaled = w * np.sqrt(fan_in[key])
            assert np.abs(scaled).max() <= LECUN_BOUND * (1 + 1e-6), key
            assert abs(scaled.var() - 1.0) < 0.05, key
        plain = np.random.default_rng(0).standard_normal(value.shape)
        assert np.abs(plain).max() > LECUN_BOUND
