"""The port's blocks under mvs_tpu's other normalizations, "none" and
"group", against the Flax blocks on the CPU: ConvBlock (2D and 3D, stride
1 and 2), ConvTransposeBlock (stride 2 and 1), the cost regularizers'
stride-1 block (mvs_tpu.nn.cost_reg._conv3 / nn.blocks.conv3_block:
FusedConvBlock3D under none, a 3D ConvBlock under group), EdgeConv (with
and without the central half; 12 features, so one group of the
concatenated message holds central and difference channels) and
SharedMLP. Weights: kernels N(0, 1/fan_in), GroupNorm scale U(0.5, 1.5)
and bias N(0, 0.2), through convert.flax_to_state_dict.

One parametrised test; each case gives the same seeded input to both:
  * f32, eval and train mode: outputs within 1e-5 (rtol and atol);
  * bf16 (the ConvBlocks, with their compute dtype), eval and train mode:
    the same output dtype as Flax's (group norm promotes to f32), values
    within 2^-8 relative plus 2^-8 of the largest magnitude (one bf16
    rounding of the conv, which the normalization scales);
  * float64, train mode: the gradients of sum(out * w) in every parameter
    and the input within 1e-9 of each one's largest magnitude (mvs_tpu's
    modules with jnp.float32 read as float64, as tests/test_torch_train.py
    runs them).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_tpu.nn import blocks as jblocks
from mvs_tpu.nn import cost_reg as jcost_reg
from mvs_tpu.nn import point_nets as jpoint
from mvs_tpu_torch import convert
from mvs_tpu_torch.nn import blocks, point_nets
from test_torch_train_blocks import random_variables

K3 = (3, 3, 3)


def _block(kind, norm, dtype=None):
    """(Flax module, port module, input shape) of a case."""
    jd = {None: None, torch.bfloat16: jnp.bfloat16}[dtype]
    jkw = dict(normalization=norm, dtype=jd)
    pkw = dict(normalization=norm, dtype=dtype)
    if kind == "conv2d":
        return (jblocks.ConvBlock(16, (3, 3), **jkw),
                blocks.ConvBlock(8, 16, (3, 3), **pkw), (2, 9, 10, 8))
    if kind == "conv2d_s2_k5":
        return (jblocks.ConvBlock(16, (5, 5), strides=2, **jkw),
                blocks.ConvBlock(8, 16, (5, 5), stride=2, **pkw),
                (2, 12, 13, 8))
    if kind == "conv3d":
        return (jblocks.ConvBlock(16, K3, **jkw),
                blocks.ConvBlock(8, 16, K3, **pkw), (2, 4, 6, 7, 8))
    if kind == "conv3d_s2":
        return (jblocks.ConvBlock(16, K3, strides=2, **jkw),
                blocks.ConvBlock(8, 16, K3, stride=2, **pkw), (2, 4, 6, 8, 8))
    if kind == "convT3d_s2":
        return (jblocks.ConvTransposeBlock(8, K3, strides=2, **jkw),
                blocks.ConvTransposeBlock(16, 8, 2, **pkw), (2, 3, 4, 5, 16))
    if kind == "convT3d_s1":
        return (jblocks.ConvTransposeBlock(8, K3, strides=1, **jkw),
                blocks.ConvTransposeBlock(16, 8, 1, **pkw), (2, 4, 5, 6, 16))
    if kind == "conv3":
        return (jcost_reg._conv3(16, norm, None, dtype=jd),
                blocks.conv3_block(8, 16, norm, dtype)[1], (2, 4, 6, 7, 8))
    if kind in ("edge_concat", "edge_diff"):
        concat = kind == "edge_concat"
        return (jpoint.EdgeConv(12, concat_central=concat, normalization=norm),
                point_nets.EdgeConv(10, 12, concat, norm), (2, 40, 10))
    assert kind == "mlp"
    return (jpoint.SharedMLP((16, 24), normalization=norm),
            point_nets.SharedMLP(12, (16, 24), norm), (2, 30, 12))


KINDS = ("conv2d", "conv2d_s2_k5", "conv3d", "conv3d_s2", "convT3d_s2",
         "convT3d_s1", "conv3", "edge_concat", "edge_diff", "mlp")
POINT = ("edge_concat", "edge_diff", "mlp")
CASES = [(k, n, m) for k in KINDS for n in ("none", "group")
         for m in ("eval", "train", "bf16_eval", "bf16_train", "grad64")
         if not (k in POINT and m.startswith("bf16"))]


class _Float64Numpy:
    """jax.numpy with float32 read as float64 (tests/test_torch_train.py)."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _inputs(kind, shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    idx = rng.integers(0, shape[1], (shape[0], shape[1], 6)) \
        if kind.startswith("edge") else None
    return x, idx


def _args(x, idx, jax_side):
    if idx is None:
        return (x,)
    return (x, jnp.asarray(idx, jnp.int32) if jax_side else
            torch.from_numpy(idx))


@pytest.mark.parametrize("kind,norm,mode", CASES)
def test_block_matches_flax(kind, norm, mode):
    seed = KINDS.index(kind) * 10 + (norm == "group")
    dtype = torch.bfloat16 if mode.startswith("bf16") else None
    jmod, port, shape = _block(kind, norm, dtype)
    x, idx = _inputs(kind, shape, seed)
    variables = random_variables(jmod, *_args(jnp.asarray(x), idx, True),
                                 seed=seed)
    port.load_state_dict(convert.flax_to_state_dict(variables))
    train = mode.endswith("train") or mode == "grad64"
    port.train(train)
    if mode == "grad64":
        _check_float64_gradients(jmod, port, variables, x, idx, seed)
        return

    jd = jnp.bfloat16 if dtype else jnp.float32
    want = jmod.apply(variables, *_args(jnp.asarray(x, jd), idx, True),
                      train=train, mutable=["batch_stats"])[0]
    with torch.no_grad():
        got = port(*_args(torch.from_numpy(x).to(dtype or torch.float32),
                          idx, False))
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).split(".")[-1] == str(want.dtype), (got.dtype,
                                                              want.dtype)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype is None:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -8,
                                   atol=2.0 ** -8 * np.abs(want).max())


def _check_float64_gradients(jmod, port, variables, x, idx, seed):
    w = np.random.default_rng(seed + 7).standard_normal(
        jax.eval_shape(lambda: jmod.apply(
            variables, *_args(jnp.asarray(x), idx, True), train=True,
            mutable=["batch_stats"])[0]).shape)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "float", lambda t: t if t.dtype ==
                   torch.float64 else t.to(torch.float32))
        port.double()
        xt = torch.from_numpy(x).double().requires_grad_()
        (port(*_args(xt, idx, False)) * torch.from_numpy(w)).sum().backward()
        got = {k: p.grad for k, p in port.named_parameters()}

        for name, module in list(sys.modules.items()):
            if name.split(".")[0] == "mvs_tpu" and \
                    getattr(module, "jnp", None) is jnp:
                mp.setattr(module, "jnp", _Float64Numpy())
        x64 = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)
        try:
            v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                               variables)

            def loss(params, xin):
                y = jmod.apply({**v64, "params": params},
                               *_args(xin, idx, True), train=True,
                               mutable=["batch_stats"])[0]
                assert y.dtype == jnp.float64
                return jnp.sum(y * w)

            gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
                v64["params"], jnp.asarray(x, jnp.float64))
            gp, gx = jax.tree.map(np.asarray, gp), np.asarray(gx)
        finally:
            jax.config.update("jax_enable_x64", x64)
    want = {".".join(path): convert._kernel(path, v) if path[-1] == "kernel"
            else v for path, v in convert._flatten(gp)}
    assert set(got) == set(want)
    pairs = [(k, got[k].numpy(), want[k]) for k in want]
    pairs.append(("input", xt.grad.numpy(), gx))
    for k, g, wv in pairs:
        err = np.abs(g - wv).max() / max(np.abs(wv).max(), 1e-300)
        assert err <= 1e-9, (k, err)


def test_group_norm_statistics_cover_every_axis_but_the_first():
    """Per sample, a 3D volume's group statistics include D: a shift of one
    depth plane of sample 0 moves sample 0's output everywhere and sample
    1's nowhere."""
    norm = blocks.GroupNorm(16)
    x = torch.randn(2, 4, 3, 5, 16)
    y = norm(x)
    x2 = x.clone()
    x2[0, 2] += 1.0
    y2 = norm(x2)
    assert not torch.allclose(y2[0, 0], y[0, 0])
    assert torch.equal(y2[1], y[1])
    with pytest.raises(ValueError, match="normalization"):
        blocks.make_norm("layer", 8)
