"""Gradients of the port's two cost volumes against jax.grad of mvs_tpu's,
on the CPU: d ref, d src and d depth_values of
mvs_tpu.ops.cost_volume.variance_cost_volume and
group_correlation_cost_volume (sampler="gather", per-pixel hypotheses,
batched with vmap), for the same cotangent, against autograd through the
port's plain paths (ops.cost_volume, the CPU path of ops.warp_variance and
ops.group_correlation and of their backward wrappers).

Inputs, each from a numpy seed:
  * "random": near-identity rotations, shifts of a few pixels, and depths
    from 0.5 to 4.3 with translations in z that put some points behind a
    source camera (z <= 1e-3, no gradient) and many corners off the image;
  * "integer": identity rotations, z-translation 0 and shifts of -4, 0 or
    4 pixels over per-pixel depths 1, 2 or 4, so that every sample lands
    on an integer coordinate, among them x = W - 1 and y = H - 1 (the
    right or lower corner off the image) and x = -1 (only the right corner
    in it). JAX differentiates x - floor(x) with slope 1 everywhere, so the
    gradient along x there is the right-hand difference v01 - v00 (-v00 at
    x = W - 1);
  * "sweep": the geometries of the CUDA backwards' window and spill
    branches. Source 0 zooms 3x about the image centre and shifts by 15 /
    depth along x, so that one sample moves 10 px over hypotheses 1..3 and
    many leave the image; source 1 shifts by 0.5 / depth, so that
    consecutive hypotheses keep most samples in one 2x2 cell, and in batch
    0 has the nearer depths behind it.
Bounds: f32 within 1e-5 of each gradient's largest magnitude (the same
arithmetic; sums in another order); float64 (the port's .float() kept at
float64, jax_enable_x64) within 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_tpu.ops.cost_volume import \
    group_correlation_cost_volume as jax_group_correlation
from mvs_tpu.ops.cost_volume import variance_cost_volume as jax_variance
from mvs_tpu_torch.ops.group_correlation import (
    group_correlation_volume, group_correlation_volume_grad,
    group_correlation_volume_grad_plain)
from mvs_tpu_torch.ops.warp_variance import (fused_variance_volume,
                                             fused_variance_volume_grad,
                                             fused_variance_volume_grad_plain)

GROUPS = 4


def _inputs(kind, seed, b=2, v=2, d=4, h=7, w=9, c=8):
    """(ref, src, rel, hyp) as numpy f32 arrays of one case."""
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((b, h, w, c)).astype(np.float32)
    src = rng.standard_normal((b, v, h, w, c)).astype(np.float32)
    rel = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
    if kind == "random":
        rel[:, :, :3, :3] += rng.normal(0, 0.05, (b, v, 3, 3))
        rel[:, :, :3, 3] = rng.normal(0, 1, (b, v, 3)) * [3.0, 3.0, 0.8]
        rel[0, 1, 2, 3] = -2.0  # the nearer depths behind this camera
        hyp = (np.linspace(0.5, 4.0, d)[None, :, None, None]
               + rng.uniform(0, 0.3, (b, d, h, w)))
    elif kind == "sweep":
        cx, cy = (w - 1) / 2, (h - 1) / 2
        rel[:, 0, :2, :3] = [[3.0, 0.0, -2.0 * cx], [0.0, 3.0, -2.0 * cy]]
        rel[:, 0, :2, 3] = (15.0, 0.0)
        rel[:, 1, :2, 3] = (0.5, 0.0)
        rel[0, 1, 2, 3] = -1.5  # depths under 1.5 behind this camera
        hyp = (np.linspace(1.0, 3.0, d)[None, :, None, None]
               + rng.uniform(0, 0.02, (b, d, h, w)))
    else:
        rel[:, :, :2, 3] = rng.choice([-4.0, 0.0, 4.0], (b, v, 2))
        rel[0, 0, :2, 3] = (-4.0, 4.0)  # some samples at x = -1, y = H - 1
        hyp = rng.choice([1.0, 2.0, 4.0], (b, d, h, w))
    return ref, src, rel.astype(np.float32), hyp.astype(np.float32)


def _jax_fn(name):
    if name == "variance":
        return lambda r, s, p, dv: jax_variance(r, s, p, dv, sampler="gather")
    return lambda r, s, p, dv: jax_group_correlation(r, s, p, dv, GROUPS,
                                                     sampler="gather")


def _cotangent(name, ref, hyp, seed):
    b, d = hyp.shape[:2]
    last = ref.shape[-1] if name == "variance" else GROUPS
    return np.random.default_rng(seed).standard_normal(
        (b, d) + hyp.shape[2:] + (last,)).astype(ref.dtype)


def _jax_grads(name, ref, src, rel, hyp, g):
    fn = jax.vmap(_jax_fn(name))

    def loss(r, s, dv):
        return jnp.sum(fn(r, s, jnp.asarray(rel), dv) * g)

    return [np.asarray(t) for t in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(ref), jnp.asarray(src), jnp.asarray(hyp))]


def _plain(name):
    if name == "variance":
        return fused_variance_volume_grad_plain
    return lambda *a: group_correlation_volume_grad_plain(*a, GROUPS)


def _close(got, want, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = np.abs(want).max()
    assert scale > 0, what
    err = np.abs(got - want).max()
    assert err <= tol * scale, (what, err / scale)


@pytest.mark.parametrize("name", ["variance", "group_correlation"])
@pytest.mark.parametrize("kind", ["random", "integer", "sweep"])
def test_gradients_match_jax(name, kind):
    ref, src, rel, hyp = _inputs(kind, 7)
    g = _cotangent(name, ref, hyp, 8)
    want = _jax_grads(name, ref, src, rel, hyp, g)
    got = _plain(name)(*(torch.tensor(a) for a in (g, ref, src, rel, hyp)))
    for a, b, what in zip(got, want, ("dref", "dsrc", "ddepth")):
        assert a.shape == b.shape and a.dtype == torch.float32, what
        _close(a, b, 1e-5, f"{name} {kind} {what}")


@pytest.mark.parametrize("name", ["variance", "group_correlation"])
def test_gradients_match_jax_in_float64(name, monkeypatch):
    ref, src, rel, hyp = (a.astype(np.float64) for a in _inputs("random", 9))
    g = _cotangent(name, ref, hyp, 10)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        want = _jax_grads(name, ref, src, rel, hyp, g)
    finally:
        jax.config.update("jax_enable_x64", x64)
    assert want[2].dtype == np.float64
    # The plain paths sum in f32 through .float(): keep float64 there.
    monkeypatch.setattr(torch.Tensor, "float", lambda t: t if t.dtype ==
                        torch.float64 else t.to(torch.float32))
    got = _plain(name)(*(torch.tensor(a) for a in (g, ref, src, rel, hyp)))
    for a, b, what in zip(got, want, ("dref", "dsrc", "ddepth")):
        assert a.dtype == torch.float64, what
        _close(a, b, 1e-9, f"{name} float64 {what}")


def test_integer_coordinates_take_right_hand_differences():
    """A sample at x = W - 1 (y integer): d var / d depth is the right-hand
    difference -v00 (the corner at x = W read as 0) times dx/ddepth; at
    x = -1 it is +v01 (the corner at x = 0). Both sides, against the value
    worked by hand: 2 views, ref = 1, var = (1 - s)^2 / 4, so d var / ds =
    (s - 1) / 2; x_s = x + shift / depth at depth 1, so dx/ddepth = -shift.
    """
    h, w = 3, 4
    src = np.arange(1, h * w + 1, dtype=np.float32).reshape(1, 1, h, w, 1)
    ref = np.ones((1, h, w, 1), np.float32)
    hyp = np.ones((1, 1, h, w), np.float32)
    for shift, px, s, slope in ((1.0, w - 2, src[0, 0, 1, w - 1, 0],
                                 -src[0, 0, 1, w - 1, 0]),
                                (-1.0, 0, 0.0, src[0, 0, 1, 0, 0])):
        rel = np.eye(4, dtype=np.float32)[None, None].copy()
        rel[0, 0, 0, 3] = shift
        g = np.zeros((1, 1, h, w, 1), np.float32)
        g[0, 0, 1, px] = 1.0
        expect = (s - 1.0) / 2.0 * slope * -shift
        assert expect != 0
        got = fused_variance_volume_grad_plain(
            *(torch.tensor(a) for a in (g, ref, src, rel, hyp)))[2]
        want = _jax_grads("variance", ref, src, rel, hyp, g)[2]
        np.testing.assert_allclose(float(got[0, 0, 1, px]), expect, rtol=1e-6)
        np.testing.assert_allclose(want[0, 0, 1, px], expect, rtol=1e-6)


@pytest.mark.parametrize("name", ["variance", "group_correlation"])
def test_wrappers_give_the_plain_gradients_on_the_cpu(name):
    """Autograd through each wrapper (the plain path on the CPU) and its
    backward function give the plain version's three gradients; the
    backward returns the hypotheses' gradient only when asked."""
    ref, src, rel, hyp = (torch.tensor(a) for a in _inputs("random", 11))
    g = torch.tensor(_cotangent(name, ref.numpy(), hyp.numpy(), 12))
    want = _plain(name)(g, ref, src, rel, hyp)
    leaves = [t.clone().requires_grad_() for t in (ref, src, hyp)]
    if name == "variance":
        out = fused_variance_volume(leaves[0], leaves[1], rel, leaves[2])
        direct = fused_variance_volume_grad(g, ref, src, rel, hyp,
                                            depth_grad=True)
        without = fused_variance_volume_grad(g, ref, src, rel, hyp)
    else:
        out = group_correlation_volume(leaves[0], leaves[1], rel, leaves[2],
                                       GROUPS)
        direct = group_correlation_volume_grad(g, ref, src, rel, hyp, GROUPS,
                                               depth_grad=True)
        without = group_correlation_volume_grad(g, ref, src, rel, hyp, GROUPS)
    (out * g).sum().backward()
    for i, what in enumerate(("dref", "dsrc", "ddepth")):
        torch.testing.assert_close(leaves[i].grad, want[i], rtol=0, atol=0)
        torch.testing.assert_close(direct[i], want[i], rtol=0, atol=0)
    assert without[2] is None
    torch.testing.assert_close(without[1], want[1], rtol=0, atol=0)


@pytest.mark.parametrize("name", ["variance", "group_correlation"])
def test_camera_gradients_still_raise(name):
    ref, src, rel, hyp = (torch.tensor(a) for a in _inputs("random", 13))
    args = (ref, src, rel.requires_grad_(), hyp.requires_grad_())
    with pytest.raises(ValueError, match="rel_projs requires grad"):
        if name == "variance":
            fused_variance_volume(*args)
        else:
            group_correlation_volume(*args, GROUPS)
