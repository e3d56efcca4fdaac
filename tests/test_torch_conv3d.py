"""Parity of the port's fused 3x3x3 conv (mvs_tpu_torch.ops.conv3d) with
mvs_tpu's on the CPU.

On CPU tensors ``conv3d_affine`` runs its plain version (F.conv3d, affine,
ReLU); the CUDA kernel is held against it on the card by chip_smoke.py. Here
it is held against the Pallas kernel conv3d_folded(..., interpret=True) at
the shapes and bound of tests/test_conv3d_pallas.py (rtol/atol 2e-4: f32
sums of 27*Cin products in another order), and FusedConvBlock3D against the
Flax module through converted weights with non-trivial BatchNorm. The
kernels' weight layout (pack_conv3d_taps) is held to the same bound as the
GEMM the tensor-core kernel computes: an im2col of the input in its K order
times the packed matrix, with the affine and ReLU.

The f32 tensor-core kernels (3xTF32, and its Cin = 64 kernel, which reads
the same split weights) are emulated here: split_tf32 splits both x and the
weights into two TF32 parts, and the three products the kernels take
(small*big, big*small, big*big; exact in f64) are held against the Pallas
kernel at AACVP's f32 shapes and at the Cin = 64 ones (64->8, 64->64,
64->32) within the same 2e-4, while one TF32 product alone misses by more
than 1e-4 of the largest output (the card's f32 limit), so dropping the
split would show. _variant, the rule that picks a CUDA call's kernel, is
pinned for every conv of the main paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mvs_tpu.nn.blocks import FusedConvBlock3D as JaxFusedConvBlock3D
from mvs_tpu.ops.conv3d_pallas import conv3d_folded
from mvs_tpu_torch.convert import flax_to_state_dict
from mvs_tpu_torch.nn.blocks import FusedConvBlock3D
from mvs_tpu_torch.ops.conv3d import (_packed, _variant, conv3d_affine,
                                      pack_conv3d_taps, pack_conv3d_tf32x3,
                                      split_tf32)
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
    port.eval()
    with torch.no_grad():
        got = port(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_wrapper_rejects_other_devices():
    x = torch.empty((1, 2, 3, 4, 8), device="meta")
    w = torch.empty((8, 8, 3, 3, 3))
    with pytest.raises(ValueError, match="unsupported device"):
        conv3d_affine(x, w, torch.ones(8), torch.zeros(8), relu=False)


def _im2col(x):
    """(B, D, H, W, C) -> (B*D*H*W, 27*C), columns tap-major
    ((dz * 3 + dy) * 3 + dx), channel-minor: the kernels' K order."""
    b, d, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    cols = [xp[:, dz:dz + d, dy:dy + h, dx:dx + w]
            for dz in range(3) for dy in range(3) for dx in range(3)]
    return torch.stack(cols, dim=-2).reshape(b * d * h * w, 27 * c)


@pytest.mark.parametrize("c_in,c_out,reference", [
    (8, 1, "lax"), (8, 8, "lax"), (32, 8, "pallas"), (64, 64, "lax")])
def test_packed_taps_are_the_kernels_gemm(c_in, c_out, reference):
    rng = np.random.default_rng(5)
    shape = (1, 4, 8, 8) if reference == "pallas" else (2, 3, 5, 6)
    x = rng.standard_normal((*shape, c_in)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, c_in, c_out)) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, c_out).astype(np.float32)
    shift = rng.standard_normal(c_out).astype(np.float32)
    if reference == "pallas":
        want = conv3d_folded(jnp.asarray(x), jnp.asarray(k),
                             jnp.asarray(scale), jnp.asarray(shift),
                             relu=True, interpret=True)
    else:
        want = jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(k), (1, 1, 1), "SAME",
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
            precision=jax.lax.Precision.HIGHEST)
        want = jnp.maximum(want * scale + shift, 0.0)
    weight = _t(k.transpose(4, 3, 0, 1, 2))
    packed = pack_conv3d_taps(weight, torch.float32)
    kk = 27 * c_in
    # K padded to the MMA's k step of 16, N to its n tile of 8, with zeros.
    assert packed.shape == (-(-kk // 16) * 16, -(-c_out // 8) * 8)
    assert not packed[kk:].any() and not packed[:, c_out:].any()
    y = _im2col(_t(x)) @ packed[:kk, :c_out]
    y = torch.relu(y * _t(scale) + _t(shift)).reshape(*shape, c_out)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    # bf16: the weights are rounded to the input dtype, then laid out.
    assert torch.equal(pack_conv3d_taps(weight, torch.bfloat16),
                       packed.to(torch.bfloat16))


def test_packed_weights_are_kept_until_the_weight_changes():
    weight = torch.nn.Parameter(torch.randn(8, 16, 3, 3, 3))
    first = _packed(weight, torch.bfloat16)
    assert _packed(weight, torch.bfloat16) is first
    assert _packed(weight, torch.float32).dtype == torch.float32
    with torch.no_grad():
        weight.mul_(2.0)
    again = _packed(weight, torch.bfloat16)
    assert again is not first
    assert torch.equal(again, pack_conv3d_taps(weight, torch.bfloat16))


def test_packed_weights_follow_load_state_dict():
    block = FusedConvBlock3D(8, 8)
    first = _packed(block.kernel, torch.bfloat16)
    state = {k: v.clone() for k, v in block.state_dict().items()}
    state["kernel"] = torch.randn_like(state["kernel"])
    block.load_state_dict(state)
    assert torch.equal(_packed(block.kernel, torch.bfloat16),
                       pack_conv3d_taps(state["kernel"], torch.bfloat16))
    assert not torch.equal(_packed(block.kernel, torch.bfloat16), first)


@pytest.mark.parametrize("c_in,c_out", [(4, 16), (16, 16), (8, 1), (32, 8),
                                        (64, 8), (64, 64)])
def test_tf32x3_packing_splits_the_weights(c_in, c_out):
    """pack_conv3d_tf32x3: big + small gives the f32 weight back within
    2^-21 relative, both parts are TF32 values (13 low mantissa bits zero),
    and lane g * 4 + t4 of (n8 tile nt, k step s) holds the m16n8k8 B
    fragment rows k = 8 s + t4 and k + 4 of column n = 8 nt + g. At Cin =
    64 a tap is exactly 8 k steps (no padding), so the Cin = 64 kernel
    finds tap plane dz, tap (dy, dx), step c at s = (dz * 9 + dy * 3 + dx)
    * 8 + c."""
    weight = torch.randn(c_out, c_in, 3, 3, 3,
                         generator=torch.Generator().manual_seed(c_in))
    taps = pack_conv3d_taps(weight, torch.float32)
    packed = pack_conv3d_tf32x3(weight)
    nt, steps = packed.shape[:2]
    assert packed.shape == (-(-c_out // 8), -(-27 * c_in // 8), 32, 4)
    assert steps * 8 >= 27 * c_in
    frag = packed.reshape(nt, steps, 8, 4, 2, 2)  # (nt, s, g, t4, part, h)
    big, small = (frag[..., i, :].permute(1, 4, 3, 0, 2).reshape(
        steps * 8, nt * 8) for i in range(2))  # (s, h, t4) x (nt, g)
    want = taps[:steps * 8]
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(torch.stack((big, small)),
                       torch.stack(split_tf32(want)))
    err = (big + small - want).abs()
    assert (err <= want.abs() * 2.0 ** -21).all()
    assert (big != want).any()  # the split is not empty
    if c_in == 64:
        assert steps == 27 * 8
        dz, dy, dx, c = 2, 1, 0, 5
        s = (dz * 9 + dy * 3 + dx) * 8 + c
        assert torch.equal(big[8 * s:8 * s + 8], split_tf32(
            weight[:, 8 * c:8 * c + 8, dz, dy, dx].T)[0])


@pytest.mark.parametrize("c_in,c_out,shape", [
    (4, 16, (3, 4, 8, 16)),
    (16, 16, (3, 3, 6, 16)),
    (64, 8, (1, 2, 4, 8)),
    (64, 64, (1, 2, 6, 16)),
    (64, 32, (1, 2, 5, 12)),
])
def test_tf32x3_emulation_matches_pallas(c_in, c_out, shape):
    """The 3xTF32 kernels' arithmetic against mvs_tpu's f32 conv: three
    TF32 products (exact in f64) within 2e-4; one alone misses by more
    than 1e-4 of the largest output. shape is (B, D, H, W)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((*shape, c_in)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, c_in, c_out)) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, c_out).astype(np.float32)
    shift = rng.standard_normal(c_out).astype(np.float32)
    want = np.asarray(conv3d_folded(jnp.asarray(x), jnp.asarray(k),
                                    jnp.asarray(scale), jnp.asarray(shift),
                                    relu=True, interpret=True))
    xb, xs = split_tf32(_t(x))
    wb, ws = split_tf32(_t(k.transpose(4, 3, 0, 1, 2)))

    def conv(a, w):
        return F.conv3d(a.double().permute(0, 4, 1, 2, 3), w.double(),
                        padding=1)

    def epilogue(y):
        y = torch.relu(y * _t(scale).double()[:, None, None, None]
                       + _t(shift).double()[:, None, None, None])
        return y.float().permute(0, 2, 3, 4, 1).numpy()

    three = epilogue(conv(xs, wb) + conv(xb, ws) + conv(xb, wb))
    one = epilogue(conv(xb, wb))
    np.testing.assert_allclose(three, want, rtol=2e-4, atol=2e-4)
    largest = np.abs(want).max()
    assert np.abs(three - want).max() < 1e-6 * largest
    assert np.abs(one - want).max() > 1e-4 * largest


# (Cin, Cout) of every conv3d_affine call of the main paths, with the
# variant it takes in bf16 and in f32: CasMVSNet and MVSNet (U-Net base 8;
# stage features 32, 16, 8), CVP and AACVP (base 16; AACVP's first block
# takes its 4 groups, and its f32 blocks run in its bf16 model too),
# Point-MVSNet's VolumeConv (f32 only; 64->8 first), and (12, 8). Every f32
# conv at Cin = 64 takes the 3xTF32 Cin = 64 kernel.
_MAIN_CONVS = {
    (4, 16): ("direct", "tf32x3"),
    (8, 1): ("mma", "tf32x3"),
    (8, 8): ("mma", "tf32x3"),
    (12, 8): ("direct", "direct"),
    (16, 1): ("mma", "tf32x3"),
    (16, 8): ("mma", "tf32x3"),
    (16, 16): ("mma", "tf32x3"),
    (32, 8): ("mma", "tf32x3"),
    (32, 32): ("mma", "tf32x3"),
    (32, 64): ("mma", "tf32x3"),
    (64, 8): ("mma", "tf32x3_cin64"),
    (64, 32): ("mma", "tf32x3_cin64"),
    (64, 64): ("mma", "tf32x3_cin64"),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c_in,c_out", sorted(_MAIN_CONVS))
def test_variant_of_every_main_path_conv(dtype, c_in, c_out):
    bf16, f32 = _MAIN_CONVS[(c_in, c_out)]
    assert _variant(dtype, c_in, c_out) == (
        bf16 if dtype == torch.bfloat16 else f32)


def test_variant_sends_other_f32_couts_to_the_direct_kernel():
    assert _variant(torch.float32, 16, 12) == "direct"
    assert _variant(torch.float32, 16, 24) == "tf32x3"
    assert _variant(torch.float32, 12, 8) == "direct"
    assert _variant(torch.float32, 64, 12) == "direct"
    assert _variant(torch.float32, 64, 1) == "direct"
    assert _variant(torch.float32, 64, 24) == "tf32x3_cin64"
