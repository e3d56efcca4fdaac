"""Convolution building blocks, channels-last (counterpart of
mvs_tpu.nn.blocks).

2D features are (B, H, W, C) and 3D volumes (B, D, H, W, C), as in the JAX
package. A torch conv sees them through a permuted view (channels_last
strides), not a copy.

Eval mode (``module.eval()``) folds BatchNorm into a per-channel affine
applied in the conv's f32 epilogue, followed by an optional ReLU; every
3x3x3 stride-1 conv runs on the fused conv3d kernel. Train mode
(``module.train()``) is the JAX package's ``train=True``: each conv is a
differentiable torch conv, BatchNorm normalizes with the batch's moments in
f32 and updates its running statistics, then ReLU, then a cast to the
compute dtype.

``normalization`` is mvs_tpu's: "batch" (the above), "none" (the bias-free
conv and the ReLU; the stride-1 3x3x3 convs stay on the fused kernel with a
unit affine) or "group" (flax.linen.GroupNorm, see GroupNorm: per sample,
no running statistics, the same in both modes, after the conv and before
the ReLU, so never in the conv's epilogue). A block's ``dtype``, when
given, is the compute dtype its input is cast to, as the Flax blocks'
``dtype`` casts; it matters where a group norm's f32 output enters a bf16
block.

Parameter and submodule names follow the Flax scopes (``Conv_0``,
``Norm_0``, ``kernel``, ``scale``, ``bias``, ``mean``, ``var``, ``count``)
so that ``mvs_tpu_torch.convert`` maps a Flax tree onto a state_dict by
path. Kernels are stored in torch layout: (O, I, *k) for convs, (I, O, *k)
for transposed convs.

Geometry follows flax 'SAME': stride-2 padding is asymmetric (lo =
total // 2), and the stride-2 transposed conv is flax's dilated-input form,
which torch expresses as conv_transpose over the flipped kernel cropped to
2x the input (the flip happens in the converter).

Inside a split volume (parallel.sharding.use_volume: a rank holds a slab
of the cost regularizer's volume) every 3D conv of kernel 3 exchanges its
input's halo first and convolves the extended slab (parallel.halo), and
the normalizations take their moments over the ranks whose slabs make the
batch (BatchNorm) or the sample (GroupNorm).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mvs_tpu_torch.ops.conv3d import conv3d_affine
from mvs_tpu_torch.parallel import halo
from mvs_tpu_torch.parallel.collectives import all_reduce, global_moments
from mvs_tpu_torch.parallel.sharding import current_volume

__all__ = ["BatchStats", "Norm", "GroupNorm", "make_norm", "Conv",
           "ConvTranspose", "ConvBlock", "ConvTransposeBlock",
           "FusedConvBlock3D", "FusedConvBlock3DNoNorm", "conv3_block",
           "Dense", "init_random_", "NORMALIZATIONS"]

NORMALIZATIONS = ("batch", "group", "none")
_EPS = 1e-5
# flax.linen.GroupNorm's epsilon and mvs_tpu's channels per group.
_GN_EPS = 1e-6
_GN_GROUP_SIZE = 8
_MOMENTUM = 0.9
# A state_dict written before the statistics had a count (the port's
# inference-only .pt files) holds converged, debiased statistics: they load
# with this count, for which the next update weighs them by the momentum as
# a plain EMA would (mvs_tpu.train.checkpoint.migrate_batch_stats assumes
# the same).
_ASSUMED_COUNT = 1.0e4


def _bn_affine(gamma, beta, mean, var, eps=_EPS):
    s = gamma * torch.rsqrt(var + eps)
    return s, beta - mean * s


def _same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """flax/XLA SAME: out = ceil(n / s), lo = total // 2."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _epilogue(y, scale, shift, relu, dtype):
    y = y.float()
    if scale is not None:
        shape = (-1,) + (1,) * (y.ndim - 2)
        y = y * scale.view(shape) + shift.view(shape)
    if relu:
        y = torch.relu(y)
    return y.to(dtype).movedim(1, -1).contiguous()


class BatchStats(nn.Module):
    """BatchNorm's affine (``scale``/``bias``) and running statistics.

    ``mean``/``var`` are stored debiased, as eval mode reads them; ``count``
    is the number of train-mode updates. The JAX modules keep zero-started
    EMA accumulators and divide by 1 - m^count when they read them; a train
    update here keeps the debiased form directly:

        new = old * (m - m^(t+1)) / (1 - m^(t+1))
              + batch * (1 - m) / (1 - m^(t+1)),   t = count,

    which at t = 0 ignores the initial (identity) statistics, as the JAX
    package's zero accumulators do.
    """

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.register_buffer("count", torch.zeros(()))

    def affine(self, mean=None, var=None):
        """(scale, shift) with x*scale + shift == BN(x) in eval mode, or
        under a batch's moments (mean, var) when given."""
        if mean is None:
            mean, var = self.mean, self.var
        return _bn_affine(self.scale, self.bias, mean, var)

    @staticmethod
    def batch_moments(y: torch.Tensor):
        """(mean, var) of channels-last `y` over every axis but the last, in
        f32: the biased var = max(E[y^2] - E[y]^2, 0). Under a current mesh
        with more than one data rank (parallel.use_mesh) E[y] and E[y^2]
        are the global batch's: one differentiable all-reduce over the
        'data' group, or inside a split volume over the ranks whose slabs
        make the batch (parallel.collectives.global_moments)."""
        mean, mean_sq = global_moments(y.float())
        return mean, torch.clamp(mean_sq - mean * mean, min=0.0)

    @torch.no_grad()
    def record(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """One train-mode update of the statistics by a batch's moments."""
        keep = _MOMENTUM ** (self.count + 1.0)
        denom = 1.0 - keep
        self.mean.mul_((_MOMENTUM - keep) / denom).add_(
            mean * ((1.0 - _MOMENTUM) / denom))
        self.var.mul_((_MOMENTUM - keep) / denom).add_(
            var * ((1.0 - _MOMENTUM) / denom))
        self.count.add_(1.0)

    def normalize_batch(self, y: torch.Tensor) -> torch.Tensor:
        """Train-mode BN of channels-last `y` in f32 with the batch's
        moments (batch_moments); updates the statistics. Returns f32."""
        mean, var = self.batch_moments(y)
        self.record(mean, var)
        return (y.float() - mean) * self.scale * torch.rsqrt(var + _EPS) \
            + self.bias

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        key = prefix + "count"
        if key not in state_dict and prefix + "mean" in state_dict:
            state_dict[key] = torch.tensor(_ASSUMED_COUNT)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class Norm(BatchStats):
    """BatchNorm: folded into the preceding conv in eval mode, batch moments
    in train mode (forward)."""

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        """Train-mode BN of `y`, returned in y's dtype."""
        return self.normalize_batch(y).to(y.dtype)


class _GroupNormAffine(nn.Module):
    """The GroupNorm_0 scope: flax.linen.GroupNorm's scale and bias."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))


class GroupNorm(nn.Module):
    """mvs_tpu's Norm(normalization='group'): flax.linen.GroupNorm with
    max(1, C // 8) groups, its parameters under ``GroupNorm_0``.

    Per sample (axis 0), each group's mean and variance are taken over
    every other axis and the group's channels: in a (B, D, H, W, C) volume
    over D, H and W too. As flax computes them: in at least f32, the
    variance E[x^2] - E[x]^2 clamped at 0, epsilon 1e-6, y = (x - mean) *
    (rsqrt(var + eps) * scale) + bias. The output is the promotion of the
    input's dtype with f32 (flax promotes with its f32 parameters), so a
    bf16 block returns f32. No running statistics: train and eval mode are
    the same, and no collective is needed under a data-parallel mesh.
    """

    def __init__(self, channels: int):
        super().__init__()
        self.groups = max(1, channels // _GN_GROUP_SIZE)
        if channels % self.groups:
            raise ValueError(f"{channels} channels do not split into "
                             f"{self.groups} groups")
        self.GroupNorm_0 = _GroupNormAffine(channels)

    def moments(self, sums: torch.Tensor, sq_sums: torch.Tensor,
                count: int):
        """Each channel's group (mean, var), (B, C), from the per-sample
        channel sums of x and x^2 over `count` elements a channel."""
        b, c = sums.shape
        n = count * (c // self.groups)
        mean = sums.reshape(b, self.groups, -1).sum(-1) / n
        mean_sq = sq_sums.reshape(b, self.groups, -1).sum(-1) / n
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        return (mean.repeat_interleave(c // self.groups, dim=1),
                var.repeat_interleave(c // self.groups, dim=1))

    def normalize(self, x: torch.Tensor, mean: torch.Tensor,
                  var: torch.Tensor, channels: slice = slice(None)):
        """x (B, ..., C') normalized by per-sample (mean, var) (B, C') of
        the channels `channels` of this norm."""
        shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (-1,)
        p = self.GroupNorm_0
        mul = torch.rsqrt(var + _GN_EPS) * p.scale[channels]
        return (x - mean.reshape(shape)) * mul.reshape(shape) + \
            p.bias[channels]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = tuple(range(1, x.ndim - 1))
        count = xf[0, ..., 0].numel()
        sums, sq_sums = xf.sum(dims), (xf * xf).sum(dims)
        shard = current_volume() if x.ndim == 5 else None
        group = None if shard is None else shard.sample_group
        if group is not None:  # a sample's volume over the ranks' slabs
            n = torch.full_like(sums, float(count))
            sums, sq_sums, n = all_reduce(torch.stack([sums, sq_sums, n]),
                                          group).unbind()
            count = n[0, 0]
        mean, var = self.moments(sums, sq_sums, count)
        return self.normalize(xf, mean, var)


def make_norm(normalization: str, channels: int) -> nn.Module | None:
    """The Norm_N module of mvs_tpu's Norm(normalization): Norm (batch),
    GroupNorm (group), or None (none: no parameters)."""
    if normalization == "batch":
        return Norm(channels)
    if normalization == "group":
        return GroupNorm(channels)
    if normalization == "none":
        return None
    raise ValueError(f"unknown normalization {normalization!r}; options: "
                     f"{NORMALIZATIONS}")


class Conv(nn.Module):
    """SAME conv over (B, *S, C), S of rank 2 or 3, stride 1 or 2, odd kernel.

    forward(x, scale, shift, relu) applies relu?(scale * (conv + bias) +
    shift) in f32 and returns x's dtype (``dtype`` when given: x is cast to
    it first). In eval mode every 3x3x3 stride-1 conv runs on the fused
    conv3d kernel (ops.conv3d), which has no gradient; in train mode, and
    for every other shape, torch's conv runs.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride: int = 1, use_bias: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.zeros(out_channels, in_channels, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias \
            else None

    def forward(self, x, scale=None, shift=None, relu: bool = False):
        if self.dtype is not None:
            x = x.to(self.dtype)
        if self.bias is not None:
            if scale is None:
                scale = torch.ones_like(self.bias)
                shift = self.bias
            else:
                shift = shift + scale * self.bias
        ks = tuple(self.kernel.shape[2:])
        shard = current_volume() if ks == (3, 3, 3) else None
        if shard is not None:
            x = halo.extend(x, shard)
        if ks == (3, 3, 3) and self.stride == 1 and not self.training:
            if scale is None:
                scale = torch.ones(self.kernel.shape[0], device=x.device)
                shift = torch.zeros_like(scale)
            y = conv3d_affine(x.contiguous(), self.kernel, scale, shift,
                              relu)
            return y if shard is None else halo.crop(y, shard)
        split = halo.split_dims(shard)
        if split and self.stride == 2:
            x = halo.stride2_input(x, shard)
        # The halo stands in for the padding of a split dim.
        pads = [(0, 0) if d + 1 in split else _same_pads(n, k, self.stride)
                for d, (n, k) in enumerate(zip(x.shape[1:-1], ks))]
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]
        if any(flat):
            x = F.pad(x, (0, 0, *flat))
        conv = F.conv3d if len(ks) == 3 else F.conv2d
        y = conv(x.movedim(-1, 1), self.kernel.to(x.dtype), stride=self.stride)
        return _epilogue(y, scale, shift, relu, x.dtype)


class ConvTranspose(nn.Module):
    """Kernel-3 SAME transposed conv, flax geometry: 3D at stride 2 (out =
    2 * in) or stride 1, or 2D at stride 2 (CascadeFeatureNet's unet
    mode, flax's nn.ConvTranspose there).

    ``kernel`` (I, O, 3, 3[, 3]) is the flax kernel flipped in space (the
    converter flips every ``ConvTranspose_*`` kernel), so that torch's
    conv_transpose cropped to 2x the input reproduces flax's unflipped
    kernel over the 2x-dilated input padded (2, 1). At stride 1 flax's
    transposed conv is a plain SAME conv with the kernel not flipped:
    conv_transpose over the flipped kernel, padding 1, is that conv, and in
    eval mode it runs on the fused conv3d kernel with the flip undone.
    """

    def __init__(self, in_channels: int, out_channels: int, stride: int = 2,
                 rank: int = 3, dtype: torch.dtype | None = None):
        super().__init__()
        if stride not in (1, 2) or (rank == 2 and stride != 2):
            raise ValueError(f"stride must be 1 or 2 (2 in 2D), got {stride}")
        self.stride = stride
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.zeros(in_channels, out_channels, *(3,) * rank))

    def forward(self, x, scale=None, shift=None, relu: bool = False):
        if self.dtype is not None:
            x = x.to(self.dtype)
        if self.kernel.ndim == 4:
            y = F.conv_transpose2d(x.movedim(-1, 1), self.kernel.to(x.dtype),
                                   stride=2)
            _, h, w, _ = x.shape
            return _epilogue(y[:, :, :2 * h, :2 * w], scale, shift, relu,
                             x.dtype)
        shard = current_volume()
        sizes = x.shape[1:4]
        if shard is not None:
            x = halo.extend(x, shard)
        if self.stride == 1:
            if not self.training:
                w = self.kernel.flip(2, 3, 4).transpose(0, 1)
                if scale is None:
                    scale = torch.ones(w.shape[0], device=x.device)
                    shift = torch.zeros_like(scale)
                y = conv3d_affine(x.contiguous(), w, scale, shift, relu)
                return y if shard is None else halo.crop(y, shard)
            # conv_transpose's padding crops its output: one plane more on
            # a split dim, whose halo is there.
            pad = 1 if shard is None else [
                2 - p for p in halo.same_conv_padding(shard)]
            y = F.conv_transpose3d(x.movedim(-1, 1), self.kernel.to(x.dtype),
                                   padding=pad)
            return _epilogue(y, scale, shift, relu, x.dtype)
        y = F.conv_transpose3d(x.movedim(-1, 1), self.kernel.to(x.dtype),
                               stride=2)
        if shard is not None:
            y = halo.transposed_crop(y, shard, sizes)
        else:
            d, h, w = sizes
            y = y[:, :, :2 * d, :2 * h, :2 * w]
        return _epilogue(y, scale, shift, relu, x.dtype)


def _norm_relu_block(block, conv, x):
    """conv + the block's normalization + ReLU (ConvBlock and
    ConvTransposeBlock): batch folded into the conv's epilogue in eval
    mode, group after the conv, none the conv and its ReLU alone."""
    if block.dtype is not None:
        x = x.to(block.dtype)
    if block.normalization == "none":
        return conv(x, relu=True)
    if block.normalization == "group" or block.training:
        return torch.relu(block.Norm_0(conv(x)))
    scale, shift = block.Norm_0.affine()
    return conv(x, scale, shift, relu=True)


class ConvBlock(nn.Module):
    """Conv (2D or 3D by kernel rank) + normalization + ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride: int = 1, normalization: str = "batch",
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.normalization = normalization
        self.dtype = dtype
        norm = make_norm(normalization, out_channels)
        if norm is not None:
            self.Norm_0 = norm
        self.Conv_0 = Conv(in_channels, out_channels, kernel_size, stride,
                           use_bias=False)

    def forward(self, x):
        return _norm_relu_block(self, self.Conv_0, x)


class ConvTransposeBlock(nn.Module):
    """3D kernel-3 transposed conv + normalization + ReLU: a 2x upsample at
    stride 2, or at stride 1 (PyramidCostRegNet's channel-halving block) a
    3x3x3 SAME conv, which in eval mode runs on the fused conv3d kernel with
    the BatchNorm affine (a unit one under "none") and the ReLU in its
    epilogue (ConvTranspose).
    """

    def __init__(self, in_channels: int, out_channels: int, stride: int = 2,
                 normalization: str = "batch",
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.normalization = normalization
        self.dtype = dtype
        norm = make_norm(normalization, out_channels)
        if norm is not None:
            self.Norm_0 = norm
        self.ConvTranspose_0 = ConvTranspose(in_channels, out_channels, stride)

    def forward(self, x):
        return _norm_relu_block(self, self.ConvTranspose_0, x)


class _ConvToF32(torch.autograd.Function):
    """3x3x3 SAME conv of low-precision (B, C, D, H, W) `x` and `w` with an
    f32 result, as the JAX package's conv_folded(out_dtype=f32): the inputs'
    products summed in f32. On the card cuDNN runs it in TF32, which holds
    a bf16 value exactly. The backward, as JAX's, casts the cotangent to
    the inputs' dtype and convolves in it."""

    @staticmethod
    def forward(ctx, x, w, padding):
        ctx.save_for_backward(x, w)
        ctx.padding = padding
        cudnn = torch.backends.cudnn
        saved, cudnn.allow_tf32 = cudnn.allow_tf32, True
        try:
            return F.conv3d(x.float(), w.float(), padding=padding)
        finally:
            cudnn.allow_tf32 = saved

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx, gw, _ = torch.ops.aten.convolution_backward(
            g.to(x.dtype), x, w, None, [1] * 3, list(ctx.padding), [1] * 3,
            False, [0] * 3, 1, [*ctx.needs_input_grad[:2], False])
        return gx, gw, None


class FusedConvBlock3D(BatchStats):
    """3x3x3 stride-1 conv + BatchNorm + ReLU. Owns kernel / scale / bias /
    statistics directly, as the Flax module does.

    Eval mode: one launch of the fused conv3d kernel (ops.conv3d) with the
    BatchNorm folded into its epilogue. Train mode, as the JAX module's
    train branch: torch's conv to f32 (_ConvToF32 for a bf16 input),
    BatchNorm with the batch's moments, ReLU, a cast to the input dtype.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 relu: bool = True):
        super().__init__(out_channels)
        self.relu = relu
        self.kernel = nn.Parameter(
            torch.zeros(out_channels, in_channels, 3, 3, 3))

    def forward(self, x):
        if not self.training:
            scale, shift = self.affine()
            return _fused_conv(x, self.kernel, scale, shift, self.relu)
        y = self.normalize_batch(_conv3d_to_f32(x, self.kernel))
        if self.relu:
            y = torch.relu(y)
        return y.to(x.dtype)


def _fused_conv(x, kernel, scale, shift, relu):
    """The fused conv3d kernel's SAME conv of `x`, on the halo-extended
    slab inside a split volume."""
    shard = current_volume()
    if shard is None:
        return conv3d_affine(x.contiguous(), kernel, scale, shift, relu)
    y = conv3d_affine(halo.extend(x, shard).contiguous(), kernel, scale,
                      shift, relu)
    return halo.crop(y, shard)


def _conv3d_to_f32(x, kernel):
    """Train-mode 3x3x3 SAME conv of channels-last `x` with an f32 result
    (_ConvToF32 for a low-precision input), channels-last; inside a split
    volume the halo-extended slab's, unpadded on the split dims."""
    shard = current_volume()
    padding = [1] * 3
    if shard is not None:
        x = halo.extend(x, shard)
        padding = halo.same_conv_padding(shard)
    x5, w = x.movedim(-1, 1), kernel.to(x.dtype)
    y = F.conv3d(x5, w, padding=padding) if x.dtype == torch.float32 \
        else _ConvToF32.apply(x5, w, padding)
    return y.movedim(1, -1)


class FusedConvBlock3DNoNorm(nn.Module):
    """mvs_tpu's FusedConvBlock3D with normalization='none': the 3x3x3
    stride-1 conv (``kernel`` only) and its ReLU. Eval mode: one launch of
    the fused conv3d kernel with a unit affine. Train mode: torch's conv to
    f32, ReLU, a cast to the input dtype."""

    def __init__(self, in_channels: int, out_channels: int,
                 relu: bool = True):
        super().__init__()
        self.relu = relu
        self.kernel = nn.Parameter(
            torch.zeros(out_channels, in_channels, 3, 3, 3))

    def forward(self, x):
        if not self.training:
            ones = torch.ones(self.kernel.shape[0], device=x.device)
            return _fused_conv(x, self.kernel, ones, torch.zeros_like(ones),
                               self.relu)
        y = _conv3d_to_f32(x, self.kernel)
        if self.relu:
            y = torch.relu(y)
        return y.to(x.dtype)


def conv3_block(in_channels: int, out_channels: int, normalization: str,
                dtype: torch.dtype | None = None) -> tuple[str, nn.Module]:
    """mvs_tpu.nn.cost_reg._conv3: a U-Net's stride-1 3x3x3 block and the
    Flax class name that names its scope. batch and none ride the fused
    conv3d kernel (FusedConvBlock3D, following its input's dtype); group
    is a 3D ConvBlock (conv, GroupNorm, ReLU) casting its input to
    `dtype`."""
    if normalization == "batch":
        return "FusedConvBlock3D", FusedConvBlock3D(in_channels, out_channels)
    if normalization == "none":
        return "FusedConvBlock3D", FusedConvBlock3DNoNorm(in_channels,
                                                          out_channels)
    return "ConvBlock", ConvBlock(in_channels, out_channels, (3, 3, 3),
                                  normalization=normalization, dtype=dtype)


class Dense(nn.Module):
    """Bias-free linear map of the last axis (flax.linen.Dense with
    use_bias=False); ``kernel`` is (out, in), the converter's layout for a
    Flax (in, out) Dense kernel."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(out_features, in_features))

    def forward(self, x):
        return x @ self.kernel.to(x.dtype).t()


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator,
                 trained: bool = True) -> nn.Module:
    """Fill every parameter and statistic from `generator`, in place.

    Kernels have variance 1 / fan_in (lecun). With `trained` they are
    normal, conv biases are small normal and BatchNorm gets a non-trivial
    affine and statistics (scale U(0.5, 1.5), bias N(0, 0.1), mean N(0,
    0.1), var U(0.5, 2)), so a model built this way exercises every
    epilogue term. With trained=False everything is the Flax modules'
    initial state, the start of training: kernels from Flax's lecun_normal
    (a normal truncated at two standard deviations, rescaled to variance
    1 / fan_in), conv biases 0, BatchNorm scale 1 and bias 0, statistics
    mean 0, var 1 and count 0.
    """
    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    def lecun(t, fan_in):
        if trained:
            normal(t, fan_in ** -0.5)
            return
        # jax.nn.initializers.variance_scaling(1, "fan_in",
        # "truncated_normal"): 0.8796... is the standard deviation of a
        # unit normal truncated to [-2, 2].
        std = fan_in ** -0.5 / 0.87962566103423978
        torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                    generator=generator)

    def uniform(t, lo, hi):
        t.copy_(torch.rand(t.shape, generator=generator) * (hi - lo) + lo)

    for m in module.modules():
        if isinstance(m, (Conv, FusedConvBlock3D, FusedConvBlock3DNoNorm,
                          Dense)):
            lecun(m.kernel, m.kernel[0].numel())
        elif isinstance(m, ConvTranspose):
            lecun(m.kernel, m.kernel.shape[0] * m.kernel[0, 0].numel())
        # AttentionConv's relative position embeddings: N(0, 1), as Flax
        # draws them, trained or not.
        for name in ("rel_h", "rel_w"):
            if isinstance(getattr(m, name, None), nn.Parameter):
                normal(getattr(m, name), 1.0)
        if not trained:
            if isinstance(m, _GroupNormAffine):
                m.scale.fill_(1.0)
                m.bias.zero_()
            if isinstance(m, Conv) and m.bias is not None:
                m.bias.zero_()
            if isinstance(m, BatchStats):
                m.scale.fill_(1.0)
                m.bias.zero_()
                m.mean.zero_()
                m.var.fill_(1.0)
                m.count.zero_()
            continue
        if isinstance(m, Conv) and m.bias is not None:
            normal(m.bias, 0.1)
        if isinstance(m, _GroupNormAffine):
            uniform(m.scale, 0.5, 1.5)
            normal(m.bias, 0.1)
        if isinstance(m, BatchStats):
            uniform(m.scale, 0.5, 1.5)
            normal(m.bias, 0.1)
            normal(m.mean, 0.1)
            uniform(m.var, 0.5, 2.0)
    return module
