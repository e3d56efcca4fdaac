"""Convolution building blocks, eval mode, channels-last (counterpart of
mvs_tpu.nn.blocks).

2D features are (B, H, W, C) and 3D volumes (B, D, H, W, C), as in the JAX
package. A torch conv sees them through a permuted view (channels_last
strides), not a copy. Eval-mode BatchNorm is folded into a per-channel affine
applied in the conv's f32 epilogue, followed by an optional ReLU.

Parameter and submodule names follow the Flax scopes (``Conv_0``,
``Norm_0``, ``kernel``, ``scale``, ``bias``, ``mean``, ``var``) so that
``mvs_tpu_torch.convert`` maps a Flax tree onto a state_dict by path. Kernels
are stored in torch layout: (O, I, *k) for convs, (I, O, *k) for transposed
convs.

Geometry follows flax 'SAME': stride-2 padding is asymmetric (lo =
total // 2), and the stride-2 transposed conv is flax's dilated-input form,
which torch expresses as conv_transpose over the flipped kernel cropped to
2x the input (the flip happens in the converter).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mvs_tpu_torch.ops.conv3d import conv3d_affine

__all__ = ["Norm", "Conv", "ConvTranspose", "ConvBlock", "ConvTransposeBlock",
           "FusedConvBlock3D", "init_random_"]

_EPS = 1e-5


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


class Norm(nn.Module):
    """Eval-mode BatchNorm: gamma/beta (``scale``/``bias``) and the debiased
    running statistics (``mean``/``var``), read as one affine."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def affine(self):
        """(scale, shift) with x*scale + shift == BN(x)."""
        return _bn_affine(self.scale, self.bias, self.mean, self.var)


class Conv(nn.Module):
    """SAME conv over (B, *S, C), S of rank 2 or 3, stride 1 or 2, odd kernel.

    forward(x, scale, shift, relu) applies relu?(scale * (conv + bias) +
    shift) in f32 and returns x's dtype. Every 3x3x3 stride-1 conv runs on
    the fused conv3d kernel (ops.conv3d); the rest run on torch's conv.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride: int = 1, use_bias: bool = True):
        super().__init__()
        self.stride = stride
        self.kernel = nn.Parameter(
            torch.zeros(out_channels, in_channels, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias \
            else None

    def forward(self, x, scale=None, shift=None, relu: bool = False):
        if self.bias is not None:
            if scale is None:
                scale = torch.ones_like(self.bias)
                shift = self.bias
            else:
                shift = shift + scale * self.bias
        ks = tuple(self.kernel.shape[2:])
        if ks == (3, 3, 3) and self.stride == 1:
            if scale is None:
                scale = torch.ones(self.kernel.shape[0], device=x.device)
                shift = torch.zeros_like(scale)
            return conv3d_affine(x.contiguous(), self.kernel, scale, shift,
                                 relu)
        pads = [_same_pads(n, k, self.stride)
                for n, k in zip(x.shape[1:-1], ks)]
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]
        if any(flat):
            x = F.pad(x, (0, 0, *flat))
        conv = F.conv3d if len(ks) == 3 else F.conv2d
        y = conv(x.movedim(-1, 1), self.kernel.to(x.dtype), stride=self.stride)
        return _epilogue(y, scale, shift, relu, x.dtype)


class ConvTranspose(nn.Module):
    """3D stride-2 kernel-3 SAME transposed conv (out = 2 * in), flax
    geometry.

    ``kernel`` (I, O, 3, 3, 3) is the flax kernel flipped in space, so that
    torch's conv_transpose cropped to 2x the input reproduces flax's
    unflipped kernel over the 2x-dilated input padded (2, 1).
    """

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.zeros(in_channels, out_channels, 3, 3, 3))

    def forward(self, x, scale=None, shift=None, relu: bool = False):
        y = F.conv_transpose3d(x.movedim(-1, 1), self.kernel.to(x.dtype),
                               stride=2)
        _, d, h, w, _ = x.shape
        return _epilogue(y[:, :, :2 * d, :2 * h, :2 * w], scale, shift, relu,
                         x.dtype)


class ConvBlock(nn.Module):
    """Conv (2D or 3D by kernel rank) + folded BatchNorm + ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride: int = 1):
        super().__init__()
        self.Norm_0 = Norm(out_channels)
        self.Conv_0 = Conv(in_channels, out_channels, kernel_size, stride,
                           use_bias=False)

    def forward(self, x):
        scale, shift = self.Norm_0.affine()
        return self.Conv_0(x, scale, shift, relu=True)


class ConvTransposeBlock(nn.Module):
    """3D stride-2 transposed conv (2x upsample) + folded BatchNorm +
    ReLU."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.Norm_0 = Norm(out_channels)
        self.ConvTranspose_0 = ConvTranspose(in_channels, out_channels)

    def forward(self, x):
        scale, shift = self.Norm_0.affine()
        return self.ConvTranspose_0(x, scale, shift, relu=True)


class FusedConvBlock3D(nn.Module):
    """3x3x3 stride-1 conv + folded BatchNorm + ReLU in one kernel launch
    (ops.conv3d). Owns kernel / scale / bias / statistics directly, as the
    Flax module does."""

    def __init__(self, in_channels: int, out_channels: int,
                 relu: bool = True):
        super().__init__()
        self.relu = relu
        self.kernel = nn.Parameter(
            torch.zeros(out_channels, in_channels, 3, 3, 3))
        self.scale = nn.Parameter(torch.ones(out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.register_buffer("mean", torch.zeros(out_channels))
        self.register_buffer("var", torch.ones(out_channels))

    def forward(self, x):
        scale, shift = _bn_affine(self.scale, self.bias, self.mean, self.var)
        return conv3d_affine(x.contiguous(), self.kernel, scale, shift,
                             self.relu)


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and statistic from `generator`, in place.

    Kernels are normal with variance 1 / fan_in (lecun), conv biases small
    normal, and BatchNorm gets a non-trivial affine and statistics (scale
    U(0.5, 1.5), bias N(0, 0.1), mean N(0, 0.1), var U(0.5, 2)), so a model
    built this way exercises every epilogue term.
    """
    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    def uniform(t, lo, hi):
        t.copy_(torch.rand(t.shape, generator=generator) * (hi - lo) + lo)

    for m in module.modules():
        if isinstance(m, (Conv, FusedConvBlock3D)):
            fan_in = m.kernel[0].numel()
            normal(m.kernel, fan_in ** -0.5)
        elif isinstance(m, ConvTranspose):
            fan_in = m.kernel.shape[0] * m.kernel[0, 0].numel()
            normal(m.kernel, fan_in ** -0.5)
        if isinstance(m, Conv) and m.bias is not None:
            normal(m.bias, 0.1)
        if isinstance(m, (Norm, FusedConvBlock3D)):
            uniform(m.scale, 0.5, 1.5)
            normal(m.bias, 0.1)
            normal(m.mean, 0.1)
            uniform(m.var, 0.5, 2.0)
    return module
