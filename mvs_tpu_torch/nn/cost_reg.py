"""3D cost-volume regularization U-Nets (counterpart of
mvs_tpu.nn.cost_reg), (B, D, H, W, C) volumes.

* UNetCostRegNet: CasMVSNet's per-stage 3-level U-Net;
* PyramidCostRegNet: CVP-MVSNet's 2-level U-Net, one instance shared by
  every pyramid level.

In eval mode their stride-1 blocks (the stride-1 transposed block of
PyramidCostRegNet among them) and the final biased 1-channel score conv run
on the fused conv3d kernel; the stride-2 and stride-2 transposed blocks run
on torch's convs (the JAX package also runs them outside any Pallas
kernel).
"""

from __future__ import annotations

import torch
from torch import nn

from mvs_tpu_torch.nn.blocks import (Conv, ConvBlock, ConvTransposeBlock,
                                     FusedConvBlock3D)

__all__ = ["UNetCostRegNet", "PyramidCostRegNet"]

_K3 = (3, 3, 3)


class UNetCostRegNet(nn.Module):
    """(B, D, H, W, C_in) -> (B, D, H, W) score volume."""

    def __init__(self, in_channels: int, base_channels: int = 8):
        super().__init__()
        b = base_channels
        self.FusedConvBlock3D_0 = FusedConvBlock3D(in_channels, b)
        self.ConvBlock_0 = ConvBlock(b, 2 * b, _K3, stride=2)
        self.FusedConvBlock3D_1 = FusedConvBlock3D(2 * b, 2 * b)
        self.ConvBlock_1 = ConvBlock(2 * b, 4 * b, _K3, stride=2)
        self.FusedConvBlock3D_2 = FusedConvBlock3D(4 * b, 4 * b)
        self.ConvBlock_2 = ConvBlock(4 * b, 8 * b, _K3, stride=2)
        self.FusedConvBlock3D_3 = FusedConvBlock3D(8 * b, 8 * b)
        self.ConvTransposeBlock_0 = ConvTransposeBlock(8 * b, 4 * b)
        self.ConvTransposeBlock_1 = ConvTransposeBlock(4 * b, 2 * b)
        self.ConvTransposeBlock_2 = ConvTransposeBlock(2 * b, b)
        self.FoldedConv_0 = Conv(b, 1, _K3)

    def forward(self, x):
        conv0 = self.FusedConvBlock3D_0(x)
        conv2 = self.FusedConvBlock3D_1(self.ConvBlock_0(conv0))
        conv4 = self.FusedConvBlock3D_2(self.ConvBlock_1(conv2))
        conv6 = self.FusedConvBlock3D_3(self.ConvBlock_2(conv4))
        x = conv4 + self.ConvTransposeBlock_0(conv6)
        x = conv2 + self.ConvTransposeBlock_1(x)
        x = conv0 + self.ConvTransposeBlock_2(x)
        return self.FoldedConv_0(x)[..., 0]


class PyramidCostRegNet(nn.Module):
    """(B, D, H, W, C_in) -> (B, D, H, W) score volume.

    Seven stride-1 blocks (b, b | 2b, 2b | 4b, 4b, 4b), one stride-2 block
    after the first two, a stride-1 transposed block 4b -> 2b added to the
    2b skip and a stride-2 transposed block 2b -> b added to the b skip,
    then the score conv. `dtype` is the compute dtype that the JAX module's
    ConvBlock, ConvTransposeBlock and score conv cast their input to; the
    stride-1 blocks follow their input's dtype, as FusedConvBlock3D does
    there (so an f32 volume keeps the first two blocks in f32).

    D, H and W must be even: the stride-2 block halves them and the stride-2
    transposed block doubles them back onto the skip. The JAX module fails
    at that addition for an odd size; this one raises ValueError first.
    """

    def __init__(self, in_channels: int, base_channels: int = 16,
                 dtype: torch.dtype | None = None):
        super().__init__()
        b = base_channels
        self.dtype = dtype
        for i, (cin, cout) in enumerate((
                (in_channels, b), (b, b), (2 * b, 2 * b), (2 * b, 2 * b),
                (2 * b, 4 * b), (4 * b, 4 * b), (4 * b, 4 * b))):
            setattr(self, f"FusedConvBlock3D_{i}", FusedConvBlock3D(cin, cout))
        self.ConvBlock_0 = ConvBlock(b, 2 * b, _K3, stride=2)
        self.ConvTransposeBlock_0 = ConvTransposeBlock(4 * b, 2 * b, stride=1)
        self.ConvTransposeBlock_1 = ConvTransposeBlock(2 * b, b, stride=2)
        self.FoldedConv_0 = Conv(b, 1, _K3)

    def _cast(self, x):
        return x if self.dtype is None else x.to(self.dtype)

    def forward(self, x):
        if any(n % 2 for n in x.shape[1:4]):
            raise ValueError(
                f"PyramidCostRegNet needs even D, H and W, got "
                f"{tuple(x.shape[1:4])}: its stride-2 block halves them and "
                f"its stride-2 transposed block doubles them back onto the "
                f"skip (mvs_tpu.nn.cost_reg.PyramidCostRegNet fails there "
                f"too). With L pyramid levels the images' H and W must "
                f"divide by 2^L (data.align).")
        blk = [getattr(self, f"FusedConvBlock3D_{i}") for i in range(7)]
        conv0 = blk[1](blk[0](x))
        conv2 = blk[3](blk[2](self.ConvBlock_0(self._cast(conv0))))
        conv4 = blk[6](blk[5](blk[4](conv2)))
        x = conv2 + self.ConvTransposeBlock_0(self._cast(conv4))
        x = conv0 + self.ConvTransposeBlock_1(self._cast(x))
        return self.FoldedConv_0(self._cast(x))[..., 0]
