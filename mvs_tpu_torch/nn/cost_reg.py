"""3D cost-volume regularization U-Net (counterpart of
mvs_tpu.nn.cost_reg.UNetCostRegNet), eval mode, (B, D, H, W, C) volumes.

Its four stride-1 blocks and the final biased 1-channel score conv run on
the fused conv3d kernel; the stride-2 and transposed blocks run on torch's
convs (the JAX package also runs them outside any Pallas kernel).
"""

from __future__ import annotations

from torch import nn

from mvs_tpu_torch.nn.blocks import (Conv, ConvBlock, ConvTransposeBlock,
                                     FusedConvBlock3D)

__all__ = ["UNetCostRegNet"]

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
