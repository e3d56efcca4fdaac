"""Cascade feature extractor, FPN mode (counterpart of
mvs_tpu.nn.feature_nets.CascadeFeatureNet with arch_mode='fpn').

(B, H, W, 3) -> {'stage1': (B, H/4, W/4, 4b), 'stage2': (B, H/2, W/2, 2b),
'stage3': (B, H, W, b)}. Submodules carry the Flax auto-names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mvs_tpu_torch.nn.blocks import Conv, ConvBlock

__all__ = ["CascadeFeatureNet"]


def _upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of (B, H, W, C)."""
    y = F.interpolate(x.movedim(-1, 1), scale_factor=2, mode="nearest")
    return y.movedim(1, -1).contiguous()


class CascadeFeatureNet(nn.Module):
    def __init__(self, base_channels: int = 8, num_stages: int = 3):
        super().__init__()
        b = base_channels
        self.num_stages = num_stages
        self.ConvBlock_0 = ConvBlock(3, b, (3, 3))
        self.ConvBlock_1 = ConvBlock(b, b, (3, 3))
        self.ConvBlock_2 = ConvBlock(b, 2 * b, (5, 5), stride=2)
        self.ConvBlock_3 = ConvBlock(2 * b, 2 * b, (3, 3))
        self.ConvBlock_4 = ConvBlock(2 * b, 2 * b, (3, 3))
        self.ConvBlock_5 = ConvBlock(2 * b, 4 * b, (5, 5), stride=2)
        self.ConvBlock_6 = ConvBlock(4 * b, 4 * b, (3, 3))
        self.ConvBlock_7 = ConvBlock(4 * b, 4 * b, (3, 3))
        self.FoldedConv_0 = Conv(4 * b, 4 * b, (1, 1), use_bias=False)
        if num_stages >= 2:
            self.FoldedConv_1 = Conv(2 * b, 4 * b, (1, 1))
            self.FoldedConv_2 = Conv(4 * b, 2 * b, (3, 3), use_bias=False)
        if num_stages == 3:
            self.FoldedConv_3 = Conv(b, 4 * b, (1, 1))
            self.FoldedConv_4 = Conv(4 * b, b, (3, 3), use_bias=False)

    def forward(self, x):
        conv0 = self.ConvBlock_1(self.ConvBlock_0(x))
        conv1 = self.ConvBlock_4(self.ConvBlock_3(self.ConvBlock_2(conv0)))
        conv2 = self.ConvBlock_7(self.ConvBlock_6(self.ConvBlock_5(conv1)))
        outputs = {"stage1": self.FoldedConv_0(conv2)}
        if self.num_stages == 1:
            return outputs
        intra = _upsample2x_nearest(conv2) + self.FoldedConv_1(conv1)
        outputs["stage2"] = self.FoldedConv_2(intra)
        if self.num_stages == 3:
            intra = _upsample2x_nearest(intra) + self.FoldedConv_3(conv0)
            outputs["stage3"] = self.FoldedConv_4(intra)
        return outputs
