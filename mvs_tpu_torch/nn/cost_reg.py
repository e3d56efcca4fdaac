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

``normalization`` routes each stride-1 block as mvs_tpu's _conv3 does
(nn.blocks.conv3_block): batch and none to the fused block, group to a 3D
ConvBlock. The submodules take Flax's automatic names in call order, so
under group the stride-1 blocks are ConvBlock_i among the stride-2 ones.
``dtype`` is the compute dtype the JAX module's ConvBlocks,
ConvTransposeBlocks and score conv cast their input to.
"""

from __future__ import annotations

import torch
from torch import nn

from mvs_tpu_torch.nn.blocks import (Conv, ConvBlock, ConvTransposeBlock,
                                     conv3_block)

__all__ = ["UNetCostRegNet", "PyramidCostRegNet"]

_K3 = (3, 3, 3)


class _Layers(nn.Module):
    """A U-Net whose layers are named as Flax names them, by class and call
    order; `layers` holds them in call order, the score conv apart."""

    def _build(self, specs, normalization, dtype):
        """specs: ('c3' | 'down' | 'up', cin, cout[, stride]) in call
        order; then the score conv."""
        kw = dict(normalization=normalization, dtype=dtype)
        counts, self.layers = {}, []
        for kind, cin, cout, *stride in specs:
            if kind == "c3":
                cls, m = conv3_block(cin, cout, normalization, dtype)
            elif kind == "down":
                cls, m = "ConvBlock", ConvBlock(cin, cout, _K3, stride=2, **kw)
            else:
                cls, m = "ConvTransposeBlock", ConvTransposeBlock(
                    cin, cout, stride=stride[0], **kw)
            self.add_module(f"{cls}_{counts.get(cls, 0)}", m)
            counts[cls] = counts.get(cls, 0) + 1
            self.layers.append(m)
        self.FoldedConv_0 = Conv(specs[-1][2], 1, _K3, dtype=dtype)


class UNetCostRegNet(_Layers):
    """(B, D, H, W, C_in) -> (B, D, H, W) score volume."""

    def __init__(self, in_channels: int, base_channels: int = 8,
                 normalization: str = "batch",
                 dtype: torch.dtype | None = None):
        super().__init__()
        b = base_channels
        self._build((("c3", in_channels, b), ("down", b, 2 * b),
                     ("c3", 2 * b, 2 * b), ("down", 2 * b, 4 * b),
                     ("c3", 4 * b, 4 * b), ("down", 4 * b, 8 * b),
                     ("c3", 8 * b, 8 * b), ("up", 8 * b, 4 * b, 2),
                     ("up", 4 * b, 2 * b, 2), ("up", 2 * b, b, 2)),
                    normalization, dtype)

    def forward(self, x):
        c = self.layers
        conv0 = c[0](x)
        conv2 = c[2](c[1](conv0))
        conv4 = c[4](c[3](conv2))
        conv6 = c[6](c[5](conv4))
        x = conv4 + c[7](conv6)
        x = conv2 + c[8](x)
        x = conv0 + c[9](x)
        return self.FoldedConv_0(x)[..., 0]


class PyramidCostRegNet(_Layers):
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
                 normalization: str = "batch",
                 dtype: torch.dtype | None = None):
        super().__init__()
        b = base_channels
        self._build((("c3", in_channels, b), ("c3", b, b),
                     ("down", b, 2 * b), ("c3", 2 * b, 2 * b),
                     ("c3", 2 * b, 2 * b), ("c3", 2 * b, 4 * b),
                     ("c3", 4 * b, 4 * b), ("c3", 4 * b, 4 * b),
                     ("up", 4 * b, 2 * b, 1), ("up", 2 * b, b, 2)),
                    normalization, dtype)

    def forward(self, x):
        if any(n % 2 for n in x.shape[1:4]):
            raise ValueError(
                f"PyramidCostRegNet needs even D, H and W, got "
                f"{tuple(x.shape[1:4])}: its stride-2 block halves them and "
                f"its stride-2 transposed block doubles them back onto the "
                f"skip (mvs_tpu.nn.cost_reg.PyramidCostRegNet fails there "
                f"too). With L pyramid levels the images' H and W must "
                f"divide by 2^L (data.align).")
        c = self.layers
        conv0 = c[1](c[0](x))
        conv2 = c[4](c[3](c[2](conv0)))
        conv4 = c[7](c[6](c[5](conv2)))
        x = conv2 + c[8](conv4)
        x = conv0 + c[9](x)
        return self.FoldedConv_0(x)[..., 0]
