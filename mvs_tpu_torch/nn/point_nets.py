"""Point-MVSNet's networks (counterpart of mvs_tpu.nn.point_nets):
ImageConv, VolumeConv, EdgeConv and SharedMLP, in eval and train mode.

Images are (B, H, W, C) and volumes (B, D, H, W, C), channels last; point
features are (*lead, N, C) and a kNN graph (*lead, N, k) of flat indices
(ops.point_ops.lattice_knn). Submodules carry the Flax modules' scope names
(``ConvBlock_<i>``, ``Norm_0``, ``conv1``, ``Dense_<i>``, ...), so that
convert.flax_to_state_dict maps mvs_tpu's tree by path; a Flax Dense
kernel (in, out) becomes nn.blocks.Dense's (out, in).

In eval mode, BatchNorm is its folded affine: in VolumeConv's stride-1
3x3x3 convs (and its score conv) it rides the fused conv3d kernel's
epilogue (nn.blocks.Conv), elsewhere it is one addcmul before the ReLU.
In train mode every BatchNorm takes the batch's moments over all axes but
the channel, as the JAX modules do (EdgeConv: see its docstring). Every
network takes mvs_tpu's ``normalization``: under "none" no norm, under
"group" nn.blocks.GroupNorm, per sample over every axis but the first.
"""

from __future__ import annotations

import torch
from torch import nn

from mvs_tpu_torch.nn.blocks import (Conv, ConvBlock, ConvTransposeBlock,
                                     Dense, make_norm)
from mvs_tpu_torch.ops.point_ops import gather_neighbors

__all__ = ["ImageConv", "VolumeConv", "EdgeConv", "SharedMLP"]

_K3 = (3, 3, 3)


class ImageConv(nn.Module):
    """4-scale feature tower: {'conv0': b at 1, 'conv1': 2b at 1/2, 'conv2':
    4b at 1/4, 'conv3': 8b at 1/8}; 10 ConvBlocks and a bias-free 3x3
    Conv."""

    # (kernel, stride, channel multiple) of each ConvBlock; the level ends
    # after blocks 1, 4 and 7.
    _BLOCKS = ((3, 1, 1), (3, 1, 1), (5, 2, 2), (3, 1, 2), (3, 1, 2),
               (5, 2, 4), (3, 1, 4), (3, 1, 4), (5, 2, 8), (3, 1, 8))
    _LEVELS = {1: "conv0", 4: "conv1", 7: "conv2"}

    def __init__(self, base_channels: int = 8, normalization: str = "batch"):
        super().__init__()
        cin = 3
        for i, (k, stride, mult) in enumerate(self._BLOCKS):
            setattr(self, f"ConvBlock_{i}",
                    ConvBlock(cin, base_channels * mult, (k, k), stride,
                              normalization))
            cin = base_channels * mult
        self.Conv_0 = Conv(cin, cin, (3, 3), use_bias=False)

    def forward(self, x: torch.Tensor) -> dict:
        out = {}
        for i in range(len(self._BLOCKS)):
            x = getattr(self, f"ConvBlock_{i}")(x)
            if i in self._LEVELS:
                out[self._LEVELS[i]] = x
        out["conv3"] = self.Conv_0(x)
        return out


class VolumeConv(nn.Module):
    """(B, D, H, W, C) -> (B, D, H, W) score: a 3-level U-Net with stride-2
    encoders and a stride-1 block at every level feeding the decoder's
    additive skips; each upsample is cropped to its skip's extent, which
    matters at odd sizes."""

    def __init__(self, in_channels: int, base_channels: int = 8,
                 normalization: str = "batch"):
        super().__init__()
        b = base_channels
        blocks = ((in_channels, b, 1), (in_channels, 2 * b, 2),
                  (2 * b, 4 * b, 2), (4 * b, 8 * b, 2), (2 * b, 2 * b, 1),
                  (4 * b, 4 * b, 1), (8 * b, 8 * b, 1))
        for i, (cin, cout, stride) in enumerate(blocks):
            setattr(self, f"ConvBlock_{i}",
                    ConvBlock(cin, cout, _K3, stride, normalization))
        for i, (cin, cout) in enumerate(((8 * b, 4 * b), (4 * b, 2 * b),
                                         (2 * b, b))):
            setattr(self, f"ConvTransposeBlock_{i}",
                    ConvTransposeBlock(cin, cout,
                                       normalization=normalization))
        self.Conv_0 = Conv(b, 1, _K3, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv0_1 = self.ConvBlock_0(x)
        conv1_0 = self.ConvBlock_1(x)
        conv2_0 = self.ConvBlock_2(conv1_0)
        conv3_0 = self.ConvBlock_3(conv2_0)
        conv1_1 = self.ConvBlock_4(conv1_0)
        conv2_1 = self.ConvBlock_5(conv2_0)
        conv3_1 = self.ConvBlock_6(conv3_0)

        def up_add(y, skip):
            return y[:, :skip.shape[1], :skip.shape[2], :skip.shape[3]] + skip

        y = self.ConvTransposeBlock_0(conv3_1)
        y = self.ConvTransposeBlock_1(up_add(y, conv2_1))
        y = self.ConvTransposeBlock_2(up_add(y, conv1_1))
        return self.Conv_0(up_add(y, conv0_1))[..., 0]


class EdgeConv(nn.Module):
    """DGCNN edge convolution over a kNN graph: x (*lead, N, C_in), nn_idx
    (*lead, N, k) -> (*lead, N, C_out). The message of an edge is
    [central, neighbour - central] (concat_central; C_out = 2 * features)
    or the difference alone, batch-normed, ReLU'd, then averaged over the k
    neighbours.

    The central half of a message is the same for the k edges of a point,
    so it is normalized and ReLU'd once per point, and its BatchNorm
    moments are those of the points (the moments of k equal copies); the
    message is never concatenated. Mathematically mvs_tpu's EdgeConv; the
    sums round in another order. The BatchNorm is one addcmul with the
    folded affine, so a train step saves two copies of the (N, k,
    features) differences (the addcmul's input and the ReLU's output)
    where the concatenated message under BatchNorm's formula would save
    four or more of twice the size.

    Under group norm the message's statistics are taken per sample (the
    first axis) over every other axis, each group of 8 channels of the
    concatenated message: the central half's sums are weighted by k, the
    moments of its k copies. Under "none" the halves are ReLU'd as they
    are."""

    def __init__(self, in_features: int, features: int,
                 concat_central: bool = True, normalization: str = "batch"):
        super().__init__()
        self.concat_central = concat_central
        self.normalization = normalization
        self.conv1 = Dense(in_features, features)
        self.conv2 = Dense(in_features, features)
        norm = make_norm(normalization,
                         2 * features if concat_central else features)
        if norm is not None:
            self.Norm_0 = norm

    def forward(self, x: torch.Tensor, nn_idx: torch.Tensor) -> torch.Tensor:
        central = self.conv1(x)
        diff = gather_neighbors(self.conv2(x), nn_idx) - central[..., None, :]
        parts = (central, diff) if self.concat_central else (diff,)
        if self.normalization != "batch":
            return self._without_batch_norm(parts, nn_idx.shape[-1])
        if self.training:
            moments = [self.Norm_0.batch_moments(p) for p in parts]
            mean = torch.cat([m for m, _ in moments])
            var = torch.cat([v for _, v in moments])
            self.Norm_0.record(mean, var)
            scale, shift = self.Norm_0.affine(mean, var)
        else:
            scale, shift = self.Norm_0.affine()
        out, lo = [], 0
        for part in parts:
            hi = lo + part.shape[-1]
            y = torch.addcmul(shift[lo:hi], part, scale[lo:hi]).relu_()
            out.append(y.mean(dim=-2) if part is diff else y)
            lo = hi
        return torch.cat(out, dim=-1) if len(out) > 1 else out[0]

    def _without_batch_norm(self, parts, k: int) -> torch.Tensor:
        """The message's group norm (or none), ReLU and mean over the k
        neighbours, in both modes."""
        if self.normalization == "group":
            ct = torch.promote_types(parts[0].dtype, torch.float32)
            parts = [p.to(ct) for p in parts]
            sums, sq_sums = [], []
            for p in parts:
                dims = tuple(range(1, p.ndim - 1))
                w = k if p is parts[0] and self.concat_central else 1
                sums.append(w * p.sum(dims))
                sq_sums.append(w * (p * p).sum(dims))
            count = parts[-1][0, ..., 0].numel()
            mean, var = self.Norm_0.moments(torch.cat(sums, -1),
                                            torch.cat(sq_sums, -1), count)
            lo, normed = 0, []
            for p in parts:
                hi = lo + p.shape[-1]
                normed.append(self.Norm_0.normalize(
                    p, mean[:, lo:hi], var[:, lo:hi], slice(lo, hi)))
                lo = hi
            parts = normed
        out = [torch.relu(p) for p in parts]
        out[-1] = out[-1].mean(dim=-2)
        return torch.cat(out, dim=-1) if len(out) > 1 else out[0]


class SharedMLP(nn.Module):
    """Per-point MLP: Dense, normalization and ReLU for each width."""

    def __init__(self, in_features: int, channels,
                 normalization: str = "batch"):
        super().__init__()
        self.depth = len(channels)
        self.normalization = normalization
        for i, c in enumerate(channels):
            setattr(self, f"Dense_{i}", Dense(in_features, c))
            norm = make_norm(normalization, c)
            if norm is not None:
                setattr(self, f"Norm_{i}", norm)
            in_features = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"Dense_{i}")(x)
            if self.normalization == "none":
                x = torch.relu(x)
                continue
            norm = getattr(self, f"Norm_{i}")
            if self.normalization == "group" or self.training:
                x = torch.relu(norm(x))
            else:
                scale, shift = norm.affine()
                x = torch.addcmul(shift, x, scale).relu_()
        return x
