"""2D feature extractors (counterpart of mvs_tpu.nn.feature_nets), eval
and train mode, channels-last. Submodules carry the Flax auto-names.

* MVSNetFeatureNet: (B, H, W, 3) -> (B, H/4, W/4, 4b), seven ConvBlocks and
  a plain 3x3 conv with bias (no norm, no ReLU);
* CascadeFeatureNet: (B, H, W, 3) -> {'stage1': (B, H/4, W/4, 4b),
  'stage2': (B, H/2, W/2, 2b), 'stage3': (B, H, W, b)}, the finer stages
  by FPN (arch_mode='fpn': lateral 1x1 convs and nearest upsampling) or
  by U-Net (arch_mode='unet': a stride-2 transposed conv, the skip
  concatenated, a ConvBlock and a 1x1 conv);
* PyramidFeatureNet: CVP-MVSNet's stride-1 extractor, shared by every level
  of the image pyramid, with AACVP-MVSNet's local self-attention
  (AttentionConv) as its last layer when asked.

Every ConvBlock takes mvs_tpu's ``normalization``; ``dtype`` is the compute
dtype that the Flax nets' convs cast their input to (see nn.blocks).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mvs_tpu_torch.nn.blocks import Conv, ConvBlock, ConvTranspose

__all__ = ["MVSNetFeatureNet", "CascadeFeatureNet", "AttentionConv",
           "PyramidFeatureNet"]


def _upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of (B, H, W, C)."""
    y = F.interpolate(x.movedim(-1, 1), scale_factor=2, mode="nearest")
    return y.movedim(1, -1).contiguous()


class _Trunk(nn.Module):
    """ConvBlock_0..6, the layers both MVSNet's and CasMVSNet's feature nets
    open with: two 3x3 blocks at full resolution (b channels), a 5x5
    stride-2 block and two 3x3 blocks at 1/2 (2b), a 5x5 stride-2 block and
    a 3x3 block at 1/4 (4b)."""

    def __init__(self, base_channels: int, normalization: str = "batch",
                 dtype: torch.dtype | None = None):
        super().__init__()
        b = base_channels
        self.kw = dict(normalization=normalization, dtype=dtype)
        self.ConvBlock_0 = ConvBlock(3, b, (3, 3), **self.kw)
        self.ConvBlock_1 = ConvBlock(b, b, (3, 3), **self.kw)
        self.ConvBlock_2 = ConvBlock(b, 2 * b, (5, 5), stride=2, **self.kw)
        self.ConvBlock_3 = ConvBlock(2 * b, 2 * b, (3, 3), **self.kw)
        self.ConvBlock_4 = ConvBlock(2 * b, 2 * b, (3, 3), **self.kw)
        self.ConvBlock_5 = ConvBlock(2 * b, 4 * b, (5, 5), stride=2,
                                     **self.kw)
        self.ConvBlock_6 = ConvBlock(4 * b, 4 * b, (3, 3), **self.kw)

    def trunk(self, x):
        """(full-resolution output of ConvBlock_1, half-resolution output of
        ConvBlock_4, quarter-resolution output of ConvBlock_6)."""
        conv0 = self.ConvBlock_1(self.ConvBlock_0(x))
        conv1 = self.ConvBlock_4(self.ConvBlock_3(self.ConvBlock_2(conv0)))
        return conv0, conv1, self.ConvBlock_6(self.ConvBlock_5(conv1))


class MVSNetFeatureNet(_Trunk):
    """(B, H, W, 3) -> (B, H/4, W/4, 4b): the trunk, then a plain 3x3 conv
    with bias, no norm and no ReLU (FoldedConv_0)."""

    def __init__(self, base_channels: int = 8, normalization: str = "batch",
                 dtype: torch.dtype | None = None):
        super().__init__(base_channels, normalization, dtype)
        b = base_channels
        self.FoldedConv_0 = Conv(4 * b, 4 * b, (3, 3), dtype=dtype)

    def forward(self, x):
        return self.FoldedConv_0(self.trunk(x)[2])


class CascadeFeatureNet(_Trunk):
    def __init__(self, base_channels: int = 8, num_stages: int = 3,
                 arch_mode: str = "fpn", normalization: str = "batch",
                 dtype: torch.dtype | None = None):
        super().__init__(base_channels, normalization, dtype)
        if arch_mode not in ("fpn", "unet"):
            raise ValueError(f"arch_mode must be fpn|unet, got {arch_mode}")
        b = base_channels
        self.num_stages = num_stages
        self.arch_mode = arch_mode
        self.ConvBlock_7 = ConvBlock(4 * b, 4 * b, (3, 3), **self.kw)
        self.FoldedConv_0 = Conv(4 * b, 4 * b, (1, 1), use_bias=False,
                                 dtype=dtype)
        widths = ((4 * b, 2 * b, 2 * b), (2 * b, b, b))[:num_stages - 1]
        for i, (cin, cout, skip) in enumerate(widths):
            if arch_mode == "unet":
                # Flax names: ConvTranspose_i, ConvBlock_{8+i}, Conv_i.
                setattr(self, f"ConvTranspose_{i}",
                        ConvTranspose(cin, cout, rank=2, dtype=dtype))
                setattr(self, f"ConvBlock_{8 + i}",
                        ConvBlock(cout + skip, cout, (3, 3), **self.kw))
                setattr(self, f"Conv_{i}", Conv(cout, cout, (1, 1),
                                                use_bias=False, dtype=dtype))
            else:
                setattr(self, f"FoldedConv_{2 * i + 1}",
                        Conv(skip, 4 * b, (1, 1), dtype=dtype))
                setattr(self, f"FoldedConv_{2 * i + 2}",
                        Conv(4 * b, cout, (3, 3), use_bias=False,
                             dtype=dtype))

    def forward(self, x):
        conv0, conv1, conv2 = self.trunk(x)
        conv2 = self.ConvBlock_7(conv2)
        outputs = {"stage1": self.FoldedConv_0(conv2)}
        if self.num_stages == 1:
            return outputs
        if self.arch_mode == "unet":
            intra = conv2
            for i, skip in enumerate((conv1, conv0)[:self.num_stages - 1]):
                up = getattr(self, f"ConvTranspose_{i}")(intra)
                intra = getattr(self, f"ConvBlock_{8 + i}")(
                    torch.cat([up, skip], dim=-1))
                outputs[f"stage{i + 2}"] = getattr(self, f"Conv_{i}")(intra)
            return outputs
        intra = _upsample2x_nearest(conv2) + self.FoldedConv_1(conv1)
        outputs["stage2"] = self.FoldedConv_2(intra)
        if self.num_stages == 3:
            intra = _upsample2x_nearest(intra) + self.FoldedConv_3(conv0)
            outputs["stage3"] = self.FoldedConv_4(intra)
        return outputs


class AttentionConv(nn.Module):
    """Local-window self-attention, per channel (mvs_tpu.nn.feature_nets.
    AttentionConv): for pixel p and channel c,

        out[p, c] = leaky_relu_0.1(sum_w softmax_w(q[p, c] * (k[p+w, c]
                    + rel[w, c])) v[p+w, c])

    over the k x k window w around p, with 1x1 query / key / value convs,
    keys and values zero-padded past the border, and relative position
    embeddings rel_h (rows) on the first C/2 channels and rel_w (columns) on
    the rest. The f32 embeddings promote the logits to f32 (as in JAX), so
    the layer returns f32 whatever the input dtype.

    Plain PyTorch, as the JAX package leaves it to XLA: the softmax over the
    window is taken in two passes over the k^2 shifted key views (the max,
    then the exponentials and the weighted values), so no (B, H, W, k^2, C)
    tensor is formed. With autograd on, the window's passes are recomputed
    in the backward instead of keeping their ~5 f32 (B, H, W, C) tensors
    per tap (about 12 GiB of a batch-4 640x512 AACVP train step, which then
    no longer fits an 80 GB card reliably).
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 groups: int = 1):
        super().__init__()
        if features % 2 or features % groups:
            raise ValueError(f"features {features} must be even and divide "
                             f"by groups {groups}")
        k = kernel_size
        self.kernel_size = k
        self.query = Conv(in_channels, features, (1, 1), use_bias=False)
        self.key = Conv(in_channels, features, (1, 1), use_bias=False)
        self.value = Conv(in_channels, features, (1, 1), use_bias=False)
        self.rel_h = nn.Parameter(torch.zeros(k, 1, features // 2))
        self.rel_w = nn.Parameter(torch.zeros(1, k, features // 2))

    def forward(self, x):
        k = self.kernel_size
        c = 2 * self.rel_h.shape[-1]
        q = self.query(x).float()
        pad = (0, 0, k // 2, k // 2, k // 2, k // 2)
        key = F.pad(self.key(x), pad)
        val = F.pad(self.value(x), pad)
        rel = torch.cat([self.rel_h.expand(k, k, c // 2),
                         self.rel_w.expand(k, k, c // 2)], dim=-1)
        if torch.is_grad_enabled():
            out = checkpoint(_window_softmax, q, key, val, rel,
                             use_reentrant=False)
        else:
            out = _window_softmax(q, key, val, rel)
        return F.leaky_relu(out, negative_slope=0.1)


def _window_softmax(q, key, val, rel):
    """sum_w softmax_w(q * (key[p+w] + rel[w])) val[p+w] over the k x k
    window (rel (k, k, C)), keys and values padded by k // 2."""
    k = rel.shape[0]
    h, w = q.shape[1:3]

    def logit(dy, dx):
        return q * (key[:, dy:dy + h, dx:dx + w] + rel[dy, dx])

    taps = [(dy, dx) for dy in range(k) for dx in range(k)]
    peak = logit(*taps[0])
    for t in taps[1:]:
        peak = torch.maximum(peak, logit(*t))
    total = torch.zeros_like(peak)
    out = torch.zeros_like(peak)
    for dy, dx in taps:
        e = torch.exp(logit(dy, dx) - peak)
        total += e
        out += e * val[:, dy:dy + h, dx:dx + w]
    return out / total


class PyramidFeatureNet(nn.Module):
    """(B, H, W, 3) -> (B, H, W, out_channels): eight 3x3 ConvBlocks (64, 64,
    64, 32, 32, 32, 16, 16), then a ConvBlock to `out_channels`, or with
    `attention` an AttentionConv (AACVP). One instance serves every level of
    the image pyramid."""

    def __init__(self, out_channels: int = 16, attention: bool = False,
                 num_heads: int = 1, normalization: str = "batch",
                 dtype: torch.dtype | None = None):
        super().__init__()
        kw = dict(normalization=normalization, dtype=dtype)
        widths = (3, 64, 64, 64, 32, 32, 32, 16, 16)
        for i, (cin, cout) in enumerate(zip(widths, widths[1:])):
            setattr(self, f"ConvBlock_{i}", ConvBlock(cin, cout, (3, 3), **kw))
        self.attention = attention
        if attention:
            self.AttentionConv_0 = AttentionConv(16, out_channels, 3,
                                                 num_heads)
        else:
            self.ConvBlock_8 = ConvBlock(16, out_channels, (3, 3), **kw)

    def forward(self, x):
        for i in range(8):
            x = getattr(self, f"ConvBlock_{i}")(x)
        if self.attention:
            return self.AttentionConv_0(x)
        return self.ConvBlock_8(x)
