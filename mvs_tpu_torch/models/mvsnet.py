"""MVSNet: one plane sweep over a global depth ladder at 1/4 resolution, a
3D U-Net and soft-argmin regression, with an optional residual RefineNet
(counterpart of mvs_tpu.models.mvsnet, eval and train mode).

The features of every view come from one MVSNetFeatureNet pass; the
variance volume over the (B, D) ladder, expanded per pixel, is built by the
fused warp-variance kernel (its backward kernel in train mode; the ladder
takes no gradient, as in the JAX model); UNetCostRegNet regularizes it
(in eval mode its stride-1 convs run on the fused conv3d kernel) and the
depth and confidence are regressed in f32 with the ladder.

With ``volume_constraint`` (parallel.sharding.ShardingPlan
.constrain_volume) a rank builds, regularizes and regresses only its slab
of the volume, as CasMVSNet's stages do; its maps are the rows it holds
(their layout under "shard"), and RefineNet runs on the whole depth map,
gathered over the ranks that split the rows, of which it keeps its rows.
The features' cotangent is summed over the ranks that split the volume
(parallel.collectives.shared) before the feature net's backward; over the
'view' ranks, view_variance sums it (parallel.make_view_variance).
"""

from __future__ import annotations

import torch
from torch import nn

from mvs_tpu_torch.geometry.resize import downsample_bilinear
from mvs_tpu_torch.nn.blocks import ConvBlock, init_random_
from mvs_tpu_torch.nn.cost_reg import UNetCostRegNet
from mvs_tpu_torch.nn.feature_nets import MVSNetFeatureNet
from mvs_tpu_torch.ops.warp_variance import fused_variance_volume
from mvs_tpu_torch.parallel.collectives import (gather_rows,
                                                regress_sharded, shared)
from mvs_tpu_torch.parallel.sharding import use_volume

__all__ = ["MVSNet", "RefineNet"]

# Features at 1/4 resolution, then the U-Net halves D, H and W three times
# and doubles them back onto its skips.
_SIZE_MULTIPLE = 4 * 2 ** 3
_DEPTH_MULTIPLE = 2 ** 3


class RefineNet(nn.Module):
    """Residual depth refinement from the reference image and the depth.

    The image (B, H, W, 3) is brought down to the depth's (B, h, w) with
    jax.image.resize's antialiased bilinear (geometry.resize) and joined to
    the depth in f32, so the four ConvBlocks compute in f32 whatever the
    model's compute dtype (in the JAX model the concatenation with the f32
    depth promotes them). The last block keeps its BatchNorm and ReLU, as
    the JAX module does, so the residual is never negative.
    """

    def __init__(self, normalization: str = "batch"):
        super().__init__()
        for i, (cin, cout) in enumerate(((4, 32), (32, 32), (32, 32),
                                         (32, 1))):
            setattr(self, f"ConvBlock_{i}",
                    ConvBlock(cin, cout, (3, 3), normalization=normalization))

    def forward(self, img: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        h, w = depth.shape[1:]
        small = downsample_bilinear(img, h, w)
        x = torch.cat([small.float(), depth.float()[..., None]], dim=-1)
        x = self.ConvBlock_2(self.ConvBlock_1(self.ConvBlock_0(x)))
        return depth + self.ConvBlock_3(x)[..., 0]


class MVSNet(nn.Module):
    # cli.infer.stack_model_inputs: (imgs, proj_matrices, depth_values).
    family = "single"

    def __init__(self, base_channels: int = 8, refine: bool = False,
                 normalization: str = "batch",
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None,
                 trained: bool = True):
        """Parameters are drawn from `generator` (seed 0 when None) by
        nn.blocks.init_random_ (trained=False: the Flax initial state, to
        train from); load converted weights to replace them."""
        super().__init__()
        self.compute_dtype = compute_dtype
        dt = dict(normalization=normalization, dtype=compute_dtype)
        self.MVSNetFeatureNet_0 = MVSNetFeatureNet(base_channels, **dt)
        self.UNetCostRegNet_0 = UNetCostRegNet(4 * base_channels, **dt)
        self.RefineNet_0 = RefineNet(normalization) if refine else None
        # Optional function that builds the variance volume in place of
        # the fused kernel, same arguments
        # (parallel.collectives.make_view_variance).
        self.view_variance = None
        # Optional fn((B, D, H, W, C) shape) -> the VolumeShard this rank
        # builds of the volume, or None for the whole volume.
        self.volume_constraint = None
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_random_(self, generator, trained)

    def forward(self, imgs: torch.Tensor, proj_matrices: torch.Tensor,
                depth_values: torch.Tensor) -> dict:
        """imgs (B, V, H, W, 3), view 0 the reference; proj_matrices
        (B, V, 4, 4) at feature (1/4) resolution; depth_values (B, D), the
        ladder. Returns depth, photometric_confidence (B, H/4, W/4) and
        prob_volume (B, D, H/4, W/4), and refined_depth with RefineNet."""
        b, v, h, w, _ = imgs.shape
        d = depth_values.shape[1]
        if h % _SIZE_MULTIPLE or w % _SIZE_MULTIPLE or d % _DEPTH_MULTIPLE:
            raise ValueError(
                f"MVSNet needs H and W divisible by {_SIZE_MULTIPLE} and D "
                f"by {_DEPTH_MULTIPLE}, got {h}x{w} and D={d}: the features "
                f"are at 1/4 resolution and UNetCostRegNet halves D, H and W "
                f"three times and doubles them back onto its skips "
                f"(mvs_tpu's MVSNet fails at those additions; set "
                f"data.align to {_SIZE_MULTIPLE})")
        feats = self.MVSNetFeatureNet_0(
            imgs.reshape(b * v, h, w, 3).to(self.compute_dtype))
        fh, fw = feats.shape[1:3]
        feats = feats.reshape(b, v, fh, fw, -1)
        proj = proj_matrices.float()
        rel_projs = (proj[:, 1:] @ torch.linalg.inv(proj[:, 0])[:, None]
                     ).contiguous()
        ladder = depth_values.float()
        shard = None if self.volume_constraint is None else \
            self.volume_constraint((b, d, fh, fw, feats.shape[-1]))
        if shard is not None:
            feats = shared(feats, shard.sample_group)
        ref, row0, rows = feats[:, 0], 0, fh
        if shard is not None:  # this rank's rows and depth slab
            ref, ladder = shard.take(ref, {2: 1}), shard.take(ladder, {1: 1})
            row0, rows = shard.slices({2: 1})[1].start or 0, ref.shape[1]
        hyp = ladder[:, :, None, None].expand(-1, -1, rows, fw).contiguous()
        volume = (self.view_variance or fused_variance_volume)(
            ref.contiguous(), feats[:, 1:].contiguous(), rel_projs, hyp,
            row0=row0)
        if shard is not None and shard.split(3) is not None:
            # Columns split: the warp's row window spans whole rows.
            volume = shard.take(volume, {3: 3})
        with use_volume(shard):
            score = self.UNetCostRegNet_0(volume)
        depth, conf, prob = regress_sharded(score.float(), ladder, shard)
        out = {"depth": depth, "photometric_confidence": conf,
               "prob_volume": prob}
        if shard is not None:
            out["shard"] = shard.map_shard()
        if self.RefineNet_0 is not None:
            whole = depth if shard is None else gather_rows(depth,
                                                            out["shard"])
            refined = self.RefineNet_0(imgs[:, 0].to(self.compute_dtype),
                                       whole)
            out["refined_depth"] = refined if shard is None else \
                out["shard"].take(refined)
        return out
