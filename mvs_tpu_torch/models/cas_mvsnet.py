"""CasMVSNet: a 3-stage cascade of narrowing plane sweeps (counterpart of
mvs_tpu.models.cas_mvsnet.CasMVSNet with grad_method 'detach'): FPN or
U-Net features (arch_mode), one cost regularizer per stage or, with
share_cr, a 1x1x1 projection per stage (cr_inproj_stageK, to 4 * base
channels, a plain conv) into one shared U-Net (cost_reg_shared), and
mvs_tpu's normalization (batch, group or none).

Stage 1 sweeps the global range at 1/4 resolution; stages 2 and 3 sweep
per-pixel windows (+-D/2 * ratio * base interval) centred on the bilinearly
upsampled previous depth. Each stage builds its variance volume with the
fused warp-variance kernel, regularizes it with a 3D U-Net, and regresses
depth and confidence in f32. `model.eval()` runs the U-Nets' stride-1 convs
on the fused conv3d kernel; `model.train()` runs the blocks' train paths
(batch statistics, torch convs) and the warp's backward kernel, and each
stage's depth is detached before it centres the next stage's hypotheses,
as the JAX model does in training.

With ``volume_constraint`` (parallel.sharding.ShardingPlan
.constrain_volume, where mvs_tpu puts its sharding constraint) a rank
builds only its slab of each stage's volume, on the warp kernel's row
window, and regularizes and regresses it over the ranks that hold the
other slabs; each stage's outputs are the rows it holds, with their
layout under "shard", and the next stage upsamples the whole depth map,
gathered over the ranks that split the rows. Each stage's features'
cotangent is summed over the ranks that split the volume
(parallel.collectives.shared) before the feature net's backward; over the
'view' ranks, view_variance sums it (parallel.make_view_variance).
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mvs_tpu_torch.geometry.depth import cascade_depth_samples
from mvs_tpu_torch.nn.blocks import Conv, init_random_
from mvs_tpu_torch.nn.cost_reg import UNetCostRegNet
from mvs_tpu_torch.nn.feature_nets import CascadeFeatureNet
from mvs_tpu_torch.ops.warp_variance import fused_variance_volume
from mvs_tpu_torch.parallel.collectives import (gather_rows,
                                                regress_sharded, shared)
from mvs_tpu_torch.parallel.sharding import use_volume

__all__ = ["CasMVSNet"]


class CasMVSNet(nn.Module):
    # cli.infer.stack_model_inputs: (imgs, proj_matrices, depth_values).
    family = "cascade"

    def __init__(self, base_channels: int = 8,
                 ndepths: Sequence[int] = (48, 32, 8),
                 depth_interval_ratios: Sequence[float] = (4.0, 2.0, 1.0),
                 arch_mode: str = "fpn", share_cr: bool = False,
                 normalization: str = "batch",
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None,
                 trained: bool = True):
        """Parameters are drawn from `generator` (seed 0 when None) by
        nn.blocks.init_random_ (trained=False: the Flax initial state, to
        train from); load converted weights to replace them."""
        super().__init__()
        self.ndepths = tuple(ndepths)
        self.depth_interval_ratios = tuple(depth_interval_ratios)
        self.compute_dtype = compute_dtype
        self.share_cr = share_cr
        num_stages = len(self.ndepths)
        dt = dict(normalization=normalization, dtype=compute_dtype)
        self.CascadeFeatureNet_0 = CascadeFeatureNet(base_channels, num_stages,
                                                     arch_mode, **dt)
        for i in range(num_stages):
            stage_channels = base_channels * 4 // 2 ** i
            if share_cr:
                setattr(self, f"cr_inproj_stage{i + 1}",
                        Conv(stage_channels, 4 * base_channels, (1, 1, 1),
                             use_bias=False, dtype=compute_dtype))
            else:
                setattr(self, f"cost_reg_stage{i + 1}",
                        UNetCostRegNet(stage_channels, base_channels, **dt))
        if share_cr:
            self.cost_reg_shared = UNetCostRegNet(4 * base_channels,
                                                  base_channels, **dt)
        # Optional function that builds each stage's variance volume in
        # place of the fused kernel, same arguments
        # (parallel.collectives.make_view_variance: the source views split
        # over the mesh 'view' axis, one all-reduce of the partial sums).
        self.view_variance = None
        # Optional fn((B, D, H, W, C) shape) -> the VolumeShard this rank
        # builds of a stage's volume, or None for the whole volume.
        self.volume_constraint = None
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_random_(self, generator, trained)

    def forward(self, imgs: torch.Tensor, proj_matrices: dict,
                depth_values: torch.Tensor) -> dict:
        """imgs (B, V, H, W, 3); proj_matrices {'stageK': (B, V, 4, 4)} at
        stage resolution; depth_values (B, D_total), the global ladder that
        sets the range and the base interval."""
        b, v, h, w, _ = imgs.shape
        depth_values = depth_values.float()
        # Divided by D, not D - 1, as the JAX model does.
        depth_interval = ((depth_values[:, -1] - depth_values[:, 0])
                          / depth_values.shape[1])
        feats = self.CascadeFeatureNet_0(
            imgs.reshape(b * v, h, w, 3).to(self.compute_dtype))

        outputs = {}
        depth = None
        for i, ndepth in enumerate(self.ndepths):
            stage = f"stage{i + 1}"
            f = feats[stage]
            f = f.reshape(b, v, *f.shape[1:])
            sh, sw = f.shape[2:4]
            proj = proj_matrices[stage].float()
            rel_projs = proj[:, 1:] @ torch.linalg.inv(proj[:, 0])[:, None]
            if depth is None:
                cur_depth = depth_values
            else:
                cur_depth = F.interpolate(depth.detach()[:, None],
                                          size=(sh, sw), mode="bilinear",
                                          align_corners=False)[:, 0]
            interval = self.depth_interval_ratios[i] * depth_interval
            hyp = cascade_depth_samples(cur_depth, ndepth, interval, sh,
                                        sw).contiguous()
            shard = None if self.volume_constraint is None else \
                self.volume_constraint((b, ndepth, sh, sw, f.shape[-1]))
            if shard is not None:
                f = shared(f, shard.sample_group)
            ref, row0 = f[:, 0], 0
            if shard is not None:  # this rank's rows and depth slab
                ref, hyp = shard.take(ref, {2: 1}), shard.take(hyp, {1: 1, 2: 2})
                row0 = shard.slices({2: 1})[1].start or 0
            volume = (self.view_variance or fused_variance_volume)(
                ref.contiguous(), f[:, 1:].contiguous(),
                rel_projs.contiguous(), hyp.contiguous(), row0=row0)
            if shard is not None and shard.split(3) is not None:
                # Columns split: the warp's row window spans whole rows.
                volume = shard.take(volume, {3: 3})
                hyp = shard.take(hyp, {3: 3})
            with use_volume(shard):
                if self.share_cr:
                    score = self.cost_reg_shared(
                        getattr(self, f"cr_inproj_{stage}")(volume))
                else:
                    score = getattr(self, f"cost_reg_{stage}")(volume)
            depth, conf, prob = regress_sharded(score.float(), hyp, shard)
            outputs[stage] = {"depth": depth, "photometric_confidence": conf,
                              "prob_volume": prob}
            if shard is not None:
                maps = outputs[stage]["shard"] = shard.map_shard()
                if i + 1 < len(self.ndepths):
                    depth = gather_rows(depth, maps)
        last = outputs[stage]
        outputs["depth"] = last["depth"]
        outputs["photometric_confidence"] = conf
        if "shard" in last:
            outputs["shard"] = last["shard"]
        return outputs
