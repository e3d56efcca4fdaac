"""CVP-MVSNet / AACVP-MVSNet: a cost-volume pyramid, coarse to fine
(counterpart of mvs_tpu.models.cvp_mvsnet.CVPMVSNet), in eval and train
mode.

An image pyramid (x0.5 per level, antialiased bilinear) feeds one
stride-1 feature extractor shared by every level. The coarsest level sweeps
`coarse_depths` uniform hypotheses over [depth_min, depth_max]; each finer
level upsamples the previous depth x2 (Keys cubic, as jax.image.resize) and
sweeps 2 * num_offsets residual hypotheses around it, spaced by the
test-time epipolar interval (one pixel along the first source view's
epipolar line, averaged over the pixels) or the fixed `train_interval`.
One PyramidCostRegNet is shared by every level, and each level regresses
depth and confidence in f32.

CVP-MVSNet builds each level's variance volume with the fused warp-variance
kernel; AACVP-MVSNet (``attention=True``, ``cost_mode="group_correlation"``)
ends the feature net with local self-attention and builds a group-wise
correlation volume with the group-correlation kernel. In eval mode every
stride-1 3D block, the stride-1 transposed block and the score conv of the
regularizer run on the fused conv3d kernel.

In train mode (``model.train()``), as mvs_tpu with ``train=True``: the
shared feature net and regularizer update their BatchNorm statistics once
per level call, in level order, and the upsampled depth keeps its gradient,
so a finer level's loss reaches the coarser levels through the regression
over its hypotheses and through the cost volume's sampling coordinates
(the kernels' hypothesis gradient). Only the epipolar interval is taken
from the depth without a gradient; the coarse ladder has none.
"""

from __future__ import annotations

import torch
from torch import nn

from mvs_tpu_torch.geometry.depth import (epipolar_depth_interval,
                                          residual_depth_hypotheses,
                                          uniform_depth_values)
from mvs_tpu_torch.geometry.projection import (compose_projection,
                                               scale_intrinsics)
from mvs_tpu_torch.geometry.resize import downsample_bilinear, resize_cubic
from mvs_tpu_torch.nn.blocks import init_random_
from mvs_tpu_torch.nn.cost_reg import PyramidCostRegNet
from mvs_tpu_torch.nn.feature_nets import PyramidFeatureNet
from mvs_tpu_torch.ops.group_correlation import group_correlation_volume
from mvs_tpu_torch.ops.regression import regress_depth_and_confidence
from mvs_tpu_torch.ops.warp_variance import fused_variance_volume

__all__ = ["CVPMVSNet"]

COST_MODES = ("variance", "group_correlation")


class CVPMVSNet(nn.Module):
    # cli.infer.stack_model_inputs: (imgs, intrinsics, extrinsics, depth_min,
    # depth_max).
    family = "pyramid"

    def __init__(self, num_levels: int = 2, coarse_depths: int = 48,
                 num_offsets: int = 4, train_interval: float = 6.8085,
                 feature_channels: int = 16, cost_mode: str = "variance",
                 num_groups: int = 4, attention: bool = False,
                 num_heads: int = 1, use_epipolar_interval: bool = False,
                 reg_base_channels: int = 16,
                 normalization: str = "batch",
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None,
                 trained: bool = True):
        """Parameters are drawn from `generator` (seed 0 when None) by
        nn.blocks.init_random_; load converted weights to replace them."""
        super().__init__()
        if cost_mode not in COST_MODES:
            raise ValueError(f"unknown cost_mode {cost_mode!r}; options: "
                             f"{COST_MODES}")
        self.num_levels = num_levels
        self.coarse_depths = coarse_depths
        self.num_offsets = num_offsets
        self.train_interval = train_interval
        self.cost_mode = cost_mode
        self.num_groups = num_groups
        self.use_epipolar_interval = use_epipolar_interval
        self.compute_dtype = compute_dtype
        dt = dict(normalization=normalization, dtype=compute_dtype)
        self.PyramidFeatureNet_0 = PyramidFeatureNet(
            feature_channels, attention, num_heads, **dt)
        volume_channels = (num_groups if cost_mode == "group_correlation"
                           else feature_channels)
        self.PyramidCostRegNet_0 = PyramidCostRegNet(
            volume_channels, reg_base_channels, **dt)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_random_(self, generator, trained)

    def _check_sizes(self, height: int, width: int) -> None:
        """The regularizer halves and doubles every level's D, H and W, so
        all must be even: H and W divisible by 2^num_levels."""
        f = 2 ** self.num_levels
        if height % f or width % f or self.coarse_depths % 2:
            raise ValueError(
                f"CVP-MVSNet with {self.num_levels} levels needs H and W "
                f"divisible by 2^{self.num_levels} = {f} and an even "
                f"coarse_depths, got {height}x{width} and "
                f"{self.coarse_depths}: PyramidCostRegNet's stride-2 block "
                f"and stride-2 transposed block meet on a skip, so every "
                f"level's sizes must be even (mvs_tpu's CVPMVSNet fails "
                f"there too; set data.align to {f})")

    def _cost_volume(self, feats, rel_projs, hyp):
        ref, src = feats[:, 0].contiguous(), feats[:, 1:].contiguous()
        if self.cost_mode == "variance":
            return fused_variance_volume(ref, src, rel_projs, hyp)
        return group_correlation_volume(ref, src, rel_projs, hyp,
                                        self.num_groups)

    def forward(self, imgs: torch.Tensor, intrinsics: torch.Tensor,
                extrinsics: torch.Tensor, depth_min: torch.Tensor,
                depth_max: torch.Tensor) -> dict:
        """imgs (B, V, H, W, 3), view 0 the reference; intrinsics (B, V, 3,
        3) at image resolution; extrinsics (B, V, 4, 4); depth_min /
        depth_max (B,). Returns depth and photometric_confidence (B, H, W)
        and depth_levels, finest first."""
        b, v, h, w, _ = imgs.shape
        self._check_sizes(h, w)
        intrinsics, extrinsics = intrinsics.float(), extrinsics.float()

        feats = []  # level i: (B, V, H / 2^i, W / 2^i, C)
        level_imgs = imgs.to(self.compute_dtype)
        for level in range(self.num_levels):
            lh, lw = level_imgs.shape[2:4]
            f = self.PyramidFeatureNet_0(level_imgs.reshape(b * v, lh, lw, 3))
            feats.append(f.reshape(b, v, lh, lw, -1))
            if level + 1 < self.num_levels:
                level_imgs = downsample_bilinear(level_imgs, lh // 2, lw // 2)

        def level_rel_projs(scale):
            proj = compose_projection(scale_intrinsics(intrinsics, scale),
                                      extrinsics)
            return (proj[:, 1:] @ torch.linalg.inv(proj[:, 0])[:, None]
                    ).contiguous()

        # The coarse sweep: a global ladder, expanded per pixel.
        coarse = feats[-1]
        ch, cw = coarse.shape[2:4]
        interval = (depth_max.float() - depth_min.float()) / (
            self.coarse_depths - 1)
        ladder = uniform_depth_values(depth_min, interval, self.coarse_depths)
        hyp = ladder[:, :, None, None].expand(-1, -1, ch, cw).contiguous()
        volume = self._cost_volume(
            coarse, level_rel_projs(0.5 ** (self.num_levels - 1)), hyp)
        score = self.PyramidCostRegNet_0(volume)
        depth, conf, _ = regress_depth_and_confidence(score.float(), ladder)
        depth_levels = [depth]

        for level in range(self.num_levels - 2, -1, -1):
            lh, lw = feats[level].shape[2:4]
            scale = 0.5 ** level
            # mvs_tpu stops this gradient in eval mode only.
            depth_up = resize_cubic(depth if self.training else depth.detach(),
                                    lh, lw)
            if self.use_epipolar_interval:
                k = scale_intrinsics(intrinsics, scale)
                interval = epipolar_depth_interval(
                    depth_up, k[:, 0], extrinsics[:, 0], k[:, 1],
                    extrinsics[:, 1])
            else:
                interval = torch.full((b,), self.train_interval,
                                      dtype=depth.dtype, device=depth.device)
            hyp = residual_depth_hypotheses(depth_up, interval,
                                            self.num_offsets).contiguous()
            volume = self._cost_volume(feats[level], level_rel_projs(scale),
                                       hyp)
            score = self.PyramidCostRegNet_0(volume)
            depth, conf, _ = regress_depth_and_confidence(score.float(), hyp)
            depth_levels.append(depth)

        return {"depth": depth, "photometric_confidence": conf,
                "depth_levels": depth_levels[::-1]}
