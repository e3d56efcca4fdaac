"""Point-MVSNet: a coarse 1/8-resolution cost volume, then PointFlow
refinement (counterpart of mvs_tpu.models.point_mvsnet.PointMVSNet), f32,
in eval and train mode.

Coarse stage: ImageConv features at 1/8 of the images; the variance volume
over a fronto-parallel ladder of `num_depth` hypotheses, on the
warp-variance kernel through ops.point_ops.point_sweep_projections (the
reference view's own features put in directly, as mvs_tpu does);
VolumeConv, whose stride-1 3x3x3 convs run on the fused conv3d kernel in
eval mode; softmax(-score) in f32, the soft-argmin and the 2-tap
probability map at the regressed index.

PointFlow, per iteration (flow_scales, inter_scales): the depth upsampled
(nearest) to the flow resolution; 5 hypotheses per pixel at {-2..2} x the
iteration's interval; per hypothesis point the variance of ImageConv's
conv1-conv3 (bilinear-resized to the flow resolution) over the views, one
warp-variance launch per level with per-pixel hypotheses, and the
normalised xyz tiled x8; a lattice kNN over the 5x5x5 window; three
EdgeConvs, a SharedMLP and a Dense head score the offsets; the expected
offset under softmax(-score) moves the depth. In eval mode with
flow_sub_stride s > 1 (and the flow sizes divisible by s) the kNN graph and
the networks run on each of the s^2 interleaved sub-lattices, as
mvs_tpu's tiled sub-flow does; the variance features and xyz are
pointwise, so they are computed once on the full lattice and sliced (the
world points of a sub-lattice from its own 0.5-centred grid, as mvs_tpu
maps it).

Train mode follows mvs_tpu with train=True: the flow's depth and pyramid
keep their gradients (the warp's backward then gives the hypotheses'
gradient), every BatchNorm takes the batch's moments, and there is no
tiling.
"""

from __future__ import annotations

import torch
from torch import nn

from mvs_tpu_torch.geometry.projection import invert_rigid, scale_intrinsics
from mvs_tpu_torch.geometry.resize import downsample_bilinear, resize_nearest
from mvs_tpu_torch.nn.blocks import Dense, init_random_
from mvs_tpu_torch.nn.point_nets import (EdgeConv, ImageConv, SharedMLP,
                                         VolumeConv)
from mvs_tpu_torch.ops.point_ops import (lattice_knn, point_pixel_grid,
                                         point_sweep_projections)
from mvs_tpu_torch.ops.warp_variance import fused_variance_volume

__all__ = ["PointMVSNet"]

_OFFSETS = (-2.0, -1.0, 0.0, 1.0, 2.0)
_FLOW_LEVELS = ("conv1", "conv2", "conv3")
# mvs_tpu's defaults, which its registry never changes: VolumeConv's base
# width, the flow MLP's widths and head, the kNN's k, the coarse stride.
_VOL_BASE, _FLOW_CHANNELS, _K, _COARSE_STRIDE = 8, (64, 64, 16, 1), 16, 8


def _unproject(k_inv, extr_inv, depths, height, width):
    """World points (B, 3, *S, N) of the lattice's 0.5-centred pixels at
    depths (B, *S, N): uv = K^-1 p, cam = uv d, world = E^-1 [cam; 1], in
    mvs_tpu's order of operations."""
    uv = k_inv @ point_pixel_grid(height, width, depths.dtype, depths.device)
    lead = (1,) * (depths.ndim - 2)
    cam = uv.reshape(uv.shape[0], 3, *lead, -1) * depths[:, None]
    cam_h = torch.cat([cam, torch.ones_like(cam[:, :1])], dim=1)
    shape = cam_h.shape
    world = extr_inv @ cam_h.reshape(shape[0], 4, -1)
    return world[:, :3].reshape(shape[0], 3, *shape[2:])


class PointMVSNet(nn.Module):
    # cli.infer.stack_model_inputs: (imgs, intrinsics, extrinsics,
    # depth_min, depth_interval).
    family = "point"

    def __init__(self, img_base_channels: int = 8,
                 flow_scales=(0.25, 0.5), inter_scales=(0.75, 0.375),
                 flow_sub_stride: int = 1, num_depth: int = 48,
                 normalization: str = "batch",
                 generator: torch.Generator | None = None,
                 trained: bool = True):
        """Parameters are drawn from `generator` (seed 0 when None) by
        nn.blocks.init_random_; load converted weights to replace them.
        `num_depth` is the coarse ladder's length when forward is not given
        one."""
        super().__init__()
        self.flow_scales = tuple(flow_scales)
        self.inter_scales = tuple(inter_scales)
        self.flow_sub_stride = flow_sub_stride
        self.num_depth = num_depth
        b = img_base_channels
        n = normalization
        self.coarse_img_conv = ImageConv(b, n)
        self.coarse_vol_conv = VolumeConv(8 * b, _VOL_BASE, n)
        self.flow_img_conv = ImageConv(b, n)
        # conv1-conv3 variances and the xyz tiled x8.
        point_channels = (2 + 4 + 8) * b + 24
        self.edge_conv0 = EdgeConv(point_channels, 32, False, n)
        self.edge_conv1 = EdgeConv(32, 32, normalization=n)
        self.edge_conv2 = EdgeConv(64, 64, normalization=n)
        self.flow_mlp = SharedMLP(32 + 64 + 128, _FLOW_CHANNELS[:-1], n)
        self.flow_head = Dense(_FLOW_CHANNELS[-2], _FLOW_CHANNELS[-1])
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_random_(self, generator, trained)

    def forward(self, imgs: torch.Tensor, intrinsics: torch.Tensor,
                extrinsics: torch.Tensor, depth_start: torch.Tensor,
                depth_interval: torch.Tensor, num_depth: int | None = None,
                xyz_mean: torch.Tensor | None = None,
                xyz_std: torch.Tensor | None = None,
                use_flow: bool = True) -> dict:
        """imgs (B, V, H, W, 3), view 0 the reference; intrinsics (B, V, 3,
        3) at image resolution; extrinsics (B, V, 4, 4); depth_start and
        depth_interval (B,); xyz_mean / xyz_std (B, 3) normalise the flow's
        xyz (0 / 1 when None). Returns coarse_depth and coarse_prob_map
        (B, H/8, W/8), world_points (B, 3, D * H/8 * W/8), flow{i} and
        flow{i}_prob per iteration, and depth (the last flow, or the coarse
        depth without the flow)."""
        num_depth = self.num_depth if num_depth is None else num_depth
        b, v, h, w, _ = imgs.shape
        imgs = imgs.float()
        intrinsics, extrinsics = intrinsics.float(), extrinsics.float()
        depth_start, depth_interval = depth_start.float(), \
            depth_interval.float()
        if xyz_mean is None:
            xyz_mean = imgs.new_zeros((b, 3))
        if xyz_std is None:
            xyz_std = imgs.new_ones((b, 3))
        extr_inv = invert_rigid(extrinsics)

        # ---- coarse stage ----
        feats = self.coarse_img_conv(imgs.reshape(b * v, h, w, 3))["conv3"]
        fh, fw, fc = feats.shape[1:]
        feats = feats.reshape(b, v, fh, fw, fc)
        ladder = depth_start[:, None] + depth_interval[:, None] * torch.arange(
            num_depth, dtype=depth_interval.dtype, device=imgs.device)
        volume = fused_variance_volume(
            feats[:, 0].contiguous(), feats[:, 1:].contiguous(),
            point_sweep_projections(intrinsics, extrinsics,
                                    1.0 / _COARSE_STRIDE),
            ladder[:, :, None, None].expand(-1, -1, fh, fw).contiguous())
        k_feat = scale_intrinsics(intrinsics, 1.0 / _COARSE_STRIDE)
        world = _unproject(
            torch.linalg.inv(k_feat[:, 0]), extr_inv[:, 0],
            ladder[:, :, None].expand(-1, -1, fh * fw), fh, fw)
        score = self.coarse_vol_conv(volume)
        prob = torch.softmax(-score.float(), dim=1)  # (B, D, fh, fw)
        depth = torch.sum(prob * ladder[:, :, None, None], dim=1)
        idx = (depth - depth_start[:, None, None]) / \
            depth_interval[:, None, None]
        lo = torch.clamp(torch.floor(idx), 0, num_depth - 1).long()
        hi = torch.clamp(torch.ceil(idx), 0, num_depth - 1).long()
        prob_map = (prob.gather(1, lo[:, None]) + prob.gather(1, hi[:, None])
                    )[:, 0]
        preds = {"coarse_depth": depth, "coarse_prob_map": prob_map,
                 "world_points": world.reshape(b, 3, -1)}
        if not use_flow:
            preds["depth"] = depth
            return preds

        # ---- PointFlow ----
        pyramid = self.flow_img_conv(imgs.reshape(b * v, h, w, 3))
        if not self.training:
            pyramid = {c: pyramid[c].detach() for c in _FLOW_LEVELS}
        offsets = torch.tensor(_OFFSETS, device=imgs.device)
        for it, (scale, inter_scale) in enumerate(zip(self.flow_scales,
                                                      self.inter_scales)):
            sh, sw = int(h * scale), int(w * scale)
            interval = inter_scale * depth_interval  # (B,)
            depth_flow = resize_nearest(depth, sh, sw)
            if not self.training:
                depth_flow = depth_flow.detach()
            steps = offsets[None, :, None, None] * interval[:, None, None,
                                                            None]
            hyp = (depth_flow[:, None] + steps).contiguous()  # (B, 5, sh, sw)
            rel = point_sweep_projections(intrinsics, extrinsics, scale)
            variances = []
            for c in _FLOW_LEVELS:
                lf = downsample_bilinear(pyramid[c], sh, sw).reshape(
                    b, v, sh, sw, -1)
                variances.append(fused_variance_volume(
                    lf[:, 0].contiguous(), lf[:, 1:].contiguous(), rel, hyp))
            k_inv = torch.linalg.inv(scale_intrinsics(intrinsics, scale)[:, 0])
            s = self.flow_sub_stride if not self.training else 1
            if s > 1 and sh % s == 0 and sw % s == 0:
                delta = torch.zeros_like(depth_flow)
                flow_prob = depth_flow.new_zeros((b, len(_OFFSETS), sh, sw))
                for iy in range(s):
                    for ix in range(s):
                        # Sub-lattice pixel centre u maps to the full
                        # lattice's s * u + (i + 0.5 - 0.5 * s).
                        affine = torch.tensor(
                            [[s, 0.0, ix + 0.5 - 0.5 * s],
                             [0.0, s, iy + 0.5 - 0.5 * s],
                             [0.0, 0.0, 1.0]], device=imgs.device)
                        sub = (slice(None), slice(None), slice(iy, None, s),
                               slice(ix, None, s))
                        d_sub, p_sub = self._flow(
                            [x[sub] for x in variances], hyp[sub],
                            k_inv @ affine, extr_inv[:, 0], xyz_mean,
                            xyz_std, interval)
                        delta[:, iy::s, ix::s] = d_sub
                        flow_prob[:, :, iy::s, ix::s] = p_sub
            else:
                delta, flow_prob = self._flow(variances, hyp, k_inv,
                                              extr_inv[:, 0], xyz_mean,
                                              xyz_std, interval)
            depth = depth_flow + delta
            preds[f"flow{it + 1}"] = depth
            preds[f"flow{it + 1}_prob"] = flow_prob
        preds["depth"] = depth
        return preds

    def _flow(self, variances, hyp, k_inv, ref_extr_inv, xyz_mean, xyz_std,
              interval):
        """The flow body on one pixel lattice: variances [(B, 5, gh, gw,
        C_l)], hyp (B, 5, gh, gw), k_inv (B, 3, 3) taking the lattice's
        0.5-centred pixels to rays. Returns (delta (B, gh, gw), flow_prob
        (B, 5, gh, gw))."""
        b, n_off, gh, gw = hyp.shape
        world = _unproject(k_inv, ref_extr_inv, hyp.reshape(b, n_off, -1),
                           gh, gw)  # (B, 3, 5, N)
        xyz = (world - xyz_mean[:, :, None, None]) / xyz_std[:, :, None, None]
        tiled = xyz.permute(0, 2, 3, 1).repeat(1, 1, 1, 8)  # (B, 5, N, 24)
        feats = torch.cat([x.reshape(b, n_off, gh * gw, -1)
                           for x in variances] + [tiled], dim=-1)
        x = feats.reshape(b, n_off * gh * gw, -1)
        nn_idx = lattice_knn(xyz.detach().reshape(b, 3, n_off, gh, gw),
                             kernel_size=n_off, k=_K)
        outs = []
        for ec in (self.edge_conv0, self.edge_conv1, self.edge_conv2):
            x = ec(x, nn_idx)
            outs.append(x)
        flow = self.flow_head(self.flow_mlp(torch.cat(outs, dim=-1)))
        flow_prob = torch.softmax(-flow.float().reshape(b, n_off, gh, gw),
                                  dim=1)
        offsets = torch.tensor(_OFFSETS, device=hyp.device)
        delta = torch.sum(flow_prob * (offsets[None, :, None, None]
                                       * interval[:, None, None, None]),
                          dim=1)
        return delta, flow_prob
