"""Model factory from config (counterpart of mvs_tpu.models.registry).

The port has MVSNet, CasMVSNet (FPN or U-Net features, one cost
regularizer per stage or a shared one), CVP-MVSNet, AACVP-MVSNet and
Point-MVSNet, each with model.normalization batch, group or none, for
inference and training. Point-MVSNet is built as mvs_tpu builds it
(image base channels from model.base_channels, its flow scales, interval
factors and test-time sub-flow stride) with model.num_depth_coarse as its
coarse ladder; mvs_tpu's Point-MVSNet has no compute dtype and runs in
f32, so the port refuses another model.compute_dtype for it.
"""

from __future__ import annotations

import torch
from torch import nn

from mvs_tpu_torch.models.cas_mvsnet import CasMVSNet
from mvs_tpu_torch.models.cvp_mvsnet import CVPMVSNet
from mvs_tpu_torch.models.mvsnet import MVSNet
from mvs_tpu_torch.models.point_mvsnet import PointMVSNet
from mvs_tpu_torch.nn.blocks import NORMALIZATIONS

__all__ = ["build_model", "MODEL_NAMES"]

MODEL_NAMES = ("mvsnet", "cas_mvsnet", "cvp_mvsnet", "aacvp_mvsnet",
               "point_mvsnet")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model(cfg, generator: torch.Generator | None = None,
                trained: bool = True) -> nn.Module:
    """cfg: utils.config.Config. Parameters are drawn from `generator`
    (seed 0 when None; trained=False: the initial state to train from);
    load weights to replace them."""
    m = cfg.model
    if m.name not in MODEL_NAMES:
        raise ValueError(f"unknown model {m.name!r}; options: {MODEL_NAMES}")
    if m.normalization not in NORMALIZATIONS:
        raise ValueError(f"unknown normalization {m.normalization!r}; "
                         f"options: {NORMALIZATIONS}")
    if m.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {m.compute_dtype!r}; options: "
                         f"{tuple(_DTYPES)}")
    dtype = _DTYPES[m.compute_dtype]
    if m.name == "point_mvsnet":
        if dtype != torch.float32:
            raise ValueError(
                f"point_mvsnet runs in float32 only (mvs_tpu's Point-MVSNet "
                f"has no compute dtype); got compute_dtype="
                f"{m.compute_dtype!r}")
        return PointMVSNet(img_base_channels=m.base_channels,
                           flow_scales=tuple(m.flow_scales),
                           inter_scales=tuple(m.inter_scales),
                           flow_sub_stride=m.flow_sub_stride,
                           num_depth=m.num_depth_coarse,
                           normalization=m.normalization, generator=generator,
                           trained=trained)
    if m.name == "mvsnet":
        return MVSNet(base_channels=m.base_channels, refine=m.refine,
                      normalization=m.normalization, compute_dtype=dtype,
                      generator=generator, trained=trained)
    if m.name in ("cvp_mvsnet", "aacvp_mvsnet"):
        # As mvs_tpu's registry: AACVP is CVP with the attention feature
        # tail and the group-correlation cost.
        aacvp = m.name == "aacvp_mvsnet"
        return CVPMVSNet(
            num_levels=m.num_levels, coarse_depths=m.coarse_depths,
            num_offsets=m.num_offsets, train_interval=m.train_interval,
            cost_mode="group_correlation" if aacvp else m.cost_mode,
            num_groups=m.num_groups, attention=aacvp or m.attention,
            num_heads=m.num_heads,
            use_epipolar_interval=m.use_epipolar_interval,
            normalization=m.normalization, compute_dtype=dtype,
            generator=generator, trained=trained)
    return CasMVSNet(base_channels=m.base_channels, ndepths=tuple(m.ndepths),
                     depth_interval_ratios=tuple(m.depth_interval_ratios),
                     arch_mode=m.arch_mode, share_cr=m.share_cr,
                     normalization=m.normalization, compute_dtype=dtype,
                     generator=generator, trained=trained)
