"""Model factory from config (counterpart of mvs_tpu.models.registry).

The port has MVSNet, CasMVSNet (FPN features, one cost regularizer per
stage), CVP-MVSNet and AACVP-MVSNet, all with batch norm, for inference
and training. Point-MVSNet raises NotImplementedError naming the
ROADMAP.md item (queue 1) that ports it.
"""

from __future__ import annotations

import torch
from torch import nn

from mvs_tpu_torch.models.cas_mvsnet import CasMVSNet
from mvs_tpu_torch.models.cvp_mvsnet import CVPMVSNet
from mvs_tpu_torch.models.mvsnet import MVSNet

__all__ = ["build_model", "MODEL_NAMES"]

MODEL_NAMES = ("mvsnet", "cas_mvsnet", "cvp_mvsnet", "aacvp_mvsnet",
               "point_mvsnet")
_ROADMAP_ITEM = {"point_mvsnet": 12}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model(cfg, generator: torch.Generator | None = None,
                trained: bool = True) -> nn.Module:
    """cfg: utils.config.Config. Parameters are drawn from `generator`
    (seed 0 when None; trained=False: the initial state to train from);
    load weights to replace them."""
    m = cfg.model
    if m.name in _ROADMAP_ITEM:
        raise NotImplementedError(
            f"model {m.name!r} is not ported yet (ROADMAP.md queue 1, item "
            f"{_ROADMAP_ITEM[m.name]})")
    if m.name not in MODEL_NAMES:
        raise ValueError(f"unknown model {m.name!r}; options: {MODEL_NAMES}")
    if m.normalization != "batch":
        raise NotImplementedError(
            f"the port has batch norm only; got normalization="
            f"{m.normalization!r}")
    if m.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {m.compute_dtype!r}; options: "
                         f"{tuple(_DTYPES)}")
    dtype = _DTYPES[m.compute_dtype]
    if m.name == "mvsnet":
        return MVSNet(base_channels=m.base_channels, refine=m.refine,
                      compute_dtype=dtype, generator=generator,
                      trained=trained)
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
            compute_dtype=dtype, generator=generator, trained=trained)
    if (m.arch_mode, m.share_cr) != ("fpn", False):
        raise NotImplementedError(
            "the port's CasMVSNet has FPN features and one regularizer per "
            f"stage; got arch_mode={m.arch_mode!r}, share_cr={m.share_cr}")
    return CasMVSNet(base_channels=m.base_channels, ndepths=tuple(m.ndepths),
                     depth_interval_ratios=tuple(m.depth_interval_ratios),
                     compute_dtype=dtype, generator=generator,
                     trained=trained)
