"""Model factory from config (counterpart of mvs_tpu.models.registry).

The port has CasMVSNet (FPN features, one cost regularizer per stage, batch
norm). Other families and variants raise NotImplementedError naming the
ROADMAP.md item (queue 1) that ports them.
"""

from __future__ import annotations

import torch

from mvs_tpu_torch.models.cas_mvsnet import CasMVSNet

__all__ = ["build_model", "MODEL_NAMES"]

MODEL_NAMES = ("mvsnet", "cas_mvsnet", "cvp_mvsnet", "aacvp_mvsnet",
               "point_mvsnet")
_ROADMAP_ITEM = {"mvsnet": 10, "cvp_mvsnet": 11, "aacvp_mvsnet": 11,
                 "point_mvsnet": 12}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model(cfg, generator: torch.Generator | None = None,
                trained: bool = True) -> CasMVSNet:
    """cfg: utils.config.Config. Parameters are drawn from `generator`
    (seed 0 when None; trained=False: the initial state to train from);
    load weights to replace them."""
    m = cfg.model
    if m.name in _ROADMAP_ITEM:
        raise NotImplementedError(
            f"model {m.name!r} is not ported yet (ROADMAP.md queue 1, item "
            f"{_ROADMAP_ITEM[m.name]})")
    if m.name != "cas_mvsnet":
        raise ValueError(f"unknown model {m.name!r}; options: {MODEL_NAMES}")
    if (m.arch_mode, m.share_cr, m.normalization) != ("fpn", False, "batch"):
        raise NotImplementedError(
            "the port's CasMVSNet has FPN features, one regularizer per stage "
            f"and batch norm; got arch_mode={m.arch_mode!r}, "
            f"share_cr={m.share_cr}, normalization={m.normalization!r}")
    if m.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {m.compute_dtype!r}; options: "
                         f"{tuple(_DTYPES)}")
    return CasMVSNet(base_channels=m.base_channels, ndepths=tuple(m.ndepths),
                     depth_interval_ratios=tuple(m.depth_interval_ratios),
                     compute_dtype=_DTYPES[m.compute_dtype],
                     generator=generator, trained=trained)
