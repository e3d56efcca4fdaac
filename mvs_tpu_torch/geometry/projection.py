"""Projection-matrix utilities (counterpart of mvs_tpu.geometry.projection).

Conventions: intrinsics K (..., 3, 3); extrinsics E (..., 4, 4)
world-to-camera; a projection P is the 4x4 matrix with K @ E[:3, :4] in the
top 3 rows and E's last row kept.
"""

from __future__ import annotations

import torch

__all__ = ["compose_projection", "scale_intrinsics", "relative_projection",
           "invert_rigid"]


def compose_projection(intrinsics: torch.Tensor,
                       extrinsics: torch.Tensor) -> torch.Tensor:
    """Pack K (..., 3, 3) and E (..., 4, 4) into the 4x4 projection form."""
    top = intrinsics @ extrinsics[..., :3, :4]
    return torch.cat([top, extrinsics[..., 3:4, :]], dim=-2)


def scale_intrinsics(intrinsics: torch.Tensor, factor) -> torch.Tensor:
    """Scale K's focal/principal rows for an image resize by `factor`."""
    scale = torch.tensor([[factor], [factor], [1.0]], dtype=intrinsics.dtype,
                         device=intrinsics.device)
    return intrinsics * scale


def invert_rigid(extrinsics: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid 4x4 [R|t; 0 1] transform."""
    r_t = extrinsics[..., :3, :3].transpose(-1, -2)
    top = torch.cat([r_t, -r_t @ extrinsics[..., :3, 3:4]], dim=-1)
    return torch.cat([top, extrinsics[..., 3:4, :]], dim=-2)


def relative_projection(src_proj: torch.Tensor,
                        ref_proj: torch.Tensor) -> torch.Tensor:
    """P_src @ P_ref^{-1}: maps ref-camera homogeneous pixel*depth to src."""
    return src_proj @ torch.linalg.inv(ref_proj)
