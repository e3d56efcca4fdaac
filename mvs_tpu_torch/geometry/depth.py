"""Depth hypotheses (counterpart of mvs_tpu.geometry.depth, with the batch
written out): the inverse-depth ladder, the cascade's per-pixel windows,
the pyramid's uniform coarse ladder and residual refinement hypotheses,
and the test-time epipolar interval of CVP-MVSNet."""

from __future__ import annotations

import torch

from mvs_tpu_torch.geometry.homography import pixel_grid
from mvs_tpu_torch.geometry.projection import compose_projection

__all__ = ["inverse_depth_values", "cascade_depth_samples",
           "uniform_depth_values",
           "residual_depth_hypotheses", "epipolar_depth_interval"]


def inverse_depth_values(depth_min, depth_max, num_depth: int,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., D) ladders uniform in 1 / depth, nearest first: the reversed
    reciprocals of D even steps from 1 / depth_max to 1 / depth_min.
    depth_min and depth_max are numbers or tensors of one shape (...)."""
    lo = 1.0 / torch.as_tensor(depth_max, dtype=dtype)
    hi = 1.0 / torch.as_tensor(depth_min, dtype=dtype)
    steps = torch.linspace(0.0, 1.0, num_depth, dtype=dtype,
                           device=lo.device)
    inv = lo[..., None] + (hi - lo)[..., None] * steps
    inv[..., -1] = hi  # the last step is 1 / depth_min exactly
    return (1.0 / inv).flip(-1)


def cascade_depth_samples(cur_depth: torch.Tensor, ndepth: int,
                          depth_interval: torch.Tensor, height: int,
                          width: int) -> torch.Tensor:
    """Per-pixel hypothesis windows for a cascade stage, (B, ndepth, H, W).

    cur_depth: (B, D0) global ladder (only its first and last entries are
    used: `ndepth` even steps across the range) or (B, H, W) previous-stage
    depth at this stage's resolution (window [d - n/2*i, d + n/2*i] of
    `ndepth` steps). depth_interval: (B,) spacing for the windowed case.
    """
    steps = torch.arange(ndepth, dtype=torch.float32, device=cur_depth.device)
    if cur_depth.ndim == 2:
        dmin = cur_depth[:, :1]
        dmax = cur_depth[:, -1:]
        ladder = dmin + steps * ((dmax - dmin) / (ndepth - 1))  # (B, n)
        return ladder[:, :, None, None].expand(-1, -1, height, width)
    iv = depth_interval[:, None, None]
    lo = cur_depth - (ndepth / 2.0) * iv
    hi = cur_depth + (ndepth / 2.0) * iv
    interval = (hi - lo) / (ndepth - 1)
    return lo[:, None] + steps[None, :, None, None] * interval[:, None]


def uniform_depth_values(depth_min: torch.Tensor,
                         depth_interval: torch.Tensor,
                         num_depth: int) -> torch.Tensor:
    """(B, D) ladders depth_min + i * depth_interval, f32; both (B,)."""
    steps = torch.arange(num_depth, dtype=torch.float32,
                         device=depth_min.device)
    return depth_min.float()[:, None] + steps * depth_interval.float()[:, None]


def residual_depth_hypotheses(cur_depth: torch.Tensor, interval: torch.Tensor,
                              num_offsets: int = 4) -> torch.Tensor:
    """Pyramid refinement hypotheses cur_depth + k * interval, k in [-n, n).

    cur_depth (B, H, W); interval (B,). Returns (B, 2n, H, W).
    """
    offsets = torch.arange(-num_offsets, num_offsets, dtype=torch.float32,
                           device=cur_depth.device)
    return cur_depth[:, None] + (offsets[None, :, None, None]
                                 * interval[:, None, None, None])


def epipolar_depth_interval(ref_depth: torch.Tensor,
                            ref_intrinsics: torch.Tensor,
                            ref_extrinsics: torch.Tensor,
                            src_intrinsics: torch.Tensor,
                            src_extrinsics: torch.Tensor,
                            pixel_interval: float = 1.0) -> torch.Tensor:
    """(B,) depth step equivalent to a `pixel_interval` step along the
    epipolar line in the source view, averaged over the reference pixels.

    ref_depth (B, H, W); intrinsics (B, 3, 3) and extrinsics (B, 4, 4) of the
    reference and of one source view (the model passes the first). Each
    pixel (integer centre, no +0.5) is projected at its depth and at depth
    + 1 to get the epipolar direction, stepped `pixel_interval` along it, and
    the depth that lands there is solved for from the x coordinate. The
    result is the mean |delta depth| over the pixels whose delta is finite
    and below 1e4. Computed in f32 from the depth with no gradient.
    """
    b, h, w = ref_depth.shape
    d = ref_depth.detach().float().reshape(b, 1, h * w)
    pix = pixel_grid(h, w, device=d.device).reshape(3, -1)  # (3, N)
    ref_proj = compose_projection(ref_intrinsics.float(),
                                  ref_extrinsics.float())
    src_proj = compose_projection(src_intrinsics.float(),
                                  src_extrinsics.float())
    rel = src_proj @ torch.linalg.inv(ref_proj)
    rot, trans = rel[:, :3, :3], rel[:, :3, 3:4]

    q1 = rot @ (pix * d) + trans  # (B, 3, N)
    q2 = rot @ (pix * (d + 1.0)) + trans
    p1 = q1[:, :2] / q1[:, 2:3]
    p2 = q2[:, :2] / q2[:, 2:3]
    direction = p2 - p1
    norm = torch.sqrt(torch.sum(direction * direction, dim=1, keepdim=True))
    direction = direction / torch.clamp(norm, min=1e-8)
    p3 = p1 + direction * pixel_interval

    # (a0 d' + t0) = p3x (a2 d' + t2)  ->  d' = (p3x t2 - t0) / (a0 - p3x a2)
    a = rot @ pix
    num = p3[:, 0] * trans[:, 2] - trans[:, 0]
    den = a[:, 0] - p3[:, 0] * a[:, 2]
    d_new = num / torch.where(den.abs() > 1e-8, den, torch.full_like(den, 1e-8))
    delta = (d_new - d[:, 0]).abs()
    ok = torch.isfinite(delta) & (delta < 1e4)
    total = torch.where(ok, delta, torch.zeros_like(delta)).sum(dim=1)
    return total / torch.clamp(ok.sum(dim=1), min=1).float()
