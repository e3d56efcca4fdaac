"""Point-MVSNet's point operations (counterpart of mvs_tpu.ops.point_ops):
the 0.5-centred pixel grid, the plain feature fetch, the lattice kNN and
the neighbour gather; and ``point_sweep_projections``, which puts the
model's 0.5-centred geometry on the warp-variance kernel.

Pixel centres sit at (x + 0.5, y + 0.5) in Point-MVSNet: a world point is
unprojected from K^-1 (x + 0.5, y + 0.5, 1) and a projection K (X / Z) is
sampled at array coordinate uv - 0.5. With the principal point shifted by
-0.5 after scaling (K' = K - 0.5 in its third column), K'^-1 (x, y, 1) is
K^-1 (x + 0.5, y + 0.5, 1) and K' (X / Z) is K (X / Z) - 0.5, so the
plane-sweep warp over P' = K' E computes what fetch_point_features computes
over P = K E, and the variance kernel (ops.warp_variance), which adds the
reference view's own features at its pixel, computes the coarse volume of
mvs_tpu's model, reference view put in directly. One delta: the kernel and
its plain version drop samples with z <= 1e-3 in the source camera
(geometry.homography), where fetch_point_features divides by z whatever
its sign (|z| > 1e-6) and samples the mirrored projection of a point
behind the camera.
"""

from __future__ import annotations

import torch

from mvs_tpu_torch.geometry.projection import compose_projection
from mvs_tpu_torch.geometry.sampling import bilinear_sample

__all__ = ["point_pixel_grid", "fetch_point_features", "lattice_knn",
           "gather_neighbors", "point_sweep_projections"]


def point_pixel_grid(height: int, width: int, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """Homogeneous pixel-centre coordinates (3, H*W): x, y at +0.5, exact.
    mvs_tpu's jnp.linspace rounds some of them in f32 (2.5000002 for the
    third of 0.5..3.5, as XLA computes it), by up to 2^-22 of the value;
    the warp kernel's shifted projections (point_sweep_projections) sample
    at the exact centres, as this grid does."""
    xs = torch.arange(width, dtype=dtype, device=device) + 0.5
    ys = torch.arange(height, dtype=dtype, device=device) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy, torch.ones_like(gx)]).reshape(3, -1)


def fetch_point_features(feature_maps: torch.Tensor, pts: torch.Tensor,
                         intrinsics: torch.Tensor,
                         extrinsics: torch.Tensor) -> torch.Tensor:
    """Sample each view's features at the projections of world points:
    feature_maps (V, H, W, C), pts (3, N), intrinsics (V, 3, 3),
    extrinsics (V, 4, 4) -> (V, N, C). The plain form of the fetch; the
    model builds its volumes on the warp kernel instead."""
    r = extrinsics[:, :3, :3]
    t = extrinsics[:, :3, 3:4]
    cam = torch.einsum("vij,jn->vin", r, pts) + t  # (V, 3, N)
    z = cam[:, 2]
    safe_z = torch.where(z.abs() > 1e-6, z, torch.full_like(z, 1e-6))
    norm_uv = torch.stack([cam[:, 0] / safe_z, cam[:, 1] / safe_z,
                           torch.ones_like(z)], dim=1)
    uv = torch.einsum("vij,vjn->vin", intrinsics, norm_uv)[:, :2]
    coords = uv.transpose(1, 2) - 0.5  # 0.5-centred pixels -> array coords
    return bilinear_sample(feature_maps, coords)


def lattice_knn(xyz: torch.Tensor, kernel_size: int = 3,
                k: int = 16) -> torch.Tensor:
    """k nearest neighbours within the kernel_size^3 lattice window.

    xyz (*lead, 3, D, H, W): point coordinates on the hypothesis lattice.
    Returns int64 flat indices (*lead, N, k), N = D*H*W, nearest first, as
    mvs_tpu's lattice_knn: distances are measured against the zero padding
    outside the lattice, a slot's flat index is base + offset (which wraps
    across rows at the borders) clamped to [0, N-1], and equal distances go
    to the lower window slot (lax.top_k's order, here a stable sort).
    Distances sum the squared x, y, z differences in that order, as
    mvs_tpu's does.
    """
    *lead, _, d, h, w = xyz.shape
    ks, hk = kernel_size, kernel_size // 2
    padded = torch.nn.functional.pad(xyz, (hk,) * 6)
    # (*lead, 3, D, H, W, ks, ks, ks): every window as a view, slots in
    # (di, dj, dk) order.
    windows = padded.unfold(-3, ks, 1).unfold(-3, ks, 1).unfold(-3, ks, 1)
    diff = xyz[..., None, None, None] - windows
    sq = diff * diff
    dist = (sq[..., 0, :, :, :, :, :, :] + sq[..., 1, :, :, :, :, :, :]
            + sq[..., 2, :, :, :, :, :, :])
    slot = torch.sort(dist.reshape(*lead, d * h * w, ks ** 3), dim=-1,
                      stable=True).indices[..., :k]
    r = torch.arange(ks, device=xyz.device) - hk
    offsets = (r[:, None, None] * (h * w) + r[None, :, None] * w
               + r[None, None, :]).reshape(-1)
    base = torch.arange(d * h * w, device=xyz.device)[:, None]
    return torch.clamp(base + offsets[slot], 0, d * h * w - 1)


def gather_neighbors(features: torch.Tensor,
                     nn_idx: torch.Tensor) -> torch.Tensor:
    """features (*lead, N, C), nn_idx (*lead, N, k) -> (*lead, N, k, C).
    An index gather, whose autograd backward is a scatter-add."""
    *lead, n, c = features.shape
    flat = features.reshape(-1, c)
    nb = flat.shape[0] // n
    base = (torch.arange(nb, device=nn_idx.device) * n).reshape(
        *lead, 1, 1)
    return flat[(nn_idx + base).reshape(-1)].reshape(*nn_idx.shape, c)


def point_sweep_projections(intrinsics: torch.Tensor,
                            extrinsics: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """The warp's rel_projs (B, V-1, 4, 4), src @ ref^-1, for Point-MVSNet's
    0.5-centred geometry at `scale` of the images: intrinsics (B, V, 3, 3)
    at image resolution are scaled, then their principal point shifted by
    -0.5 (see the module's docstring); extrinsics (B, V, 4, 4)."""
    k = intrinsics.clone()
    k[..., :2, :] *= scale
    k[..., :2, 2] -= 0.5
    proj = compose_projection(k, extrinsics)
    return (proj[:, 1:] @ torch.linalg.inv(proj[:, 0])[:, None]).contiguous()
