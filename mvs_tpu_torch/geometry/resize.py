"""Resizes with jax.image.resize's semantics, as mvs_tpu's CVP-MVSNet and
Point-MVSNet call it (mvs_tpu/models/cvp_mvsnet.py:105-107,142,
point_mvsnet.py:190-196).

* The image pyramid halves each level with ``method="bilinear"``, which
  jax.image.resize computes with antialiasing: on a downsample the triangle
  kernel is widened by the factor (a 4-tap [1, 3, 3, 1] / 8 filter at x0.5,
  renormalized over the taps inside the image). That is torch's
  ``F.interpolate(mode="bilinear", antialias=True, align_corners=False)``;
  without ``antialias`` it would be a 2-tap average. On an upsample the
  kernel keeps its width and the taps outside the image drop out, which
  is the same call (``downsample_bilinear`` serves both directions).
* ``method="nearest"`` takes source index floor((i + 0.5) * in / out),
  computed in f32 (``resize_nearest``); torch's "nearest" takes
  floor(i * in / out), which differs except at integer up-factors.
* The depth of a coarser level is doubled with ``method="cubic"``: Keys'
  cubic kernel with a = -0.5, its weights renormalized over the taps inside
  the input at the border. torch's ``bicubic`` uses a = -0.75 and clamps the
  taps to the border, another function, so the weights are written out here
  (``cubic_weight_matrix``, the counterpart of jax.image's
  ``compute_weight_mat`` for that kernel) and applied as two matrix
  products in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["downsample_bilinear", "resize_nearest", "cubic_weight_matrix",
           "resize_cubic"]


def downsample_bilinear(x: torch.Tensor, height: int,
                        width: int) -> torch.Tensor:
    """Antialiased bilinear resize of channels-last x (*lead, H, W, C) to
    (*lead, height, width, C), computed in f32 and rounded once to x's
    dtype. A size it already has is returned as it is (jax.image.resize
    skips such axes)."""
    *lead, h, w, c = x.shape
    if (h, w) == (height, width):
        return x
    y = F.interpolate(x.reshape(-1, h, w, c).movedim(-1, 1).float(),
                      size=(height, width), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.movedim(1, -1).to(x.dtype).reshape(*lead, height, width, c)


def _nearest_index(in_size: int, out_size: int, device) -> torch.Tensor:
    pos = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5
           ) * torch.tensor(in_size / out_size, dtype=torch.float32)
    return pos.floor().long()


def resize_nearest(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """jax.image.resize(x, (B, height, width), method="nearest") of x
    (B, H, W): rows and columns picked at floor((i + 0.5) * in / out)."""
    _, h, w = x.shape
    rows = _nearest_index(h, height, x.device)
    cols = _nearest_index(w, width, x.device)
    return x[:, rows][:, :, cols]


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel, a = -0.5, at distances x >= 0 (jax.image's
    _fill_keys_cubic_kernel, same operations in the same order)."""
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    out = torch.where(x >= 1.0, far, near)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def cubic_weight_matrix(in_size: int, out_size: int, device=None,
                        dtype=torch.float32) -> torch.Tensor:
    """(in_size, out_size) weights of jax.image.resize(method="cubic")
    along one axis: column j holds the taps of output sample j, whose
    position in the input is (j + 0.5) * in/out - 0.5. On a downsample the
    kernel is widened by in/out (antialiasing); each column is divided by
    its sum, so taps past the border drop out and the rest are
    renormalized. Computed in `dtype` (jax.image computes them in its
    scale's type: f32, or float64 under jax_enable_x64)."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(out_size, dtype=dtype, device=device)
               + 0.5) * inv_scale - 0.5)
    dist = (sample[None, :] - torch.arange(
        in_size, dtype=dtype, device=device)[:, None]).abs()
    weights = _keys_cubic(dist / kernel_scale)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def resize_cubic(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """jax.image.resize(x, (B, height, width), method="cubic") of x
    (B, H, W), in f32."""
    _, h, w = x.shape
    x = x.float()
    if h != height:
        x = torch.einsum("bhw,hy->byw", x,
                         cubic_weight_matrix(h, height, x.device, x.dtype))
    if w != width:
        x = x @ cubic_weight_matrix(w, width, x.device, x.dtype)
    return x
