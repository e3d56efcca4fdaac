"""What the two cost-volume wrappers (ops.warp_variance and
ops.group_correlation) share: the checks of the inputs their kernels take,
how the cameras are packed for them, when the 16-byte variant runs, and the
plain backward by autograd through a plain version."""

from __future__ import annotations

import torch

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def vjp_plain(fn, grad, ref_feat, src_feats, rel_projs, depth_values,
              *args, depth_grad: bool = True):
    """(dref, dsrc, ddepth) of fn(ref, src, rel_projs, depth, *args) by
    autograd, for the cotangent `grad`; ddepth None unless `depth_grad`."""
    with torch.enable_grad():
        ref, src, depth = (t.detach().requires_grad_(need) for t, need in (
            (ref_feat, True), (src_feats, True), (depth_values, depth_grad)))
        out = fn(ref, src, rel_projs, depth, *args)
        grads = torch.autograd.grad(out, (ref, src, depth)[:2 + depth_grad],
                                    grad)
    return grads[0], grads[1], grads[2] if depth_grad else None


def check_cuda_inputs(ref_feat, src_feats, rel_projs, depth_values,
                      row0: int | None = None):
    """Raise on what the kernels do not take; return (B, V, D, H, W, C).
    With `row0` the reference's H rows are rows row0 .. row0 + H - 1 of the
    source views (the warp kernels' row window); without it the source
    views have H rows."""
    if ref_feat.device.type != "cuda":
        raise ValueError(f"unsupported device {ref_feat.device}")
    b, h, w, c = ref_feat.shape
    rows_ok = src_feats.ndim == 5 and (
        src_feats.shape[2] == h if row0 is None
        else 0 <= row0 <= src_feats.shape[2] - h)
    if not rows_ok or src_feats.shape[0] != b or \
            src_feats.shape[3:] != ref_feat.shape[2:]:
        raise ValueError(f"src_feats {tuple(src_feats.shape)} does not match "
                         f"ref_feat {tuple(ref_feat.shape)}"
                         + ("" if row0 is None else f" at row {row0}"))
    nv = src_feats.shape[1]
    if rel_projs.shape != (b, nv, 4, 4):
        raise ValueError(f"rel_projs {tuple(rel_projs.shape)}, want "
                         f"{(b, nv, 4, 4)}")
    if depth_values.ndim != 4 or depth_values.shape[0] != b or \
            depth_values.shape[2:] != (h, w):
        raise ValueError(f"depth_values {tuple(depth_values.shape)}, want "
                         f"(B, D, {h}, {w})")
    if ref_feat.dtype not in DTYPES or src_feats.dtype != ref_feat.dtype:
        raise TypeError(f"features must share dtype float32 or bfloat16, got "
                        f"{ref_feat.dtype} and {src_feats.dtype}")
    if depth_values.dtype != torch.float32:
        raise TypeError(f"depth_values must be float32, got "
                        f"{depth_values.dtype}")
    for name, t in (("ref_feat", ref_feat), ("src_feats", src_feats),
                    ("depth_values", depth_values), ("rel_projs", rel_projs)):
        if t.device != ref_feat.device:
            raise ValueError(f"{name} on {t.device}, ref_feat on "
                             f"{ref_feat.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return b, nv, depth_values.shape[1], h, w, c


def check_grad(grad, shape, ref_feat):
    """grad made contiguous; raise unless it has `shape` and ref_feat's
    dtype and device."""
    grad = grad.contiguous()
    if grad.shape != shape or grad.dtype != ref_feat.dtype or \
            grad.device != ref_feat.device:
        raise ValueError(f"grad {tuple(grad.shape)} {grad.dtype} on "
                         f"{grad.device}, want {shape} {ref_feat.dtype} on "
                         f"{ref_feat.device}")
    return grad


def check_geometry_grad(rel_projs, what):
    if rel_projs.requires_grad:
        raise ValueError(f"rel_projs requires grad: {what} gives no gradient "
                         "to the cameras; detach it")


def geometry(rel_projs):
    """(B, V, 12) f32: rows of R, then t, of src @ ref^-1."""
    b, nv = rel_projs.shape[:2]
    return torch.cat([rel_projs[..., :3, :3].reshape(b, nv, 9),
                      rel_projs[..., :3, 3]], dim=-1).float().contiguous()


def vector(c, *tensors):
    """Whether the kernels' 16-byte variant takes C = c channels and these
    tensors: C % 8 == 0 and every pointer 16-byte aligned."""
    return c % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
