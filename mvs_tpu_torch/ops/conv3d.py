"""3x3x3 stride-1 SAME conv with a fused affine (+ReLU) epilogue: wrapper of
the CUDA kernel ``csrc/conv3d_affine.cu`` (counterpart of
mvs_tpu.ops.conv3d_pallas.conv3d_folded / conv3d_lane_folded).

``conv3d_affine`` launches the kernel for CUDA tensors and runs the plain
PyTorch version (``conv3d_affine_plain``: F.conv3d, affine, ReLU) only for
CPU tensors; it never falls back from one to the other.
``conv3d_affine.launches`` counts kernel launches. The TPU kernel's lane
fold (fold_factor, fold_volume, fold_conv3d_weights) is a TPU layout device
and has no counterpart here.

Numerics of both versions follow the JAX path: the weights are rounded to
the input dtype, products accumulate in f32, the affine and ReLU run in f32,
and the result is rounded once to the input dtype.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mvs_tpu_torch.ops import _build

__all__ = ["conv3d_affine", "conv3d_affine_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "mvs_conv3d_affine": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                          + [ctypes.c_void_p], ctypes.c_int),
}
_MAX_CIN = 256  # the (27, Cin, 8) f32 weight slice must fit shared memory


def conv3d_affine_plain(x: torch.Tensor, weight: torch.Tensor,
                        scale: torch.Tensor, shift: torch.Tensor,
                        relu: bool) -> torch.Tensor:
    """Plain PyTorch version: x (B, D, H, W, Cin), weight (Cout, Cin, 3, 3, 3)
    -> (B, D, H, W, Cout) in x's dtype."""
    w = weight.to(x.dtype).float()
    # NDHWC viewed as NCDHW is a channels_last_3d tensor: no copy.
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3), w, padding=1)
    y = y * scale.float()[:, None, None, None] \
        + shift.float()[:, None, None, None]
    if relu:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def conv3d_affine(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                  shift: torch.Tensor, relu: bool) -> torch.Tensor:
    """relu?(scale * conv3x3x3_same(x, weight) + shift), per output channel.

    x (B, D, H, W, Cin) f32 or bf16, contiguous; weight (Cout, Cin, 3, 3, 3);
    scale, shift (Cout,). Returns (B, D, H, W, Cout) in x's dtype.
    """
    if x.device.type == "cpu":
        return conv3d_affine_plain(x, weight, scale, shift, relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.ndim != 5:
        raise ValueError(f"x must be (B, D, H, W, Cin), got {tuple(x.shape)}")
    b, d, h, w, cin = x.shape
    cout = weight.shape[0]
    if weight.shape != (cout, cin, 3, 3, 3):
        raise ValueError(f"weight {tuple(weight.shape)}, want "
                         f"({cout}, {cin}, 3, 3, 3)")
    if scale.shape != (cout,) or shift.shape != (cout,):
        raise ValueError(f"scale/shift must be ({cout},)")
    if cin > _MAX_CIN:
        raise ValueError(f"Cin {cin} > {_MAX_CIN}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (B, D, H, W, Cin)")
    for name, t in (("weight", weight), ("scale", scale), ("shift", shift)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    taps = (weight.to(x.dtype).float().permute(2, 3, 4, 1, 0)
            .reshape(27, cin, cout).contiguous())
    sc = scale.float().contiguous()
    sh = shift.float().contiguous()
    y = torch.empty((b, d, h, w, cout), dtype=x.dtype, device=x.device)
    lib = _build.load("conv3d_affine", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.mvs_conv3d_affine(
            x.data_ptr(), taps.data_ptr(), sc.data_ptr(), sh.data_ptr(),
            y.data_ptr(), b, d, h, w, cin, cout, int(relu), _DTYPES[x.dtype],
            stream)
    _build.check(status, "conv3d_affine")
    conv3d_affine.launches += 1
    return y


conv3d_affine.launches = 0
