"""3x3x3 stride-1 SAME conv with a fused affine (+ReLU) epilogue: wrapper of
the CUDA kernels in ``csrc/conv3d_affine.cu`` (counterpart of
mvs_tpu.ops.conv3d_pallas.conv3d_folded / conv3d_lane_folded).

``conv3d_affine`` launches a kernel for CUDA tensors and runs the plain
PyTorch version (``conv3d_affine_plain``: F.conv3d, affine, ReLU) only for
CPU tensors; it never falls back from one to the other. ``_variant`` picks
the kernel of a CUDA call from (dtype, Cin, Cout):

* ``"mma"``, the bf16 tensor-core implicit GEMM (``mvs_conv3d_mma``), for
  bf16 with Cin a multiple of 8: every bf16 conv of the main paths. It takes
  Cin in {8, 16, 32, 64}, Cout a multiple of 8 or 1, and x 16-byte aligned;
  other such calls raise;
* ``"tf32x3"``, the same implicit GEMM on f32 (``mvs_conv3d_tf32x3``): each
  f32 value split into two TF32 parts (``split_tf32``) and three TF32
  products summed in f32, which keeps f32's accuracy. It takes f32 with Cin
  in {4, 8, 16, 32} and Cout a multiple of 8 or 1 (x 16-byte aligned, else
  it raises): AACVP's f32 blocks in its bf16 model, and every f32 conv of
  the main paths with Cin under 64;
* ``"tf32x3_cin64"``, the same 3xTF32 arithmetic at Cin = 64
  (``mvs_conv3d_tf32x3_cin64``), a kernel of its own because its f32 halo
  planes and split weights do not fit the ring of ``"tf32x3"``: it keeps one
  n8 tile of the weights resident and reads each input plane once for the
  three output planes it feeds. It takes f32 with Cin = 64 and Cout a
  multiple of 8 (x 16-byte aligned, else it raises): every f32 conv of the
  main paths at Cin = 64 (the (64, 64) and 64->32 blocks of the U-Nets,
  Point-MVSNet's 64->8 and 64->64);
* ``"direct"``, the direct kernel on the CUDA cores (``mvs_conv3d_direct``),
  for everything else (Cin up to 256): f32 at other Cin, such as 12, or at
  Cin = 64 with Cout = 1 or not a multiple of 8, and bf16 with Cin % 8 != 0.

``conv3d_affine.launches`` counts launches of any kernel,
``conv3d_affine.mma_launches``, ``conv3d_affine.tf32x3_launches`` and
``conv3d_affine.tf32x3_cin64_launches`` those of the three tensor-core
variants. The kernels read the weights as ``pack_conv3d_taps`` (bf16 and
direct) or ``pack_conv3d_tf32x3`` (both 3xTF32 variants) lays them out,
packed once per weight tensor and kept on it until the weight changes.
The TPU kernel's lane fold (fold_factor, fold_volume, fold_conv3d_weights)
is a TPU layout device and has no counterpart here.

Numerics of every version follow the JAX path: the weights are rounded to
the input dtype, products accumulate in f32, the affine and ReLU run in f32,
and the result is rounded once to the input dtype.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mvs_tpu_torch.ops import _build
from mvs_tpu_torch.utils.platform import full_f32

__all__ = ["conv3d_affine", "conv3d_affine_plain", "pack_conv3d_taps",
           "pack_conv3d_tf32x3", "split_tf32"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "mvs_conv3d_direct": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                          + [ctypes.c_void_p], ctypes.c_int),
    "mvs_conv3d_mma": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p], ctypes.c_int),
    "mvs_conv3d_tf32x3": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                          + [ctypes.c_void_p], ctypes.c_int),
    "mvs_conv3d_tf32x3_cin64": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                                + [ctypes.c_void_p], ctypes.c_int),
}
_MAX_CIN = 256  # the direct kernel's (27, Cin, 8) f32 slice in shared memory
_MMA_CIN = (8, 16, 32, 64)  # the implicit GEMM's halo ring fits up to 64
_TF32_CIN = (4, 8, 16, 32)  # in f32 (twice the bytes) up to 32


def pack_conv3d_taps(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The kernels' weight matrix: (Kpad, Npad) in `dtype`.

    weight (Cout, Cin, 3, 3, 3) is rounded to `dtype` and laid out K x N
    with K = 27 * Cin in tap-major, channel-minor order (row
    ((dz * 3 + dy) * 3 + dx) * Cin + i) and N = Cout; K is zero-padded to a
    multiple of 16 (the MMA's k step) and N to a multiple of 8 (its n tile).
    """
    cout, cin = weight.shape[:2]
    k = 27 * cin
    taps = weight.detach().to(dtype).permute(2, 3, 4, 1, 0).reshape(k, cout)
    packed = torch.zeros((-(-k // 16) * 16, -(-cout // 8) * 8), dtype=dtype,
                         device=weight.device)
    packed[:k, :cout] = taps
    return packed


def split_tf32(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(big, small) with t ~= big + small, both TF32 values in f32 tensors
    (their 13 low mantissa bits zero): big is t rounded to TF32, small the
    rest rounded to TF32, each to nearest with ties away from zero, as the
    kernel's tf32_rna rounds (cvt.rna.tf32.f32). big + small is within
    2^-21 of t, relative."""

    def rna(v):
        bits = v.float().contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    big = rna(t)
    return big, rna(t.float() - big)


def pack_conv3d_tf32x3(weight: torch.Tensor) -> torch.Tensor:
    """The 3xTF32 kernel's weights: (Npad / 8, Kpad / 8, 32, 4) f32.

    weight (Cout, Cin, 3, 3, 3) is laid out K x N as pack_conv3d_taps lays
    it out in f32 (K zero-padded to a multiple of the k step 8 here), split
    by split_tf32, and stored in the order of the m16n8k8 B fragments: per
    (n8 tile nt, k step s), lane g * 4 + t4 holds (big[k, n], big[k + 4, n],
    small[k, n], small[k + 4, n]) with k = 8 s + t4 and n = 8 nt + g, so
    that one 16-byte load gives a lane both parts of its fragment.
    """
    kpad = -(-27 * weight.shape[1] // 8) * 8
    taps = pack_conv3d_taps(weight, torch.float32)[:kpad]
    parts = torch.stack(split_tf32(taps))  # (part, K, N)
    parts = parts.reshape(2, kpad // 8, 2, 4, taps.shape[1] // 8, 8)
    # (part, s, k half, t4, nt, g) -> (nt, s, g, t4, part, k half)
    return parts.permute(4, 1, 5, 3, 0, 2).reshape(
        taps.shape[1] // 8, kpad // 8, 32, 4).contiguous()


def _packed(weight: torch.Tensor, dtype: torch.dtype,
            tf32x3: bool = False) -> torch.Tensor:
    """pack_conv3d_taps(weight, dtype), or pack_conv3d_tf32x3(weight) for
    the 3xTF32 kernel, kept on `weight` while its storage, version and the
    layout asked for stay the same (an inference tensor has no version and
    is packed on every call).

    In-place writes to `weight` itself (``load_state_dict``, ``copy_`` or
    ``mul_`` under ``torch.no_grad()``, an optimizer step) bump its version
    and repack. A write through ``weight.data`` does not: ``.data`` is a
    tensor with a version counter of its own, so such a write leaves the
    old packed weights in use.
    """

    def pack():
        return (pack_conv3d_tf32x3(weight) if tf32x3
                else pack_conv3d_taps(weight, dtype))

    if weight.is_inference():
        return pack()
    key = (dtype, tf32x3, weight.device, weight.data_ptr(), weight._version)
    hit = getattr(weight, "_mvs_conv3d_packed", None)
    if hit is None or hit[0] != key:
        hit = (key, pack())
        weight._mvs_conv3d_packed = hit
    return hit[1]


def _variant(dtype: torch.dtype, cin: int, cout: int) -> str:
    """The kernel a CUDA call of (dtype, Cin, Cout) takes: "mma", "tf32x3",
    "tf32x3_cin64" or "direct" (see the module's docstring)."""
    if dtype == torch.bfloat16 and cin % 8 == 0:
        return "mma"
    if dtype == torch.float32 and cin in _TF32_CIN and (cout % 8 == 0
                                                        or cout == 1):
        return "tf32x3"
    if dtype == torch.float32 and cin == 64 and cout % 8 == 0:
        return "tf32x3_cin64"
    return "direct"


def conv3d_affine_plain(x: torch.Tensor, weight: torch.Tensor,
                        scale: torch.Tensor, shift: torch.Tensor,
                        relu: bool) -> torch.Tensor:
    """Plain PyTorch version: x (B, D, H, W, Cin), weight (Cout, Cin, 3, 3, 3)
    -> (B, D, H, W, Cout) in x's dtype, with float32 sums (not TF32)."""
    w = weight.to(x.dtype).float()
    # NDHWC viewed as NCDHW is a channels_last_3d tensor: no copy.
    with full_f32():
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
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (B, D, H, W, Cin)")
    for name, t in (("weight", weight), ("scale", scale), ("shift", shift)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    variant = _variant(x.dtype, cin, cout)
    if variant == "mma" and (cin not in _MMA_CIN
                             or not (cout % 8 == 0 or cout == 1)):
        raise ValueError(f"bf16 (Cin, Cout) = ({cin}, {cout}): the "
                         f"tensor-core kernel takes Cin in {_MMA_CIN} "
                         f"and Cout a multiple of 8 or 1")
    if variant != "direct" and x.data_ptr() % 16:
        raise ValueError(f"{str(x.dtype)[6:]} x must be 16-byte aligned")
    if variant == "direct" and cin > _MAX_CIN:
        raise ValueError(f"Cin {cin} > {_MAX_CIN}")
    tf32x3 = variant in ("tf32x3", "tf32x3_cin64")  # split weights
    taps = _packed(weight, x.dtype, tf32x3)
    sc = scale.float().contiguous()
    sh = shift.float().contiguous()
    y = torch.empty((b, d, h, w, cout), dtype=x.dtype, device=x.device)
    lib = _build.load("conv3d_affine", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        ldw = taps.shape[0] * 8 if tf32x3 else taps.shape[1]  # padded Cout
        args = (x.data_ptr(), taps.data_ptr(), sc.data_ptr(), sh.data_ptr(),
                y.data_ptr(), b, d, h, w, cin, cout, ldw, int(relu))
        if variant == "mma":
            status = lib.mvs_conv3d_mma(*args, stream)
        elif variant == "tf32x3":
            status = lib.mvs_conv3d_tf32x3(*args, stream)
        elif variant == "tf32x3_cin64":
            status = lib.mvs_conv3d_tf32x3_cin64(*args, stream)
        else:
            status = lib.mvs_conv3d_direct(*args, _DTYPES[x.dtype], stream)
    _build.check(status, "conv3d_affine")
    conv3d_affine.launches += 1
    conv3d_affine.mma_launches += int(variant == "mma")
    conv3d_affine.tf32x3_launches += int(variant == "tf32x3")
    conv3d_affine.tf32x3_cin64_launches += int(variant == "tf32x3_cin64")
    return y


conv3d_affine.launches = 0
conv3d_affine.mma_launches = 0
conv3d_affine.tf32x3_launches = 0
conv3d_affine.tf32x3_cin64_launches = 0
