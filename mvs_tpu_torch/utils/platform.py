"""Device selection: the counterpart of mvs_tpu.utils.platform.

The port's entry points run on the CUDA card unless the caller names another
device; they never fall back to the CPU on their own, so a run that was meant
for the card cannot quietly measure the host instead.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "full_f32"]


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the first CUDA card.

    Raises RuntimeError when a CUDA device is asked for (explicitly or by
    default) and CUDA is not available. Pass device="cpu" for the CPU.
    """
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def full_f32():
    """Run float32 convolutions and matrix products at float32 precision.

    On the card, cuDNN runs a float32 convolution in TF32 (about three
    decimal digits) unless told otherwise; the port's float32 path computes
    in float32, as on the CPU. Both flags are set and restored on exit.
    """
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
