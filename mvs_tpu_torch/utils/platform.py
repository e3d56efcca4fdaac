"""Device selection: the counterpart of mvs_tpu.utils.platform.

The port's entry points run on the CUDA card unless the caller names another
device; they never fall back to the CPU on their own, so a run that was meant
for the card cannot quietly measure the host instead.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


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
