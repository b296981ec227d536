"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with
no `device` they take "cuda", and they raise, rather than fall back to
the CPU, where CUDA is asked for and absent.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` (default "cuda") as a torch.device, a CUDA device with
    its index; raises if it is a CUDA device and no card is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was asked for (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions of the kernels on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
