"""Device resolution for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  Without a
card that default raises: the port never drops to the CPU on its own.
``device="cpu"`` is the explicit request for the kernels' plain PyTorch
versions (the CPU tests pass it).
"""

from __future__ import annotations

import torch


class NoCudaDevice(RuntimeError):
    """The caller asked for the card (the default) and there is none."""


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDevice(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
