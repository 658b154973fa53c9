"""The explicit device every entry point of the port takes."""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when a CUDA device is
    asked for and none is available (nothing moves to the CPU quietly)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested, but no CUDA "
                           f"device is available (use device='cpu')")
    return dev
