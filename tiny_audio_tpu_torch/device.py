"""The device rule of the port's entry points."""

from __future__ import annotations

import torch


def require_device(device) -> torch.device:
    """``device`` as a torch.device.  A CUDA device must exist: the entry
    points run on the card and never fall back to the CPU unless asked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; "
            "pass device='cpu' to run on the CPU"
        )
    return device
