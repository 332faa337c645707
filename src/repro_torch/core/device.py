"""Device selection shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
CUDA device they raise instead of dropping to the CPU by themselves.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and the
    process has no CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
