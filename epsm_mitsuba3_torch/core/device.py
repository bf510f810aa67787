"""Device selection for the port's entry points.

``device=None`` means the GPU.  Without CUDA that is an error, never a
silent fall-back to the CPU: the CPU runs only when the caller asks for it.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; anything else as given.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and not available."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the GPU unless "
                "the caller passes device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
