"""Film accumulation (counterpart of ``models/films.py``): the box-filter
hdrfilm on the pixel-major lane order, and Kahan-compensated summation of
sequential passes."""
from __future__ import annotations

import torch


def accumulate_coalesced(values: torch.Tensor, width: int, height: int,
                         spp: int) -> torch.Tensor:
    """Box-filter accumulation for lane = pixel * spp + s.  Returns the
    (H, W, C) per-pixel mean."""
    c = values.shape[-1]
    return values.reshape(height, width, spp, c).mean(dim=2)


def kahan_add(acc: torch.Tensor, comp: torch.Tensor, x: torch.Tensor):
    """One Kahan (compensated) summation step: returns (acc', comp')."""
    y = x - comp
    t = acc + y
    comp = (t - acc) - y
    return t, comp
