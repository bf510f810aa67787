"""Sampling warps used by the primal path tracer (counterpart of
``core/warp.py``)."""
from __future__ import annotations

import math

import torch

from . import math as m

_INV_PI = 1.0 / math.pi


def square_to_uniform_disk_concentric(sample: torch.Tensor) -> torch.Tensor:
    """Concentric (Shirley) square -> disk mapping (warp.h:190-216)."""
    x = 2.0 * sample[..., 0] - 1.0
    y = 2.0 * sample[..., 1] - 1.0
    is_zero = (x == 0.0) & (y == 0.0)
    quadrant_1_or_3 = torch.abs(x) < torch.abs(y)
    r = torch.where(quadrant_1_or_3, y, x)
    rp = torch.where(quadrant_1_or_3, x, y)
    phi = 0.25 * math.pi * rp / torch.where(r == 0.0, 1.0, r)
    phi = torch.where(quadrant_1_or_3, 0.5 * math.pi - phi, phi)
    phi = torch.where(is_zero, 0.0, phi)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_cosine_hemisphere(sample: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere via the concentric disk (warp.h:539)."""
    p = square_to_uniform_disk_concentric(sample)
    z = m.safe_sqrt(1.0 - p[..., 0] * p[..., 0] - p[..., 1] * p[..., 1])
    return torch.cat([p, z[..., None]], dim=-1)


def square_to_cosine_hemisphere_pdf(v: torch.Tensor) -> torch.Tensor:
    return _INV_PI * torch.clamp(v[..., 2], min=0.0)


def square_to_uniform_triangle(sample: torch.Tensor) -> torch.Tensor:
    """Uniform barycentrics on the standard triangle (warp.h:280-292)."""
    t = m.safe_sqrt(1.0 - sample[..., 0])
    return torch.stack([1.0 - t, t * sample[..., 1]], dim=-1)
