"""Vector math and orthonormal frames (counterpart of ``core/math.py``).

Vectors are ``(..., 3)`` tensors.  Only the forward functions that the
primal path tracer calls are here; their custom tangent rules come with
the gradient slice.
"""
from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor, keepdim: bool = False):
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def squared_norm(a: torch.Tensor, keepdim: bool = False):
    return torch.sum(a * a, dim=-1, keepdim=keepdim)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def normalize(a: torch.Tensor) -> torch.Tensor:
    """``a / |a|``, with ``|a|^2`` clamped to 1e-37."""
    return a * safe_rsqrt(squared_norm(a, keepdim=True))


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt clamped to 0 below zero."""
    return torch.sqrt(torch.clamp(x, min=0.0))


def safe_rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1/sqrt with the argument clamped to 1e-37."""
    return 1.0 / torch.sqrt(torch.clamp(x, min=1e-37))


def safe_div(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-20):
    """``x / max(y, eps)``."""
    return x / torch.clamp(y, min=eps)


def mulsign(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x * sign(s) with sign(0) == +1 (drjit ``mulsign``)."""
    return torch.where(s >= 0.0, x, -x)


def coordinate_system(n: torch.Tensor):
    """Orthonormal basis (s, t) around unit normal ``n`` (Duff et al. 2017,
    include/mitsuba/core/vector.h ``coordinate_system``)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign_ = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign_ + nz)
    b = nx * ny * a
    s = torch.stack([mulsign(nx * nx * a, nz) + 1.0,
                     mulsign(b, nz),
                     mulsign(-nx, nz)], dim=-1)
    t = torch.stack([b, ny * ny * a + sign_, -ny], dim=-1)
    return s, t


def to_local(n, s, t, v):
    """World -> frame coordinates: (v.s, v.t, v.n)."""
    return torch.stack([dot(v, s), dot(v, t), dot(v, n)], dim=-1)


def to_world(n, s, t, v):
    """Frame -> world coordinates."""
    return s * v[..., 0:1] + t * v[..., 1:2] + n * v[..., 2:3]
