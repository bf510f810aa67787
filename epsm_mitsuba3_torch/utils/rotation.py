"""SO(3) and SE(3) exponential maps (counterpart of ``utils/rotation.py``,
the reference's ``EPSM/utils/rotation.py``).

Rodrigues' formula with the reference's guards: ``1e-20`` under the
square root, so the angle of a zero vector is 1e-10 and not 0, and below
an angle of 1e-6 the map returns ``I + hat(w)``.  The masked branch's
gradient stays finite there: its 1 / theta is 1e10, multiplied by the
zero cotangent that ``torch.where`` hands the unselected branch.

The 3 x 3 products run in full float32 (``full_f32_matmul``): on the card
a TF32 product would round the rotations to 10 bits.
"""
from __future__ import annotations

import torch

from ..ops.sinkhorn import full_f32_matmul


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew matrix."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], zeros], -1),
    ], -2)


def _rodrigues(w):
    """(R, K, K @ K, sin, cos, theta) of the axis-angle ``w`` (..., 3), R
    before the small-angle branch."""
    theta = torch.sqrt(torch.sum(w * w, -1) + 1e-20)
    K = hat(w / theta[..., None])
    s = torch.sin(theta)[..., None, None]
    c = torch.cos(theta)[..., None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    with full_f32_matmul():
        KK = K @ K
    return eye + s * K + (1.0 - c) * KK, K, KK, s, c, theta


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle (..., 3) -> rotation matrix (..., 3, 3)."""
    R, _, _, _, _, theta = _rodrigues(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    small = (theta < 1e-6)[..., None, None]
    return torch.where(small, eye + hat(w), R)


def se3_exp(wu: torch.Tensor) -> torch.Tensor:
    """se(3) exp: (..., 6) [w, u] -> homogeneous (..., 4, 4)."""
    w, u = wu[..., :3], wu[..., 3:]
    R, K, KK, s, c, theta = _rodrigues(w)
    eye = torch.eye(3, dtype=wu.dtype, device=wu.device)
    th = theta[..., None, None]
    V = eye + ((1.0 - c) / (th * th + 1e-20)) * K * th \
        + ((th - s) / (th * th * th + 1e-20)) * KK * th * th
    small = (theta < 1e-6)[..., None, None]
    R = torch.where(small, eye + hat(w), R)
    V = torch.where(small, eye, V)
    with full_f32_matmul():
        t = (V @ u[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.zeros(wu.shape[:-1] + (1, 4), dtype=wu.dtype,
                         device=wu.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], -2)
