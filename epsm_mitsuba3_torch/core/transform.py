"""4x4 transforms (counterpart of ``core/transform.py``).

``ScalarTransform4f`` builds the matrices of scene descriptions before
any tensor exists, so it is plain numpy, float32 like the reference.
The functions at the end (``translate``, ``scale``, ``rotate``,
``look_at``, ``perspective``, ``apply_*``, ``inverse``, ``compose``) are
the differentiable constructors on tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from . import math as m


def _np_translate(v):
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = np.asarray(v, np.float32).reshape(3)
    return t


def _np_scale(v):
    v = np.asarray(v, np.float32)
    if v.ndim == 0:
        v = np.stack([v, v, v])
    return np.diag(np.concatenate([v, np.ones((1,), v.dtype)]))


def _np_rotate(axis, angle_deg):
    axis = np.asarray(axis, np.float64)
    axis = axis / max(np.linalg.norm(axis), 1e-20)
    a = np.deg2rad(float(angle_deg))
    s, c = np.sin(a), np.cos(a)
    x, y, z = axis
    omc = 1.0 - c
    rot = np.array([
        [c + x * x * omc, x * y * omc - z * s, x * z * omc + y * s],
        [y * x * omc + z * s, c + y * y * omc, y * z * omc - x * s],
        [z * x * omc - y * s, z * y * omc + x * s, c + z * z * omc]])
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = rot.astype(np.float32)
    return out


def _np_look_at(origin, target, up):
    """Camera-to-world: +Z towards target, +X = cross(up, dir)."""
    origin = np.asarray(origin, np.float64)
    fwd = np.asarray(target, np.float64) - origin
    fwd = fwd / max(np.linalg.norm(fwd), 1e-20)
    right = np.cross(np.asarray(up, np.float64), fwd)
    right = right / max(np.linalg.norm(right), 1e-20)
    new_up = np.cross(fwd, right)
    out = np.eye(4, dtype=np.float64)
    out[:3, 0] = right
    out[:3, 1] = new_up
    out[:3, 2] = fwd
    out[:3, 3] = origin
    return out.astype(np.float32)


def _np_perspective(fov_deg, near, far):
    """Perspective projection (transform.h ``perspective``), float32."""
    f32 = np.float32
    recip = f32(1.0) / (f32(far) - f32(near))
    cot = f32(1.0) / np.tan(np.deg2rad(f32(fov_deg)) * f32(0.5))
    return np.array([[cot, 0, 0, 0],
                     [0, cot, 0, 0],
                     [0, 0, f32(far) * recip, -f32(near) * f32(far) * recip],
                     [0, 0, 1, 0]], np.float32)


class _hybridmethod:
    """Method callable on the class (self = identity) and on instances."""

    def __init__(self, fn):
        self.fn = fn

    def __get__(self, obj, objtype=None):
        bound = obj if obj is not None else objtype()

        def call(*args, **kwargs):
            return self.fn(bound, *args, **kwargs)

        return call


class ScalarTransform4f:
    """Chainable transform constructor mirroring ``mi.ScalarTransform4f``:
    ``T.translate(...).rotate(...).scale(...)``."""

    def __init__(self, matrix=None):
        self.matrix = (np.eye(4, dtype=np.float32) if matrix is None
                       else np.asarray(matrix, np.float32))

    def _chain(self, mat):
        return ScalarTransform4f(self.matrix @ mat)

    @_hybridmethod
    def translate(self, v):
        return self._chain(_np_translate(v))

    @_hybridmethod
    def scale(self, v):
        return self._chain(_np_scale(v))

    @_hybridmethod
    def rotate(self, axis, angle):
        return self._chain(_np_rotate(axis, angle))

    @_hybridmethod
    def look_at(self, origin, target, up):
        return self._chain(_np_look_at(origin, target, up))

    @_hybridmethod
    def perspective(self, fov, near, far):
        return self._chain(_np_perspective(fov, near, far))


# ---------------------------------------------------------------------------
# Differentiable constructors on tensors (``core/transform.py:16-105``):
# a transform is a plain (..., 4, 4) tensor, differentiable in every
# argument, so that a vertex edit built from latent angles carries the
# gradient back to them.
# ---------------------------------------------------------------------------

def _f32(x, like=None) -> torch.Tensor:
    """``x`` as a float32 tensor, on ``like``'s device where ``x`` is not
    a tensor yet."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def translate(v) -> torch.Tensor:
    v = _f32(v)
    top = torch.cat([torch.eye(3, dtype=v.dtype, device=v.device),
                     v.reshape(3, 1)], dim=1)
    return torch.cat([top, _bottom_row(v)], dim=0)


def _bottom_row(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=like.dtype,
                        device=like.device)


def scale(v) -> torch.Tensor:
    v = _f32(v)
    if v.dim() == 0:
        v = torch.stack([v, v, v])
    return torch.diag(torch.cat([v, torch.ones(1, dtype=v.dtype,
                                               device=v.device)]))


def rotate(axis, angle_deg) -> torch.Tensor:
    """Rotation about ``axis`` by ``angle_deg`` degrees (transform.h
    ``rotate``)."""
    axis = m.normalize(_f32(axis))
    angle = torch.deg2rad(_f32(angle_deg, axis))
    s, c = torch.sin(angle), torch.cos(angle)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    omc = 1.0 - c
    rot = torch.stack([
        torch.stack([c + x * x * omc, x * y * omc - z * s,
                     x * z * omc + y * s], -1),
        torch.stack([y * x * omc + z * s, c + y * y * omc,
                     y * z * omc - x * s], -1),
        torch.stack([z * x * omc - y * s, z * y * omc + x * s,
                     c + z * z * omc], -1)], dim=-2)
    top = torch.cat([rot, torch.zeros((3, 1), dtype=rot.dtype,
                                      device=rot.device)], dim=1)
    return torch.cat([top, _bottom_row(rot)], dim=0)


def look_at(origin, target, up) -> torch.Tensor:
    """Camera-to-world ``look_at`` (transform.h:358-377): +Z towards the
    target, +X = normalize(cross(up, dir)), +Y = cross(dir, left)."""
    origin = _f32(origin)
    target = _f32(target, origin)
    up = _f32(up, origin)
    dir_ = m.normalize(target - origin)
    left = m.normalize(m.cross(up, dir_))
    new_up = m.cross(dir_, left)
    mat = torch.stack([left, new_up, dir_, origin], dim=-1)   # columns
    return torch.cat([mat, _bottom_row(mat)], dim=0)


def perspective(fov_deg: float, near: float, far: float,
                device=None) -> torch.Tensor:
    """Perspective projection (transform.h ``perspective``)."""
    return torch.as_tensor(_np_perspective(fov_deg, near, far),
                           device=device)


def apply_point(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The transform applied to (..., 3) points, with the perspective
    division."""
    r = torch.einsum("...ij,...j->...i", t[..., :3, :3], p) + t[..., :3, 3]
    w = torch.einsum("...j,...j->...", t[..., 3, :3], p) + t[..., 3, 3]
    return r / w[..., None]


def apply_vector(t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", t[..., :3, :3], v)


def apply_normal(t: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Normals transform by the inverse transpose of the 3x3 block."""
    inv = torch.linalg.inv(t[..., :3, :3])
    return torch.einsum("...ji,...j->...i", inv, n)


def inverse(t: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv(t)


def compose(*ts: torch.Tensor) -> torch.Tensor:
    out = ts[0]
    for t in ts[1:]:
        out = out @ t
    return out
