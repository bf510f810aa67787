"""Host-side 4x4 transforms for scene descriptions (counterpart of the
numpy ``ScalarTransform4f`` in ``core/transform.py``).

Scene dicts build their matrices with this before any tensor exists, so
it is plain numpy, float32 like the reference.
"""
from __future__ import annotations

import numpy as np


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
