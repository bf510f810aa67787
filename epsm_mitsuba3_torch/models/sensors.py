"""Sensors (counterpart of ``models/sensors.py``): the perspective
pinhole, ``thinlens``, ``orthographic``, ``distant``, ``radiancemeter``,
``irradiancemeter`` and the ``batch`` sensor (perspective sub-sensors
side by side on one film).

``sample_ray_differential`` turns film positions into the wavefront's
primary rays with their x/y-offset directions, which the EPSM
position channel reads (epsm.py:249-257).  ``point_to_film`` and
``project_to_film`` map world points and directions back to the film for
the reparameterised integrators (``ad/reparam.py``).  ``register_sensor``
adds a kind written by the user in torch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import math

import numpy as np
import torch

from ..core import math as m
from ..core import warp
from .records import Ray

#: the sensor kinds the port renders
KINDS = ("perspective", "thinlens", "orthographic", "radiancemeter",
         "irradiancemeter", "batch", "distant")


@dataclass(frozen=True)
class Sensor:
    to_world: torch.Tensor        # (4, 4) camera-to-world
    kind: str = "perspective"
    fov_x: float = 45.0           # degrees, x axis
    near: float = 1e-2
    far: float = 1e4
    width: int = 256              # film resolution
    height: int = 256
    rfilter: str = "gaussian"
    aperture_radius: float = 0.0  # thinlens
    focus_distance: float = 1.0   # thinlens
    #: the batch sensor (src/sensors/batch.cpp): S sub-sensors side by
    #: side on one film, sub s covering columns [s W / S, (s + 1) W / S)
    sub_to_world: Optional[torch.Tensor] = None   # (S, 4, 4)
    sub_fov_x: Tuple[float, ...] = ()


def _tan_half(fov_x: float) -> float:
    """tan(radians(fov_x) / 2), each step rounded to float32 as the
    reference computes it."""
    f32 = np.float32
    return float(np.tan(f32(fov_x) * f32(math.pi / 180.0) * f32(0.5)))


def _rotate(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R (3, 3) applied to (N, 3) vectors, column by column."""
    return (v[..., 0:1] * R[:, 0] + v[..., 1:2] * R[:, 1]
            + v[..., 2:3] * R[:, 2])


def _cam_dir(uu, vv, tan_half: float, aspect: float) -> torch.Tensor:
    """The camera-space direction of film sample (u, v):
    ``[(1-2u) tan_half, (1-2v) tan_half / aspect, 1]``."""
    return torch.stack([(1.0 - 2.0 * uu) * tan_half,
                        (1.0 - 2.0 * vv) * tan_half / aspect,
                        torch.ones_like(uu)], dim=-1)


def _axis(R: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The camera's +z axis in world space, one row a lane."""
    z = torch.zeros_like(like)
    z[..., 2] = 1.0
    return m.normalize(_rotate(R, z))


#: the kinds of ``register_sensor``: name -> sample fn
_CUSTOM_SENSOR_FNS = {}


def register_sensor(name: str, sample_fn) -> None:
    """A sensor plugin (``register_sensor``, :39-52; the reference's
    ``PluginManager::register_python_plugin``).  ``sample_fn(sensor,
    pos01 (N, 2)) -> (o (N, 3), d (N, 3), weight (N, 3) or None)`` maps
    film positions in [0, 1]^2 to primary rays, a torch function of the
    ``Sensor``'s ``to_world`` (a leaf) and its static fields.  The ray
    differentials are ``sample_fn`` at one-pixel offsets; a weight of None
    is 1.  A scene names it as ``{"type": name, ...}``.  A name taken
    raises."""
    if name in _CUSTOM_SENSOR_FNS or name in KINDS:
        raise ValueError(f"sensor type '{name}' already registered")
    _CUSTOM_SENSOR_FNS[name] = sample_fn


def is_kind(kind: str) -> bool:
    """``kind`` is a sensor the port renders."""
    return kind in KINDS or kind in _CUSTOM_SENSOR_FNS


def _sample_custom(sensor: Sensor, pos01: torch.Tensor):
    """A ``register_sensor`` kind's rays, the differentials from its
    function at one-pixel film offsets (:74-88)."""
    fn = _CUSTOM_SENSOR_FNS[sensor.kind]
    o, d, w = fn(sensor, pos01)
    du = torch.tensor([1.0 / sensor.width, 0.0], dtype=pos01.dtype,
                      device=pos01.device)
    dv = torch.tensor([0.0, 1.0 / sensor.height], dtype=pos01.dtype,
                      device=pos01.device)
    _, d_x, _ = fn(sensor, pos01 + du)
    _, d_y, _ = fn(sensor, pos01 + dv)
    ray = Ray.make(o, m.normalize(d), d_x=m.normalize(d_x),
                   d_y=m.normalize(d_y))
    if w is None:
        w = torch.ones(d.shape[:-1] + (3,), dtype=d.dtype, device=d.device)
    return ray, w


def sample_ray_differential(sensor: Sensor, pos01: torch.Tensor,
                            aperture_sample: Optional[torch.Tensor] = None):
    """Primary rays for film positions ``pos01`` in [0,1]^2
    (perspective.cpp ``sample_ray_differential`` and its kin).

    ``aperture_sample``: the thin lens's (N, 2) draw; with none the lens
    is sampled at its centre.  Returns (Ray with d_x/d_y differentials,
    weight (N, 3))."""
    if sensor.kind in _CUSTOM_SENSOR_FNS:
        return _sample_custom(sensor, pos01)
    if sensor.kind not in KINDS:
        raise NotImplementedError(f"sensor '{sensor.kind}' is not ported")
    if sensor.kind == "batch":
        return _sample_batch(sensor, pos01)
    aspect = sensor.width / sensor.height
    tan_half = _tan_half(sensor.fov_x)
    u, v = pos01[..., 0], pos01[..., 1]
    d_cam = _cam_dir(u, v, tan_half, aspect)
    R = sensor.to_world[:3, :3]
    o = sensor.to_world[:3, 3].expand(d_cam.shape)
    ones = torch.ones_like(d_cam)

    if sensor.kind in ("radiancemeter", "irradiancemeter"):
        # every sample leaves the sensor's origin: along +z, or cosine-
        # distributed about it from the film sample
        fwd = _axis(R, d_cam)
        if sensor.kind == "irradiancemeter":
            s_f, t_f = m.coordinate_system(fwd)
            d = m.to_world(fwd, s_f, t_f,
                           warp.square_to_cosine_hemisphere(pos01))
        else:
            d = fwd
        return Ray.make(o, d, d_x=d, d_y=d), ones
    if sensor.kind == "distant":
        # parallel rays from far away; the film sample moves the origin
        # across the sensor's plane
        d = _axis(R, d_cam)
        span = torch.stack([1.0 - 2.0 * u, (1.0 - 2.0 * v) / aspect,
                            torch.zeros_like(u)], dim=-1)
        o = o + _rotate(R, span) - d * 1.0e3
        return Ray.make(o, d, d_x=d, d_y=d), ones
    if sensor.kind == "orthographic":
        d = _axis(R, d_cam)
        flat = d_cam.clone()
        flat[..., 2] = 0.0
        o = o + _rotate(R, flat)
        return Ray.make(o, d, d_x=d, d_y=d), ones

    d_cam_x = _cam_dir(u + 1.0 / sensor.width, v, tan_half, aspect)
    d_cam_y = _cam_dir(u, v + 1.0 / sensor.height, tan_half, aspect)
    if sensor.kind == "thinlens" and sensor.aperture_radius > 0.0:
        if aperture_sample is None:
            aperture_sample = torch.zeros_like(pos01)
        ap = (warp.square_to_uniform_disk_concentric(aperture_sample)
              * sensor.aperture_radius)
        o_cam = torch.cat([ap, torch.zeros_like(ap[..., :1])], dim=-1)
        fd = sensor.focus_distance

        def through_focus(dc):
            return m.normalize(dc * (fd / dc[..., 2:3]) - o_cam)

        o = o + _rotate(R, o_cam)
        d = m.normalize(_rotate(R, through_focus(d_cam)))
        d_x = m.normalize(_rotate(R, through_focus(d_cam_x)))
        d_y = m.normalize(_rotate(R, through_focus(d_cam_y)))
    else:
        d = m.normalize(_rotate(R, d_cam))
        d_x = m.normalize(_rotate(R, d_cam_x))
        d_y = m.normalize(_rotate(R, d_cam_y))
    return Ray.make(o, d, d_x=d_x, d_y=d_y), ones


def _sample_batch(sensor: Sensor, pos01: torch.Tensor):
    """The batch sensor (src/sensors/batch.cpp): S perspective sub-sensors
    side by side; film columns [s W / S, (s + 1) W / S) belong to sub
    s.  Each lane selects its sub's rays."""
    S = sensor.sub_to_world.shape[0]
    u, v = pos01[..., 0], pos01[..., 1]
    fu = u * S
    idx = torch.clamp(fu.to(torch.int32), 0, S - 1)
    u_loc = fu - idx.to(fu.dtype)
    aspect = (sensor.width / S) / sensor.height
    du, dv = S / sensor.width, 1.0 / sensor.height
    o = torch.zeros(pos01.shape[:-1] + (3,), dtype=pos01.dtype,
                    device=pos01.device)
    d, d_x, d_y = torch.zeros_like(o), torch.zeros_like(o), torch.zeros_like(o)
    for s in range(S):
        sel = (idx == s)[..., None]
        th = _tan_half(sensor.sub_fov_x[s] if sensor.sub_fov_x else 45.0)
        R = sensor.sub_to_world[s, :3, :3]
        o = torch.where(sel, sensor.sub_to_world[s, :3, 3], o)
        d = torch.where(sel, m.normalize(_rotate(
            R, _cam_dir(u_loc, v, th, aspect))), d)
        d_x = torch.where(sel, m.normalize(_rotate(
            R, _cam_dir(u_loc + du, v, th, aspect))), d_x)
        d_y = torch.where(sel, m.normalize(_rotate(
            R, _cam_dir(u_loc, v + dv, th, aspect))), d_y)
    return Ray.make(o, d, d_x=d_x, d_y=d_y), torch.ones_like(d)


def point_to_film(sensor: Sensor, p_world: torch.Tensor
                  ) -> Optional[torch.Tensor]:
    """World point -> continuous film position in pixels
    (``point_to_film``, models/sensors.py:212-223): the camera-vertex
    reparameterisation re-projects ``ray.o + d_warped`` through the
    attached sensor, so the film position is differentiable in the point
    and in ``to_world`` (the only route of a camera translation's
    gradient).  None for kinds other than perspective and thin lens."""
    if sensor.kind not in ("perspective", "thinlens"):
        return None
    return project_to_film(sensor, p_world - sensor.to_world[:3, 3])


def project_to_film(sensor: Sensor, d_world: torch.Tensor
                    ) -> Optional[torch.Tensor]:
    """World direction -> continuous film position in pixels, the
    perspective inverse of ``sample_ray_differential``
    (``project_to_film``, models/sensors.py:226-245), differentiable in
    ``d_world`` and ``to_world``.  None for kinds other than perspective
    and thin lens."""
    if sensor.kind not in ("perspective", "thinlens"):
        return None
    aspect = sensor.width / sensor.height
    tan_half = _tan_half(sensor.fov_x)
    R = sensor.to_world[:3, :3]
    d_cam = d_world @ R                                    # R^T d
    z = torch.where(torch.abs(d_cam[..., 2]) < 1e-8, 1e-8, d_cam[..., 2])
    u = 0.5 * (1.0 - d_cam[..., 0] / (z * tan_half))
    v = 0.5 * (1.0 - d_cam[..., 1] * aspect / (z * tan_half))
    return torch.stack([u * sensor.width, v * sensor.height], dim=-1)
