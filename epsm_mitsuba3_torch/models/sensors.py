"""Sensors (counterpart of ``models/sensors.py``): the perspective
pinhole camera."""
from __future__ import annotations

from dataclasses import dataclass

import math

import numpy as np
import torch

from ..core import math as m
from .records import Ray


@dataclass(frozen=True)
class Sensor:
    to_world: torch.Tensor        # (4, 4) camera-to-world
    kind: str = "perspective"
    fov_x: float = 45.0           # degrees, x axis
    width: int = 256              # film resolution
    height: int = 256
    rfilter: str = "gaussian"


def _rotate(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R (3, 3) applied to (N, 3) vectors, column by column."""
    return (v[..., 0:1] * R[:, 0] + v[..., 1:2] * R[:, 1]
            + v[..., 2:3] * R[:, 2])


def sample_ray_differential(sensor: Sensor, pos01: torch.Tensor):
    """Primary rays for film positions ``pos01`` in [0,1]^2
    (perspective.cpp ``sample_ray_differential``).

    Camera-space direction of film sample (u, v):
    ``[(1-2u) tan(fov_x/2), (1-2v) tan(fov_x/2)/aspect, 1]``.
    Returns (Ray with d_x/d_y differentials, weight (N, 3))."""
    if sensor.kind != "perspective":
        raise NotImplementedError(
            f"sensor '{sensor.kind}': the port has the perspective "
            "sensor only")
    aspect = sensor.width / sensor.height
    f32 = np.float32
    tan_half = float(np.tan(f32(sensor.fov_x) * f32(math.pi / 180.0)
                            * f32(0.5)))
    u = pos01[..., 0]
    v = pos01[..., 1]

    def cam_dir(uu, vv):
        return torch.stack([(1.0 - 2.0 * uu) * tan_half,
                            (1.0 - 2.0 * vv) * tan_half / aspect,
                            torch.ones_like(uu)], dim=-1)

    R = sensor.to_world[:3, :3]
    d = m.normalize(_rotate(R, cam_dir(u, v)))
    d_x = m.normalize(_rotate(R, cam_dir(u + 1.0 / sensor.width, v)))
    d_y = m.normalize(_rotate(R, cam_dir(u, v + 1.0 / sensor.height)))
    o = sensor.to_world[:3, 3].expand(d.shape)
    ray = Ray.make(o, d, d_x=d_x, d_y=d_y)
    return ray, torch.ones_like(d)
