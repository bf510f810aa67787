"""Interaction and sampling records (counterpart of ``models/records.py``).

Every record is a frozen dataclass of ``(N, ...)`` tensors over the ray
wavefront, including the EPSM per-hit triangle fields
``p0, p1, p2, n0, n1, n2, b0, b1, ismesh`` (interaction.h:221-224).
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Optional

import torch

from ..core import math as m


@dataclass(frozen=True)
class Ray:
    """Ray with optional differentials (mi.RayDifferential3f)."""

    o: torch.Tensor                     # (N, 3)
    d: torch.Tensor                     # (N, 3)
    maxt: torch.Tensor                  # (N,)
    d_x: Optional[torch.Tensor] = None  # (N, 3) x-offset pixel direction
    d_y: Optional[torch.Tensor] = None  # (N, 3)

    @staticmethod
    def make(o, d, maxt=None, d_x=None, d_y=None) -> "Ray":
        if maxt is None:
            maxt = torch.full(o.shape[:-1], float("inf"), dtype=o.dtype,
                              device=o.device)
        return Ray(o=o, d=d, maxt=maxt, d_x=d_x, d_y=d_y)

    def replace(self, **kw) -> "Ray":
        return replace(self, **kw)


@dataclass(frozen=True)
class PreliminaryIntersection:
    """Detached hit record; ``prim_index`` is 0 and ``valid`` False on a
    miss."""

    t: torch.Tensor           # (N,) inf on a miss
    prim_uv: torch.Tensor     # (N, 2) p = (1-u-v) p0 + u p1 + v p2
    prim_index: torch.Tensor  # (N,) int32 global face id
    valid: torch.Tensor       # (N,) bool

    def replace(self, **kw) -> "PreliminaryIntersection":
        return replace(self, **kw)


class RayFlags:
    """RayFlags (interaction.h:19-57)."""

    Empty = 0x0
    Minimal = 0x1
    UV = 0x2
    dPdUV = 0x4
    dNGdUV = 0x8
    dNSdUV = 0x10
    ShadingFrame = 0x20
    BoundaryTest = 0x40
    FollowShape = 0x80
    DetachShape = 0x100
    All = Minimal | UV | dPdUV | ShadingFrame


@dataclass(frozen=True)
class SurfaceInteraction:
    """SoA surface interaction with the EPSM per-hit triangle fields."""

    t: torch.Tensor              # (N,)
    p: torch.Tensor              # (N, 3)
    n: torch.Tensor              # (N, 3) geometric normal
    sh_n: torch.Tensor           # (N, 3) shading normal
    sh_s: torch.Tensor           # (N, 3) shading tangent
    sh_t: torch.Tensor           # (N, 3) shading bitangent
    uv: torch.Tensor             # (N, 2)
    wi: torch.Tensor             # (N, 3) incident direction, local frame
    prim_index: torch.Tensor     # (N,) int32
    shape_index: torch.Tensor    # (N,) int32, -1 on a miss
    bsdf_index: torch.Tensor     # (N,) int32, -1 on a miss
    emitter_index: torch.Tensor  # (N,) int32, -1 when not emissive
    valid: torch.Tensor          # (N,) bool
    b0: torch.Tensor             # (N,) barycentric weight of p0 (1-u-v)
    b1: torch.Tensor             # (N,) barycentric weight of p1 (u)
    p0: torch.Tensor             # (N, 3)
    p1: torch.Tensor
    p2: torch.Tensor
    n0: torch.Tensor             # (N, 3)
    n1: torch.Tensor
    n2: torch.Tensor
    ismesh: torch.Tensor         # (N,) float, 1 on a triangle hit
    #: (N, 3) interpolated vertex colour (``mesh_attribute`` textures);
    #: None when the scene has no such texture
    vcolor: Optional[torch.Tensor] = None

    def to_local(self, v):
        return m.to_local(self.sh_n, self.sh_s, self.sh_t, v)

    def detach(self) -> "SurfaceInteraction":
        return SurfaceInteraction(**{
            f.name: getattr(self, f.name) if getattr(self, f.name) is None
            else getattr(self, f.name).detach() for f in fields(self)})

    def to_world(self, v):
        return m.to_world(self.sh_n, self.sh_s, self.sh_t, v)

    def spawn_ray(self, d, eps: float = 1.0e-4) -> Ray:
        """Offset the origin along the geometric normal (shape.h)."""
        sign_ = torch.where(m.dot(d, self.n) >= 0.0, 1.0, -1.0)
        scale_ = (1.0 + torch.amax(torch.abs(self.p), dim=-1)) * eps
        o = self.p + (sign_ * scale_)[..., None] * self.n
        return Ray.make(o, d)


@dataclass(frozen=True)
class DirectionSample:
    """Emitter direction sample (records.h:110 ``DirectionSample3f``)."""

    p: torch.Tensor              # (N, 3) position on the emitter
    n: torch.Tensor              # (N, 3)
    uv: torch.Tensor             # (N, 2)
    d: torch.Tensor              # (N, 3) unit direction ref -> p
    dist: torch.Tensor           # (N,)
    pdf: torch.Tensor            # (N,) solid-angle pdf
    delta: torch.Tensor          # (N,) bool
    emitter_index: torch.Tensor  # (N,) int32

    def replace(self, **kw) -> "DirectionSample":
        return replace(self, **kw)


@dataclass(frozen=True)
class BSDFSample:
    """bsdf.h:180-240 ``BSDFSample3f`` with the EPSM half-vector ``hf``."""

    wo: torch.Tensor            # (N, 3) local frame
    pdf: torch.Tensor           # (N,)
    eta: torch.Tensor           # (N,)
    sampled_type: torch.Tensor  # (N,) int32 BSDFFlags of the sampled lobe
    hf: torch.Tensor            # (N, 3) sampled microfacet normal, local

    def replace(self, **kw) -> "BSDFSample":
        return replace(self, **kw)
