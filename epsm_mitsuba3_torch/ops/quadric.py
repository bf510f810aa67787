"""Analytic spheres (counterpart of ``ops/quadric.py``, the reference's
src/shapes/sphere.cpp).

A sphere loaded with ``{"type": "sphere", "analytic": True}`` is no
triangles: it is a row [center, radius] of ``Scene.sph_data`` (S, 4),
owned by the shape ``Scene.sph_shape`` names.  The spheres are
intersected in closed form on every lane after the triangle query and
merged by the nearest t (``merge_spheres``); a sphere hit is encoded as
``prim_index = F + slot``, which ``compute_surface_interaction`` decodes.
The triangle query itself is kernel K1 or K2/K3, unchanged; a scene with
spheres and no triangle launches none (``ops/accel.py``).

The hit search is detached, as the triangles'.  ``sphere_surface_fields``
re-derives t from the quadratic's root under ``replace_grad``, so the
hit point and the normal take the derivative (a gradient or a
forward-mode tangent) of the ray, the centre and the radius
(sphere.cpp:325-360), with the FollowShape and DetachShape rules of the
triangles.  A sphere vertex has ``ismesh`` 0: the EPSM manifold chain
and the reparameterisation's edge term stop there, as in the reference.
"""
from __future__ import annotations

import math

import torch

from ..core import math as m
from ..models.records import PreliminaryIntersection, Ray, RayFlags
from .intersect import _carries_derivative, replace_grad

_EPS = 1e-4


def _roots(o, d, c, r):
    """The roots (t_near, t_far, has_roots) of |o + t d - c|^2 = r^2 in
    the stable form (``_roots``, :35-49); the arguments broadcast and the
    rays need not be unit.  The square root is taken of a positive
    stand-in off the discriminant's support, so its derivative never sees
    a non-positive operand."""
    oc = o - c
    a = torch.clamp(m.squared_norm(d), min=1e-20)
    b = m.dot(oc, d)
    q = m.squared_norm(oc) - r * r
    disc = b * b - a * q
    has = disc >= 0.0
    pos = disc > 1e-12
    sq = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    return (-b - sq) / a, (-b + sq) / a, has


def sphere_intersect(ray: Ray, sph_data: torch.Tensor):
    """The closest hit over all spheres, detached: (t (N,) inf on a miss,
    slot (N,) int64, valid (N,))."""
    o = ray.o.detach()[:, None, :]                      # (N, 1, 3)
    d = ray.d.detach()[:, None, :]
    sph = sph_data.detach().to(o.dtype)
    lo, hi, has = _roots(o, d, sph[None, :, :3], sph[None, :, 3])  # (N, S)
    t = torch.where(lo > _EPS, lo, hi)
    ok = has & (t > _EPS) & (t < ray.maxt.detach()[:, None])
    tmin, sidx = torch.min(torch.where(ok, t, math.inf), dim=1)
    return tmin, sidx, torch.isfinite(tmin)


def sphere_occluded(ray: Ray, sph_data: torch.Tensor) -> torch.Tensor:
    """Any hit over all spheres."""
    return sphere_intersect(ray, sph_data)[2]


def merge_spheres(scene, ray: Ray, pi: PreliminaryIntersection
                  ) -> PreliminaryIntersection:
    """The triangle query's record with the sphere hits that are closer
    (``merge_spheres``, :74-89); a sphere hit's uv is 0 and its
    ``prim_index`` F + slot."""
    t_s, sidx, valid_s = sphere_intersect(ray, scene.sph_data)
    t_s = t_s.to(pi.t.dtype)
    closer = valid_s & (t_s < torch.where(pi.valid, pi.t, math.inf))
    nf = scene.faces.shape[0]
    return PreliminaryIntersection(
        t=torch.where(closer, t_s, pi.t),
        prim_uv=torch.where(closer[:, None], 0.0, pi.prim_uv),
        prim_index=torch.where(closer, (nf + sidx).to(pi.prim_index.dtype),
                               pi.prim_index),
        valid=pi.valid | closer)


def sphere_surface_fields(scene, ray: Ray, pi: PreliminaryIntersection,
                          is_sph, sidx, ray_flags: int) -> dict:
    """The sphere's t, p, n, uv and owning shape on each lane
    (``sphere_surface_fields``, :92-143); the caller selects them where
    ``is_sph``.  Lanes that are no sphere hit, or whose t is not finite
    (a replayed inactive lane), compute on a well-conditioned stand-in (t
    1, the ray at the origin along +Z), so that no derivative divides by
    a zero direction."""
    sph = scene.sph_data
    if ray_flags & RayFlags.DetachShape:
        sph = sph.detach()
    c = sph[sidx, :3]
    r = sph[sidx, 3]
    ok = is_sph & torch.isfinite(pi.t)
    t0 = torch.where(ok, pi.t, 1.0)
    sel = ok[:, None]
    unit_z = torch.zeros_like(ray.d)
    unit_z[:, 2] = 1.0
    o = torch.where(sel, ray.o, 0.0)
    d = torch.where(sel, ray.d, unit_z)
    if ray_flags & RayFlags.FollowShape:
        # rigid attachment: the point moves with the sphere
        dir_unit = m.normalize(o + t0[:, None] * d - c).detach()
        p = c + r[:, None] * dir_unit
        t = torch.sqrt(m.squared_norm(p - o)
                       / torch.clamp(m.squared_norm(d), min=1e-20))
    else:
        t = t0
        if _carries_derivative(sph, o, d):
            lo, hi, _ = _roots(o, d, c, r)
            ts = t0.detach()
            t = replace_grad(t0, torch.where(
                torch.abs(lo - ts) <= torch.abs(hi - ts), lo, hi))
        p = o + t[:, None] * d
    n = (p - c) / torch.clamp(r, min=1e-12)[:, None]
    n = n * m.safe_rsqrt(m.squared_norm(n))[:, None]
    local = n.detach()
    phi = torch.atan2(local[:, 1], local[:, 0])
    theta = torch.acos(torch.clamp(local[:, 2], -1.0, 1.0))
    uv = torch.stack([phi / (2.0 * math.pi) + 0.5, theta / math.pi], -1)
    return {"t": t, "p": p, "n": n, "uv": uv,
            "shape_idx": scene.sph_shape[sidx]}
