"""Ray-triangle intersection and surface interactions (counterpart of
``ops/intersect.py``).

Traversal is split into a detached hit search producing a
``PreliminaryIntersection`` and a differentiable
``compute_surface_interaction``, which builds the shading record from the
hit triangle (mesh.cpp:640-830) and re-derives (t, u, v) by
Möller-Trumbore under ``replace_grad`` (mesh.cpp:688-695): the value
comes from the hit search, the gradient from the re-derivation.

``ray_intersect_brute`` and ``ray_test_brute`` are the plain versions of
kernel K1 (``ops/cuda_intersect.py``): they take the kernel's inputs, the
packed triangles ``tri`` (F, 12) = rows [p0, e1, e2, 0, 0, 0], of which
they read the first 9 columns (so (F, 9) rows do as well), and the rays
``o``, ``d`` (N, 3), ``maxt`` (N,), and repeat its arithmetic operation
for operation.
"""
from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from ..core import math as m
from ..models import textures as tex_mod
from ..models.records import (PreliminaryIntersection, Ray, RayFlags,
                              SurfaceInteraction)
from .gather import take_rows

_INF = float("inf")


def replace_grad(primal: torch.Tensor, grad_source: torch.Tensor):
    """dr.replace_grad: the value of ``primal``, the gradient of
    ``grad_source``."""
    return primal.detach() + (grad_source - grad_source.detach())


def _mt_edges(o, d, p0, e1, e2):
    """Möller-Trumbore on edge form (p0, e1 = p1 - p0, e2 = p2 - p0),
    component by component in the order of the kernel.  Arguments are
    tuples of three broadcastable tensors; returns (t, u, v, hit) where
    ``hit`` has the barycentric and determinant tests only."""
    ox, oy, oz = o
    dx, dy, dz = d
    p0x, p0y, p0z = p0
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok_det = torch.abs(det) > 1e-12
    # 1 / inf = 0 off the determinant test: the same values as a select
    # after the division, and a zero derivative there
    inv_det = 1.0 / torch.where(ok_det, det, _INF)
    tvx = ox - p0x
    tvy = oy - p0y
    tvz = oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = (u >= -1e-6) & (v >= -1e-6) & (u + v <= 1.0 + 1e-6) & ok_det
    return t, u, v, hit


def moeller_trumbore(ray_o, ray_d, p0, p1, p2):
    """Möller-Trumbore ray/triangle test (mesh.h:344) on (..., 3) tensors.

    Returns (t, u, v, hit_mask) with p = (1-u-v) p0 + u p1 + v p2."""
    e1 = p1 - p0
    e2 = p2 - p0
    return _mt_edges(ray_o.unbind(-1), ray_d.unbind(-1), p0.unbind(-1),
                     e1.unbind(-1), e2.unbind(-1))


def chunk_hits(tri, o, d, maxt, chunk):
    """Per chunk of C triangles: (base index, t (N, C), hit (N, C)), where
    ``hit`` holds every condition of a hit except being the closest."""
    oc = tuple(o[:, k][:, None] for k in range(3))
    dc = tuple(d[:, k][:, None] for k in range(3))
    for base in range(0, tri.shape[0], chunk):
        cols = [tri[base:base + chunk, k][None, :] for k in range(9)]
        t, _, _, hit = _mt_edges(oc, dc, cols[0:3], cols[3:6], cols[6:9])
        yield base, t, hit & (t > 1e-6) & (t < maxt[:, None])


def ray_intersect_brute(tri, o, d, maxt, chunk: int = 512):
    """Closest hit of every ray against every triangle (K1's plain
    version).

    A hit needs |det| > 1e-12, u >= -1e-6, v >= -1e-6, u+v <= 1+1e-6 and
    1e-6 < t < maxt; the closest wins and the lowest index wins a tie.
    Returns (t (N,) inf on a miss, prim (N,) int32 -1 on a miss, u, v
    (N,) 0 on a miss)."""
    n = o.shape[0]
    best_t = torch.full((n,), _INF, dtype=o.dtype, device=o.device)
    best_idx = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    for base, t, hit in chunk_hits(tri, o, d, maxt, chunk):
        tmin, amin = torch.min(torch.where(hit, t, _INF), dim=1)
        closer = tmin < best_t
        best_t = torch.where(closer, tmin, best_t)
        best_idx = torch.where(closer, base + amin, best_idx)
    valid = best_idx >= 0
    # (u, v) of the winning triangle: the same arithmetic once more
    w = tri[torch.clamp(best_idx, min=0)]
    _, u, v, _ = _mt_edges(o.unbind(-1), d.unbind(-1), w[:, 0:3].unbind(-1),
                           w[:, 3:6].unbind(-1), w[:, 6:9].unbind(-1))
    return (best_t, best_idx.to(torch.int32), torch.where(valid, u, 0.0),
            torch.where(valid, v, 0.0))


def ray_test_brute(tri, o, d, maxt, chunk: int = 512) -> torch.Tensor:
    """Any-hit (shadow ray) test, K1's plain version: True where some
    triangle passes the closest-hit test's conditions."""
    occluded = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for _, _, hit in chunk_hits(tri, o, d, maxt, chunk):
        occluded = occluded | torch.any(hit, dim=1)
    return occluded


def _carries_derivative(*xs: torch.Tensor) -> bool:
    """A derivative can reach one of ``xs``: grad mode is on and it
    requires grad, or it carries a forward-mode tangent."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return True
    return any(fwAD.unpack_dual(x).tangent is not None for x in xs)


def compute_surface_interaction(scene, ray: Ray, pi: PreliminaryIntersection,
                                ray_flags: int = RayFlags.All
                                ) -> SurfaceInteraction:
    """SurfaceInteraction from a detached hit record (mesh.cpp:640-830),
    with the EPSM per-hit fields and the reference's gradient rules:

    - default: t, u and v take the gradient of their Möller-Trumbore
      re-derivation (``replace_grad``), so ``si.p`` tracks the vertices;
    - ``DetachShape``: the triangle's vertices and normals are detached,
      so ``si.p`` tracks only the ray;
    - ``FollowShape``: t, u and v are detached, so ``si.p`` follows the
      triangle rigidly, and t is recomputed from it (mesh.cpp:723-725).

    The re-derivation runs only where a derivative (a gradient, or a
    forward-mode tangent) can reach the vertices or the ray; its value is
    the hit search's either way.  Per-face quantities are
    gathered by ``take_rows``.

    Where a BSDF slot carries a normal or bump map (``has_normal_maps``)
    the shading normal is perturbed by its texture at the hit's uv before
    the frame is built (normalmap.cpp, JAX ``ops/intersect.py:287-300``):
    ``tn = 2 tex - 1`` in the tangent frame ``coordinate_system(ns)``.
    Where a texture is a ``mesh_attribute`` (``has_vertex_colors``) the
    record carries the interpolated vertex colour ``vcolor``.

    A scene with analytic spheres (``Scene.sph_data``) encodes a sphere
    hit as ``prim_index`` F + slot: those lanes read a stand-in face, and
    their t, p, normals, uv and indices are the sphere's
    (``ops/quadric.py`` ``sphere_surface_fields``); their vertices,
    vertex normals and barycentrics are 0 and ``ismesh`` is 0 (JAX
    ``ops/intersect.py:178-187``, :303-320).  A scene of spheres alone
    gathers from one degenerate stand-in face."""
    sph = getattr(scene, "sph_data", None)
    is_sph = sidx = None
    if sph is not None:
        nf = scene.faces.shape[0]
        prim = pi.prim_index.long()
        is_sph = prim >= nf
        sidx = torch.clamp(prim - nf, 0, sph.shape[0] - 1)
        if nf == 0:
            scene = _stand_in_face(scene)
        fidx = torch.where(is_sph, 0, prim)
    else:
        fidx = pi.prim_index.long()
    f = scene.faces[fidx].long()                               # (N, 3)
    p0, p1, p2 = (take_rows(scene.vertices, f[:, k]) for k in range(3))
    n0, n1, n2 = (take_rows(scene.normals, f[:, k]) for k in range(3))
    if ray_flags & RayFlags.DetachShape:
        p0, p1, p2 = p0.detach(), p1.detach(), p2.detach()
        n0, n1, n2 = n0.detach(), n1.detach(), n2.detach()

    t = pi.t
    u = pi.prim_uv[:, 0]
    v = pi.prim_uv[:, 1]
    if ray_flags & RayFlags.FollowShape:
        t, u, v = t.detach(), u.detach(), v.detach()
    elif _carries_derivative(p0, ray.o, ray.d):
        t_d, u_d, v_d, _ = moeller_trumbore(ray.o, ray.d, p0, p1, p2)
        t = replace_grad(t, t_d)
        u = replace_grad(u, u_d)
        v = replace_grad(v, v_d)
    b0 = 1.0 - u - v
    p = p0 * b0[:, None] + p1 * u[:, None] + p2 * v[:, None]
    if ray_flags & RayFlags.FollowShape:
        t = torch.sqrt(m.squared_norm(p - ray.o) / torch.clamp(
            m.squared_norm(ray.d), min=1e-20))

    ng = m.normalize(m.cross(p1 - p0, p2 - p0))

    # shading normal: interpolated vertex normals where the mesh has them
    has_n = (m.squared_norm(n0) > 1e-12)[:, None]
    n0 = torch.where(has_n, n0, ng)
    n1 = torch.where(has_n, n1, ng)
    n2 = torch.where(has_n, n2, ng)
    ns = n0 * b0[:, None] + n1 * u[:, None] + n2 * v[:, None]
    ns = ns * m.safe_rsqrt(m.squared_norm(ns))[:, None]

    uvt = [take_rows(scene.uvs, f[:, k]) for k in range(3)]
    uv = uvt[0] * b0[:, None] + uvt[1] * u[:, None] + uvt[2] * v[:, None]

    shape_idx = scene.face_shape[fidx]
    bsdf_idx = scene.shape_bsdf[shape_idx.long()]
    emitter_idx = scene.shape_emitter[shape_idx.long()]

    if scene.static.has_normal_maps:
        ntex = scene.bsdfs["normal_tex"][bsdf_idx.long()]
        s0, t0 = m.coordinate_system(ns)
        flat = torch.cat([torch.full_like(ns[:, :2], 0.5),
                          torch.ones_like(ns[:, 2:])], -1)
        tn = tex_mod.eval_select(scene.normal_textures(), ntex, uv,
                                 flat) * 2.0 - 1.0
        ns_pert = m.normalize(s0 * tn[:, 0:1] + t0 * tn[:, 1:2]
                              + ns * tn[:, 2:3])
        ns = torch.where((ntex >= 0)[:, None], ns_pert, ns)

    ismesh = pi.valid
    if is_sph is not None:
        from . import quadric
        sf = quadric.sphere_surface_fields(scene, ray, pi, is_sph, sidx,
                                           ray_flags)
        sel = is_sph[:, None]
        t = torch.where(is_sph, sf["t"], t)
        p = torch.where(sel, sf["p"], p)
        ng = torch.where(sel, sf["n"], ng)
        ns = torch.where(sel, sf["n"], ns)
        uv = torch.where(sel, sf["uv"], uv)
        p0, p1, p2, n0, n1, n2 = (torch.where(sel, 0.0, x) for x in
                                  (p0, p1, p2, n0, n1, n2))
        b0 = torch.where(is_sph, 0.0, b0)
        u = torch.where(is_sph, 0.0, u)
        v = torch.where(is_sph, 0.0, v)
        sph_shape = sf["shape_idx"]
        shape_idx = torch.where(is_sph, sph_shape, shape_idx)
        bsdf_idx = torch.where(is_sph, scene.shape_bsdf[sph_shape.long()],
                               bsdf_idx)
        emitter_idx = torch.where(
            is_sph, scene.shape_emitter[sph_shape.long()], emitter_idx)
        ismesh = ismesh & ~is_sph

    vcolor = None
    if scene.static.has_vertex_colors:
        vc = [take_rows(scene.vertex_colors, f[:, k]) for k in range(3)]
        vcolor = (vc[0] * b0[:, None] + vc[1] * u[:, None]
                  + vc[2] * v[:, None])

    sh_s, sh_t = m.coordinate_system(ns)
    wi = m.to_local(ns, sh_s, sh_t, -ray.d)

    valid = pi.valid
    return SurfaceInteraction(
        t=torch.where(valid, t, _INF), p=p, n=ng, sh_n=ns, sh_s=sh_s,
        sh_t=sh_t, uv=uv, wi=wi, prim_index=pi.prim_index,
        shape_index=torch.where(valid, shape_idx, -1),
        bsdf_index=torch.where(valid, bsdf_idx, -1),
        emitter_index=torch.where(valid, emitter_idx, -1),
        valid=valid, b0=b0, b1=u, p0=p0, p1=p1, p2=p2, n0=n0, n1=n1, n2=n2,
        ismesh=ismesh.to(p.dtype), vcolor=vcolor)


def _stand_in_face(scene):
    """``scene`` with one degenerate face at the origin: the gathers of a
    scene of spheres alone stay well formed, and every valid lane is a
    sphere's."""
    from dataclasses import replace
    z3 = torch.zeros((1, 3), dtype=scene.vertices.dtype,
                     device=scene.vertices.device)
    return replace(
        scene, vertices=z3, normals=z3, uvs=z3[:, :2],
        faces=torch.zeros((1, 3), dtype=torch.int32, device=z3.device),
        face_shape=torch.zeros((1,), dtype=torch.int32, device=z3.device),
        vertex_colors=None if scene.vertex_colors is None else z3)
