"""Ray-triangle intersection and surface interactions (counterpart of
``ops/intersect.py``).

Traversal is split into a detached hit search producing a
``PreliminaryIntersection`` and ``compute_surface_interaction``, which
builds the shading record from the hit triangle (mesh.cpp:640-830).

``ray_intersect_brute`` and ``ray_test_brute`` are the plain versions of
kernel K1 (``ops/cuda_intersect.py``): they take the kernel's inputs, the
packed triangles ``tri`` (F, 9) = rows [p0, e1, e2] and the rays
``o``, ``d`` (N, 3), ``maxt`` (N,), and repeat its arithmetic operation
for operation.
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..models.records import (PreliminaryIntersection, Ray, RayFlags,
                              SurfaceInteraction)

_INF = float("inf")


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
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
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


def compute_surface_interaction(scene, ray: Ray, pi: PreliminaryIntersection,
                                ray_flags: int = RayFlags.All
                                ) -> SurfaceInteraction:
    """SurfaceInteraction from a detached hit record (mesh.cpp:640-830),
    primal only, with the EPSM per-hit fields.  Per-face quantities are
    gathered by plain indexing."""
    if ray_flags & (RayFlags.FollowShape | RayFlags.DetachShape):
        raise NotImplementedError(
            "FollowShape/DetachShape shape the gradients; they come with "
            "the PRB slice")
    fidx = pi.prim_index.long()
    f = scene.faces[fidx].long()                               # (N, 3)
    p0, p1, p2 = (scene.vertices[f[:, k]] for k in range(3))

    t = pi.t
    u = pi.prim_uv[:, 0]
    v = pi.prim_uv[:, 1]
    b0 = 1.0 - u - v
    p = p0 * b0[:, None] + p1 * u[:, None] + p2 * v[:, None]

    ng = m.normalize(m.cross(p1 - p0, p2 - p0))

    # shading normal: interpolated vertex normals where the mesh has them
    n0, n1, n2 = (scene.normals[f[:, k]] for k in range(3))
    has_n = (m.squared_norm(n0) > 1e-12)[:, None]
    n0 = torch.where(has_n, n0, ng)
    n1 = torch.where(has_n, n1, ng)
    n2 = torch.where(has_n, n2, ng)
    ns = n0 * b0[:, None] + n1 * u[:, None] + n2 * v[:, None]
    ns = ns * m.safe_rsqrt(m.squared_norm(ns))[:, None]

    uvt = [scene.uvs[f[:, k]] for k in range(3)]
    uv = uvt[0] * b0[:, None] + uvt[1] * u[:, None] + uvt[2] * v[:, None]

    sh_s, sh_t = m.coordinate_system(ns)

    shape_idx = scene.face_shape[fidx]
    bsdf_idx = scene.shape_bsdf[shape_idx.long()]
    emitter_idx = scene.shape_emitter[shape_idx.long()]
    wi = m.to_local(ns, sh_s, sh_t, -ray.d)

    valid = pi.valid
    return SurfaceInteraction(
        t=torch.where(valid, t, _INF), p=p, n=ng, sh_n=ns, sh_s=sh_s,
        sh_t=sh_t, uv=uv, wi=wi, prim_index=pi.prim_index,
        shape_index=torch.where(valid, shape_idx, -1),
        bsdf_index=torch.where(valid, bsdf_idx, -1),
        emitter_index=torch.where(valid, emitter_idx, -1),
        valid=valid, b0=b0, b1=u, p0=p0, p1=p1, p2=p2, n0=n0, n1=n1, n2=n2,
        ismesh=valid.to(p.dtype))
