"""Acceleration dispatch (counterpart of ``ops/accel.py``).

Scenes of at most ``BRUTE_FORCE_MAX_TRIS`` triangles, and scenes without
a BVH, go to kernel K1 (brute force); every other scene goes through its
BVH4 to kernels K2 (closest hit; K4 with the ``multi_pop`` schedule) and
K3 (any hit).  On CPU tensors each kernel's plain version runs instead.
Hit search is detached: gradients come from the surface interaction.
A scene without triangles (analytic spheres alone) launches nothing:
every triangle query misses.

The kernels take float32: under a ``*_double`` variant (``config.py``)
the rays and the triangles are rounded to float32 for the query, and
its t, u and v are returned in the rays' type.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.records import PreliminaryIntersection, Ray
from . import cuda_intersect as CI
from . import cuda_traverse as CT

#: scenes with at most this many triangles use brute force
BRUTE_FORCE_MAX_TRIS = 4096


def use_brute_force(scene) -> bool:
    return (scene.faces.shape[0] <= BRUTE_FORCE_MAX_TRIS
            or scene.bvh is None)


def _rays(ray: Ray):
    return tuple(x.detach().to(torch.float32).contiguous()
                 for x in (ray.o, ray.d, ray.maxt))


def _tris(scene):
    return CI.pack_tris(scene.vertices.detach().to(torch.float32),
                        scene.faces)


def _miss(ray: Ray) -> PreliminaryIntersection:
    n, like = ray.o.shape[0], ray.o.detach()
    return PreliminaryIntersection(
        t=torch.full((n,), float("inf"), dtype=like.dtype,
                     device=like.device),
        prim_uv=torch.zeros((n, 2), dtype=like.dtype, device=like.device),
        prim_index=torch.zeros((n,), dtype=torch.int32, device=like.device),
        valid=torch.zeros((n,), dtype=torch.bool, device=like.device))


def ray_intersect(scene, ray: Ray, multi_pop: Optional[int] = None
                  ) -> PreliminaryIntersection:
    """Closest hits, detached.  ``multi_pop`` > 1 sends a BVH scene's
    rays to K4 (K2 popping up to that many nodes an iteration); ``None``
    leaves the choice to ``cuda_traverse.closest_hit``."""
    if scene.faces.shape[0] == 0:
        return _miss(ray)
    if use_brute_force(scene):
        t, prim, u, v = CI.closest_hit(_tris(scene), *_rays(ray))
        valid = prim >= 0
    else:
        t, slot, u, v = CT.closest_hit(scene.bvh_nodes, scene.bvh_tris,
                                       *_rays(ray), multi_pop=multi_pop,
                                       tri_k=scene.bvh_tris_k)
        valid = slot >= 0
        prim = scene.bvh.order[slot.clamp(min=0).long()]
    dtype = ray.o.dtype
    return PreliminaryIntersection(
        t=t.to(dtype), prim_uv=torch.stack([u, v], dim=-1).to(dtype),
        prim_index=torch.where(valid, prim, 0), valid=valid)


def ray_test(scene, ray: Ray) -> torch.Tensor:
    if scene.faces.shape[0] == 0:
        return torch.zeros(ray.o.shape[0], dtype=torch.bool,
                           device=ray.o.device)
    if use_brute_force(scene):
        return CI.any_hit(_tris(scene), *_rays(ray))
    return CT.any_hit(scene.bvh_nodes, scene.bvh_tris, *_rays(ray),
                      tri_k=scene.bvh_tris_k)
