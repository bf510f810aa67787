"""Acceleration dispatch (counterpart of ``ops/accel.py``).

Scenes of at most ``BRUTE_FORCE_MAX_TRIS`` triangles, and scenes without
a BVH, go to kernel K1 (brute force); every other scene goes through its
BVH4 to kernels K2 (closest hit; K4 with the ``multi_pop`` schedule) and
K3 (any hit).  On CPU tensors each kernel's plain version runs instead.
Hit search is detached: gradients come from the surface interaction.
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
    return (ray.o.detach().contiguous(), ray.d.detach().contiguous(),
            ray.maxt.detach().contiguous())


def _tris(scene):
    return CI.pack_tris(scene.vertices.detach(), scene.faces)


def ray_intersect(scene, ray: Ray, multi_pop: Optional[int] = None
                  ) -> PreliminaryIntersection:
    """Closest hits, detached.  ``multi_pop`` > 1 sends a BVH scene's
    rays to K4 (K2 popping up to that many nodes an iteration); ``None``
    leaves the choice to ``cuda_traverse.closest_hit``."""
    if use_brute_force(scene):
        t, prim, u, v = CI.closest_hit(_tris(scene), *_rays(ray))
        valid = prim >= 0
    else:
        t, slot, u, v = CT.closest_hit(scene.bvh_nodes, scene.bvh_tris,
                                       *_rays(ray), multi_pop=multi_pop,
                                       tri_k=scene.bvh_tris_k)
        valid = slot >= 0
        prim = scene.bvh.order[slot.clamp(min=0).long()]
    return PreliminaryIntersection(
        t=t, prim_uv=torch.stack([u, v], dim=-1),
        prim_index=torch.where(valid, prim, 0), valid=valid)


def ray_test(scene, ray: Ray) -> torch.Tensor:
    if use_brute_force(scene):
        return CI.any_hit(_tris(scene), *_rays(ray))
    return CT.any_hit(scene.bvh_nodes, scene.bvh_tris, *_rays(ray),
                      tri_k=scene.bvh_tris_k)
