"""Acceleration dispatch (counterpart of ``ops/accel.py``).

Scenes of at most ``BRUTE_FORCE_MAX_TRIS`` triangles go to kernel K1 on
CUDA tensors, for every ray count, and to its plain versions on CPU
tensors.  Larger scenes need the BVH kernels, which are not ported yet.
"""
from __future__ import annotations

import torch

from ..models.records import PreliminaryIntersection, Ray
from . import cuda_intersect as CI

#: scenes with at most this many triangles use brute force
BRUTE_FORCE_MAX_TRIS = 4096


def _k1_inputs(scene, ray: Ray):
    nf = scene.faces.shape[0]
    if nf > BRUTE_FORCE_MAX_TRIS:
        raise NotImplementedError(
            f"scene has {nf} triangles: above {BRUTE_FORCE_MAX_TRIS} the "
            "reference traverses a BVH (kernels K2/K3), which the port "
            "gains with its BVH slice")
    return (CI.pack_tris(scene.vertices, scene.faces), ray.o.contiguous(),
            ray.d.contiguous(), ray.maxt.contiguous())


def ray_intersect(scene, ray: Ray) -> PreliminaryIntersection:
    t, prim, u, v = CI.closest_hit(*_k1_inputs(scene, ray))
    return PreliminaryIntersection(
        t=t, prim_uv=torch.stack([u, v], dim=-1),
        prim_index=torch.clamp(prim, min=0), valid=prim >= 0)


def ray_test(scene, ray: Ray) -> torch.Tensor:
    return CI.any_hit(*_k1_inputs(scene, ray))
