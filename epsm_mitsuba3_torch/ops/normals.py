"""Differentiable vertex normals (counterpart of ``ops/normals.py``, the
reference's ``Mesh::recompute_vertex_normals``, mesh.cpp:257-345).

Angle-weighted face normals summed per vertex ("Computing Vertex Normals
from Polygonal Facets", Thuermer & Wuethrich, JGT 1998) with
``index_add``, so ``torch.autograd`` carries a shading normal's gradient
to the vertex positions: the path through which a position reaches the
shading frame when ``params.update()`` moves a shape (mesh.cpp:85-87).
Since autograd chains the normals' cotangent onto the vertices itself,
the reference's ``fold_normal_cotangent`` (for callers working on raw
leaves) has no caller here.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch

from ..core import math as m


def compute_vertex_normals(vertices: torch.Tensor,
                           faces: torch.Tensor) -> torch.Tensor:
    """(V, 3) angle-weighted unit vertex normals of the (F, 3) faces.
    A vertex that no face references gets a zero normal."""
    idx = faces.long()
    v = [vertices[idx[:, k]] for k in range(3)]
    fn = m.normalize(m.cross(v[1] - v[0], v[2] - v[0]))
    acc = torch.zeros_like(vertices)
    for i in range(3):
        d0 = m.normalize(v[(i + 1) % 3] - v[i])
        d1 = m.normalize(v[(i + 2) % 3] - v[i])
        ang = m.safe_acos(torch.clamp(m.dot(d0, d1), -1.0, 1.0))
        acc = acc.index_add(0, idx[:, i], fn * ang[:, None])
    return acc * m.safe_rsqrt(m.squared_norm(acc))[:, None]


def refresh_smooth_normals(scene, rows_mask: Optional[torch.Tensor] = None):
    """The scene with the smooth-shaded rows of ``scene.normals``
    recomputed from its vertices, differentiably.  A flat-shaded row
    (stored normal 0: the face normal at a hit) stays 0; ``rows_mask``
    (V,) bool restricts the refresh to a subset of rows (the shapes that
    moved, so that a normal field set on another shape survives).  A
    recomputed normal takes the sign of the stored one."""
    smooth = m.squared_norm(scene.normals) > 1e-12
    if rows_mask is not None:
        smooth = smooth & rows_mask
    fresh = compute_vertex_normals(scene.vertices, scene.faces)
    flip = torch.where(m.dot(fresh, scene.normals) < 0.0, -1.0, 1.0)
    new = torch.where(smooth[:, None], fresh * flip[:, None], scene.normals)
    return replace(scene, normals=new)


def scene_with_vertices(scene, vertices: torch.Tensor):
    """The scene with new vertex positions and their smooth shading
    normals recomputed (differentiable in ``vertices``), and its BVH
    refit and its K2/K3 records re-packed from the detached positions
    (``Scene.set_vertices``).  Replacing the vertices alone leaves stale
    normals, through which no position gradient reaches the shading."""
    sc = refresh_smooth_normals(replace(scene, vertices=vertices))
    return sc.set_vertices(vertices) if sc.bvh is not None else sc
