"""Emitters (counterpart of ``models/emitters.py``): the area emitter.

Emitter parameters live in one table.  Next-event estimation picks an
emitter uniformly (pmf 1/E, scene.cpp:87) and samples a point on it with
probability proportional to triangle area.  Triangle areas and their CDF
are recomputed from the current vertices on every call, as in the
reference, where vertex positions are optimization parameters.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core import math as m
from ..core import warp
from .records import DirectionSample

KIND_AREA = 0
KIND_CONSTANT = 2
KIND_ENVMAP = 3
KIND_NAMES = {"area": KIND_AREA}

def check_kinds(kinds_present: Tuple[int, ...]) -> None:
    """Raise unless every kind of the scene is one the port has."""
    missing = [k for k in kinds_present if k != KIND_AREA]
    if missing:
        raise NotImplementedError(
            f"emitter kinds {missing}: the port has the area emitter only")


def triangle_areas(vertices, faces):
    p0 = vertices[faces[:, 0]]
    p1 = vertices[faces[:, 1]]
    p2 = vertices[faces[:, 2]]
    sn = m.squared_norm(m.cross(p1 - p0, p2 - p0))
    return 0.5 * torch.sqrt(torch.clamp(sn, min=1e-30))


def area_emitter_data(vertices, faces, em_faces):
    """Per-emitter triangle CDFs from the current vertices.

    ``em_faces``: (E, Tmax) int32 global face ids, -1 padded.  Returns
    (cdf (E, Tmax) normalized, total_area (E,))."""
    valid = em_faces >= 0
    safe = torch.clamp(em_faces, min=0).long()
    areas = triangle_areas(vertices, faces.long())[safe] * valid
    cdf = torch.cumsum(areas, dim=-1)
    total = cdf[:, -1]
    return m.safe_div(cdf, total[:, None]), total


def sample_direction(table: Dict[str, torch.Tensor],
                     kinds_present: Tuple[int, ...], ref_p, sample2,
                     vertices, faces, em_faces):
    """Scene::sample_emitter_direction (scene.cpp:226-284) without the
    visibility test.  Returns (DirectionSample whose solid-angle pdf
    includes the 1/E pick, weight = radiance / pdf)."""
    check_kinds(kinds_present)
    n_em = table["kind"].shape[0]
    # uniform emitter pick with sample reuse (scene.cpp:87-107)
    scaled = sample2[..., 0] * n_em
    em_idx = torch.clamp(scaled.to(torch.int32), 0, n_em - 1)
    u0r = torch.clamp(scaled - em_idx, 0.0, 1.0 - 1e-7)
    s2 = torch.stack([u0r, sample2[..., 1]], dim=-1)

    cdf, total_area = area_emitter_data(vertices, faces, em_faces)
    ds, spec = _area_sample(table, ref_p, s2, em_idx, vertices, faces,
                            em_faces, cdf, total_area)
    ds = ds.replace(pdf=ds.pdf * (1.0 / n_em))
    ok = (ds.pdf > 0.0)[..., None]
    pdf_safe = torch.where(ok, ds.pdf[..., None], 1.0)
    return ds, torch.where(ok, spec / pdf_safe, 0.0)


def _area_sample(table, ref_p, s2, em_idx, vertices, faces, em_faces, cdf,
                 total_area):
    """Area emitter direction sample by uniform-area mesh sampling
    (area.cpp:94-117 -> mesh.cpp:530-560)."""
    em = em_idx.long()
    my_cdf = cdf[em]                                    # (N, Tmax)
    u = s2[..., 0]
    # slot = #{i : cdf[i] <= u}, clipped to Tmax - 1
    slot = torch.searchsorted(my_cdf, u[:, None].contiguous(),
                              right=True)[:, 0]
    tmax = em_faces.shape[1]
    slot = torch.clamp(slot, 0, tmax - 1)
    face_id = torch.clamp(em_faces[em, slot], min=0).long()
    tri = vertices[faces[face_id].long()]               # (N, 3, 3)
    p0, p1, p2 = tri[:, 0], tri[:, 1], tri[:, 2]
    lo = torch.where(
        slot > 0,
        torch.gather(my_cdf, 1, torch.clamp(slot - 1, min=0)[:, None])[:, 0],
        0.0)
    hi = torch.gather(my_cdf, 1, slot[:, None])[:, 0]
    u_r = torch.clamp(m.safe_div(u - lo, hi - lo), 0.0, 1.0 - 1e-7)
    b = warp.square_to_uniform_triangle(torch.stack([u_r, s2[..., 1]], -1))
    b0, b1 = b[..., 0:1], b[..., 1:2]
    pos = p0 * (1.0 - b0 - b1) + p1 * b0 + p2 * b1
    nrm = m.normalize(m.cross(p1 - p0, p2 - p0))

    dvec = pos - ref_p
    dist2 = m.squared_norm(dvec)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-18))
    d = m.safe_div(dvec, dist[..., None])
    cos_em = m.dot(-d, nrm)
    area = total_area[em]
    grazing_ok = cos_em > 1e-6
    denom_safe = torch.where(grazing_ok, cos_em * area, 1.0)
    pdf = torch.where(grazing_ok, dist2 / denom_safe, 0.0)
    spec = torch.where((cos_em > 0.0)[..., None], table["radiance"][em], 0.0)
    ds = DirectionSample(
        p=pos, n=nrm, uv=b, d=d, dist=dist, pdf=pdf,
        delta=torch.zeros_like(grazing_ok), emitter_index=em_idx)
    return ds, spec


def pdf_direction(table, kinds_present, ref_p, d, hit_emitter_idx, hit_p,
                  hit_n, vertices, faces, em_faces, active):
    """Scene::pdf_emitter_direction (scene.cpp:286-331): the solid-angle
    NEE pdf of having sampled direction ``d`` that hit emitter
    ``hit_emitter_idx`` at ``hit_p``/``hit_n``."""
    check_kinds(kinds_present)
    n_em = table["kind"].shape[0]
    safe_idx = torch.clamp(hit_emitter_idx, min=0).long()
    _, total_area = area_emitter_data(vertices, faces, em_faces)
    area = total_area[safe_idx]
    dist2 = m.squared_norm(hit_p - ref_p)
    cos_em = m.dot(-d, hit_n)
    pdf = torch.where(cos_em > 1e-7, m.safe_div(dist2, cos_em * area), 0.0)
    pdf = pdf / n_em
    return torch.where(active & (hit_emitter_idx >= 0), pdf, 0.0)


def eval_hit(table, si_emitter_idx, wi_local_z):
    """Area emitter radiance on a direct hit (area.cpp ``eval``), where
    the hit is on the emissive front side."""
    safe = torch.clamp(si_emitter_idx, min=0).long()
    vis = ((si_emitter_idx >= 0) & (table["kind"][safe] == KIND_AREA)
           & (wi_local_z > 0.0))
    return torch.where(vis[..., None], table["radiance"][safe], 0.0)


def eval_env(table, kinds_present, d):
    """Environment radiance of escaped rays: zero, since the port's scenes
    have no environment emitter yet."""
    if KIND_CONSTANT in kinds_present or KIND_ENVMAP in kinds_present:
        raise NotImplementedError(
            "environment emitters are not in the port yet")
    return torch.zeros_like(d)
