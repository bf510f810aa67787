"""Emitters (counterpart of ``models/emitters.py``): the eight kinds of the
reference, area, point, constant, envmap, directional, spot, projector and
directionalarea.

Emitter parameters live in one table, one row an emitter.  Next-event
estimation picks an emitter uniformly (pmf 1/E, scene.cpp:87) and samples
a direction on it: area and directionalarea emitters a point with
probability proportional to triangle area, point, spot and projector
lights their position, directional lights their direction, the constant
environment a uniform direction and the envmap a texel by its luminance.
Triangle areas and their CDF are recomputed from the current vertices on
every call, as in the reference, where vertex positions are optimization
parameters: every function here is differentiable w.r.t. the vertices,
the table's columns and the envmap's texels.  Far lights (constant,
envmap, directional) put their point ``_WORLD_RADIUS`` away.
``register_emitter`` adds a kind written by the user in torch.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..core import math as m
from ..core import warp
from ..core.distr2d import bisect_rows
from ..ops.gather import take_rows
from . import textures as tex_mod
from .records import DirectionSample

KIND_AREA = 0
KIND_POINT = 1
KIND_CONSTANT = 2
KIND_ENVMAP = 3
KIND_DIRECTIONAL = 4
KIND_SPOT = 5
KIND_PROJECTOR = 6
KIND_DIRECTIONALAREA = 7

KIND_NAMES = {
    "area": KIND_AREA,
    "point": KIND_POINT,
    "constant": KIND_CONSTANT,
    "envmap": KIND_ENVMAP,
    "directional": KIND_DIRECTIONAL,
    "spot": KIND_SPOT,
    "projector": KIND_PROJECTOR,
    "directionalarea": KIND_DIRECTIONALAREA,
}

#: pseudo-infinite distance of the constant, envmap and directional lights
_WORLD_RADIUS = 1.0e5

#: the table's integer columns; every other column is float32
INT_COLUMNS = ("kind", "shape_index", "texture_index")


def check_kinds(kinds_present: Tuple[int, ...]) -> None:
    """Raise unless every kind of the scene is one the port has (a
    built-in kind or one of ``register_emitter``)."""
    missing = [k for k in kinds_present if k not in KIND_NAMES.values()]
    if missing:
        raise NotImplementedError(f"emitter kinds {missing} are unknown")


def empty_table(n: int) -> Dict[str, torch.Tensor]:
    """A table of ``n`` rows with the reference's defaults (:47-64)."""
    f = torch.float32

    def rows(v):
        return torch.tensor([v], dtype=f).repeat(n, 1)

    def full(v):
        # the default in float32, as jnp computes it
        return torch.full((n,), float(torch.tensor(v, dtype=f)), dtype=f)

    return {
        "kind": torch.zeros((n,), dtype=torch.int32),
        "radiance": torch.ones((n, 3), dtype=f),    # area/constant/envmap
        "intensity": torch.ones((n, 3), dtype=f),   # point/spot/projector
        "irradiance": torch.ones((n, 3), dtype=f),  # directional
        "position": torch.zeros((n, 3), dtype=f),   # point/spot/projector
        "direction": rows([0.0, 0.0, 1.0]),
        "cutoff_cos": full(math.cos(math.radians(20.0))),  # spot
        "beam_cos": full(math.cos(math.radians(15.0))),
        "shape_index": torch.full((n,), -1, dtype=torch.int32),
        "texture_index": torch.full((n,), -1, dtype=torch.int32),
        # the projector's frame and field of view (projector.cpp)
        "frame_x": rows([1.0, 0.0, 0.0]),
        "frame_y": rows([0.0, 1.0, 0.0]),
        "tan_fov": torch.full((n, 2), float(torch.tan(torch.tensor(
            math.radians(45.0) / 2, dtype=f))), dtype=f),
    }


#: the table's columns
COLUMNS = tuple(empty_table(0))


def _dir_to_latlong_uv(d: torch.Tensor) -> torch.Tensor:
    """World direction -> lat-long uv (envmap.cpp convention, y up)."""
    u = torch.atan2(d[..., 0], -d[..., 2]) * (0.5 / math.pi) + 0.5
    v = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0)) * (1.0 / math.pi)
    return torch.stack([u, v], -1)


def triangle_areas(vertices, faces):
    p0, p1, p2 = (take_rows(vertices, faces[:, k]) for k in range(3))
    sn = m.squared_norm(m.cross(p1 - p0, p2 - p0))
    return 0.5 * torch.sqrt(torch.clamp(sn, min=1e-30))


def area_emitter_data(vertices, faces, em_faces):
    """Per-emitter triangle CDFs from the current vertices.

    ``em_faces``: (E, Tmax) int32 global face ids, -1 padded.  Returns
    (cdf (E, Tmax) normalized, total_area (E,))."""
    valid = em_faces >= 0
    safe = torch.clamp(em_faces, min=0).long()
    areas = take_rows(triangle_areas(vertices, faces.long()), safe) * valid
    cdf = torch.cumsum(areas, dim=-1)
    total = cdf[:, -1]
    return m.safe_div(cdf, total[:, None]), total


class _Rows(dict):
    """The table's rows of the picked emitters, a column gathered at its
    first use: a scene gathers only the columns its kinds read."""

    def __init__(self, table, idx):
        super().__init__()
        self.table, self.idx = table, idx

    def __missing__(self, k):
        self[k] = take_rows(self.table[k], self.idx)
        return self[k]


def _env_tex(textures, env_texture: int):
    return (textures[env_texture]
            if 0 <= env_texture < len(textures) else None)


def sample_direction(table: Dict[str, torch.Tensor],
                     kinds_present: Tuple[int, ...], ref_p, sample2,
                     vertices, faces, em_faces, textures=(),
                     env_texture: int = -1):
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
    p_em = _Rows(table, em_idx)

    cdf = total_area = None
    if KIND_AREA in kinds_present or KIND_DIRECTIONALAREA in kinds_present:
        cdf, total_area = area_emitter_data(vertices, faces, em_faces)
    env_tex = _env_tex(textures, env_texture)
    ds_out = spec_out = None
    for kind in kinds_present:
        if kind in (KIND_AREA, KIND_DIRECTIONALAREA):
            ds, spec = _area_sample(p_em, ref_p, s2, em_idx, vertices, faces,
                                    em_faces, cdf, total_area)
        elif kind == KIND_ENVMAP:
            ds, spec = _envmap_sample(p_em, ref_p, s2, em_idx, env_tex)
        elif kind == KIND_PROJECTOR:
            ds, spec = _projector_sample(p_em, ref_p, s2, em_idx, textures)
        else:
            ds, spec = _SAMPLE_FNS[kind](p_em, ref_p, s2, em_idx)
        if ds_out is None:
            ds_out, spec_out = ds, spec
        else:
            is_k = p_em["kind"] == kind
            ds_out = _select_ds(is_k, ds, ds_out)
            spec_out = torch.where(is_k[..., None], spec, spec_out)

    ds_out = ds_out.replace(pdf=ds_out.pdf * (1.0 / n_em),
                            emitter_index=em_idx)
    # weight = radiance / pdf (scene.cpp:265-270); double-where so the
    # zero-pdf branch takes no (possibly NaN/inf) gradient
    ok = (ds_out.pdf > 0.0)[..., None]
    pdf_safe = torch.where(ok, ds_out.pdf[..., None], 1.0)
    return ds_out, torch.where(ok, spec_out / pdf_safe, 0.0)


def _select_ds(mask, a: DirectionSample, b: DirectionSample):
    mm = mask[..., None]
    return DirectionSample(
        p=torch.where(mm, a.p, b.p), n=torch.where(mm, a.n, b.n),
        uv=torch.where(mm, a.uv, b.uv), d=torch.where(mm, a.d, b.d),
        dist=torch.where(mask, a.dist, b.dist),
        pdf=torch.where(mask, a.pdf, b.pdf),
        delta=torch.where(mask, a.delta, b.delta),
        emitter_index=torch.where(mask, a.emitter_index, b.emitter_index))


def _area_sample(p_em, ref_p, s2, em_idx, vertices, faces, em_faces, cdf,
                 total_area):
    """Area emitter direction sample by uniform-area mesh sampling
    (area.cpp:94-117 -> mesh.cpp:530-560); also directionalarea's."""
    em = em_idx.long()
    my_cdf = take_rows(cdf, em)                         # (N, Tmax)
    u = s2[..., 0]
    # slot = #{i : cdf[i] <= u}, clipped to Tmax - 1
    slot = torch.searchsorted(my_cdf.detach(), u[:, None].contiguous(),
                              right=True)[:, 0]
    tmax = em_faces.shape[1]
    slot = torch.clamp(slot, 0, tmax - 1)
    face_id = torch.clamp(em_faces[em, slot], min=0).long()
    tri = take_rows(vertices, faces[face_id])           # (N, 3, 3)
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
    area = take_rows(total_area, em)
    # a lane that picked a light of another kind reads a row without
    # triangles (area 0, face 0 stands in): pdf 0 there, where the
    # reference's dist2 / 0 gives face 0's vertices a NaN gradient through
    # the select (ROADMAP.md queue 3)
    grazing_ok = (cos_em > 1e-6) & (area > 0.0)
    denom_safe = torch.where(grazing_ok, cos_em * area, 1.0)
    pdf = torch.where(grazing_ok, dist2 / denom_safe, 0.0)
    spec = torch.where((cos_em > 0.0)[..., None], p_em["radiance"], 0.0)
    ds = DirectionSample(
        p=pos, n=nrm, uv=b, d=d, dist=dist, pdf=pdf,
        delta=torch.zeros_like(grazing_ok), emitter_index=em_idx)
    return ds, spec


def _point_sample(p_em, ref_p, s2, em_idx):
    dvec = p_em["position"] - ref_p
    dist2 = m.squared_norm(dvec)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-18))
    d = m.safe_div(dvec, dist[..., None])
    spec = m.safe_div(p_em["intensity"], dist2[..., None])
    ds = DirectionSample(
        p=p_em["position"], n=-d, uv=torch.zeros_like(s2), d=d, dist=dist,
        pdf=torch.ones_like(dist),
        delta=torch.ones(dist.shape, dtype=torch.bool, device=dist.device),
        emitter_index=em_idx)
    return ds, spec


def _spot_sample(p_em, ref_p, s2, em_idx):
    ds, spec = _point_sample(p_em, ref_p, s2, em_idx)
    # falloff between the beam and cutoff angles (spot.cpp falloff_curve)
    cos_a = m.dot(-ds.d, m.normalize(p_em["direction"]))
    t = (cos_a - p_em["cutoff_cos"]) / torch.clamp(
        p_em["beam_cos"] - p_em["cutoff_cos"], min=1e-6)
    fall = torch.clamp(t, 0.0, 1.0)
    return ds, spec * fall[..., None]


def _projector_sample(p_em, ref_p, s2, em_idx, textures=()):
    """Perspective texture projection (projector.cpp): a delta light at
    ``position`` whose intensity in each direction is the irradiance
    texture looked up through a pinhole mapping of that direction."""
    ds, spec = _point_sample(p_em, ref_p, s2, em_idx)
    w = -ds.d                                  # projector -> receiver
    z = m.normalize(p_em["direction"])
    wz = m.dot(w, z)
    wx = m.dot(w, p_em["frame_x"])
    wy = m.dot(w, p_em["frame_y"])
    ndc_x = wx / torch.clamp(wz, min=1e-6) / p_em["tan_fov"][..., 0]
    ndc_y = wy / torch.clamp(wz, min=1e-6) / p_em["tan_fov"][..., 1]
    inside = ((wz > 0.0) & (torch.abs(ndc_x) <= 1.0)
              & (torch.abs(ndc_y) <= 1.0))
    uv = torch.stack([0.5 * (ndc_x + 1.0), 0.5 * (ndc_y + 1.0)], -1)
    ones = torch.ones(uv.shape[:-1] + (3,), dtype=uv.dtype, device=uv.device)
    rgb = (tex_mod.eval_select(textures, p_em["texture_index"], uv, ones)
           if textures else ones)
    return ds.replace(uv=uv), torch.where(inside[..., None], spec * rgb, 0.0)


def _constant_sample(p_em, ref_p, s2, em_idx):
    d = warp.square_to_uniform_sphere(s2)
    pdf = warp.square_to_uniform_sphere_pdf(d)
    ds = DirectionSample(
        p=ref_p + d * _WORLD_RADIUS, n=-d, uv=s2, d=d,
        dist=torch.full_like(pdf, _WORLD_RADIUS), pdf=pdf,
        delta=torch.zeros(pdf.shape, dtype=torch.bool, device=pdf.device),
        emitter_index=em_idx)
    return ds, p_em["radiance"]


def envmap_weights(tex) -> torch.Tensor:
    """Luminance x sin(theta) sampling weights of a lat-long envmap
    (envmap.cpp builds the same table into a Hierarchical2D warp), in
    float64: the CDFs summed from them then round alike whatever order a
    device sums in, so that the card and the CPU pick the same texel
    (the reference's float32 sums, ``ROADMAP.md`` queue 3)."""
    h = tex.data.shape[0]
    data = tex.data.to(torch.float64)
    lum = data[..., 0] * 0.2126 + data[..., 1] * 0.7152 + data[..., 2] * 0.0722
    theta = ((torch.arange(h, dtype=torch.float64, device=data.device) + 0.5)
             / h * math.pi)
    return lum * torch.sin(theta)[:, None] + 1e-12


def _envmap_sample(p_em, ref_p, s2, em_idx, env_tex=None):
    """A texel in proportion to ``envmap_weights`` (the Marginal2D of
    include/mitsuba/core/distr_2d.h): the row by a search of the shared
    row CDF, the column by bisecting the lane's row of the column CDFs
    (``bisect_rows``: no (N, W) gather), both in float64."""
    if env_tex is None:
        return _constant_sample(p_em, ref_p, s2, em_idx)
    wgt = envmap_weights(env_tex)                       # (H, W)
    h, w = wgt.shape
    row_cdf = torch.cumsum(torch.sum(wgt, dim=1), dim=0)
    total = row_cdf[-1]
    row_cdf = row_cdf / total
    col_cdf = torch.cumsum(wgt, dim=1)
    col_cdf = col_cdf / col_cdf[:, -1:]
    u64 = s2.detach().to(wgt.dtype)
    y = torch.clamp(torch.searchsorted(row_cdf.detach(),
                                       u64[..., 1].contiguous(), right=True),
                    0, h - 1)
    x = torch.clamp(bisect_rows(col_cdf, y, u64[..., 0]), 0, w - 1)
    texel = y * w + x
    # the texel's centre
    u = (x.to(torch.float32) + 0.5) / w
    v = (y.to(torch.float32) + 0.5) / h
    phi = (u - 0.5) * (2.0 * math.pi)
    theta = v * math.pi
    sin_t = torch.sin(theta)
    d = torch.stack([sin_t * torch.sin(phi), torch.cos(theta),
                     -sin_t * torch.cos(phi)], -1)
    # pdf: p(texel) / its solid angle 2 pi^2 sin(theta) / (H W)
    p_texel = take_rows(wgt.reshape(-1), texel) / total
    pdf = (p_texel * (h * w) / torch.clamp(2.0 * math.pi * math.pi * sin_t,
                                           min=1e-12)).to(sin_t.dtype)
    spec = p_em["radiance"] * take_rows(
        env_tex.data.reshape(h * w, -1), texel)
    ds = DirectionSample(
        p=ref_p + d * _WORLD_RADIUS, n=-d, uv=torch.stack([u, v], -1), d=d,
        dist=torch.full_like(pdf, _WORLD_RADIUS), pdf=pdf,
        delta=torch.zeros(pdf.shape, dtype=torch.bool, device=pdf.device),
        emitter_index=em_idx)
    return ds, spec


def envmap_pdf_direction(env_tex, d: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of the envmap's sampler for direction ``d``."""
    wgt = envmap_weights(env_tex)
    h, w = wgt.shape
    total = torch.sum(wgt)
    uv = _dir_to_latlong_uv(d)
    x = torch.clamp((uv[..., 0] * w).to(torch.int32), 0, w - 1)
    y = torch.clamp((uv[..., 1] * h).to(torch.int32), 0, h - 1)
    sin_t = torch.sqrt(torch.clamp(1.0 - d[..., 1] ** 2, min=1e-12))
    pdf = (take_rows(wgt.reshape(-1), y * w + x) / total) * (h * w) \
        / torch.clamp(2.0 * math.pi * math.pi * sin_t, min=1e-12)
    return pdf.to(d.dtype)


def _directional_sample(p_em, ref_p, s2, em_idx):
    d = -m.normalize(p_em["direction"])
    dist = torch.full(ref_p.shape[:-1], _WORLD_RADIUS, dtype=ref_p.dtype,
                      device=ref_p.device)
    ds = DirectionSample(
        p=ref_p + d * _WORLD_RADIUS, n=-d, uv=s2, d=d, dist=dist,
        pdf=torch.ones_like(dist),
        delta=torch.ones(dist.shape, dtype=torch.bool, device=dist.device),
        emitter_index=em_idx)
    return ds, p_em["irradiance"]


_SAMPLE_FNS = {
    KIND_POINT: _point_sample,
    KIND_SPOT: _spot_sample,
    KIND_CONSTANT: _constant_sample,
    KIND_DIRECTIONAL: _directional_sample,
}


def pdf_direction(table, kinds_present, ref_p, d, hit_emitter_idx, hit_p,
                  hit_n, vertices, faces, em_faces, active, textures=(),
                  env_texture: int = -1):
    """Scene::pdf_emitter_direction (scene.cpp:286-331): the solid-angle
    NEE pdf of having sampled direction ``d`` that hit emitter
    ``hit_emitter_idx`` at ``hit_p``/``hit_n``.  Delta lights have pdf 0;
    the constant and envmap lights the pdf of their own sampler."""
    check_kinds(kinds_present)
    n_em = table["kind"].shape[0]
    safe_idx = torch.clamp(hit_emitter_idx, min=0).long()
    kind = take_rows(table["kind"], safe_idx)
    pdf = torch.zeros(ref_p.shape[:-1], dtype=ref_p.dtype,
                      device=ref_p.device)
    if KIND_AREA in kinds_present or KIND_DIRECTIONALAREA in kinds_present:
        _, total_area = area_emitter_data(vertices, faces, em_faces)
        area = take_rows(total_area, safe_idx)
        dist2 = m.squared_norm(hit_p - ref_p)
        cos_em = m.dot(-d, hit_n)
        pdf_area = torch.where(cos_em > 1e-7,
                               m.safe_div(dist2, cos_em * area), 0.0)
        is_area = (kind == KIND_AREA) | (kind == KIND_DIRECTIONALAREA)
        pdf = torch.where(is_area, pdf_area, pdf)
    if KIND_CONSTANT in kinds_present or KIND_ENVMAP in kinds_present:
        is_inf = (kind == KIND_CONSTANT) | (kind == KIND_ENVMAP)
        env_tex = _env_tex(textures, env_texture)
        inf_pdf = warp.square_to_uniform_sphere_pdf(d)
        if env_tex is not None:
            inf_pdf = torch.where(kind == KIND_ENVMAP,
                                  envmap_pdf_direction(env_tex, d), inf_pdf)
        pdf = torch.where(is_inf, inf_pdf, pdf)
    custom = [k for k in kinds_present if k in _CUSTOM_PDF_FNS]
    if custom:
        row = _Rows(table, safe_idx)
        for ck in custom:
            pdf = torch.where(kind == ck, _CUSTOM_PDF_FNS[ck](
                row, ref_p, d, hit_p, hit_n), pdf)
    pdf = pdf / n_em
    return torch.where(active & (hit_emitter_idx >= 0), pdf, 0.0)


def eval_hit(table, si_emitter_idx, wi_local_z, uv=None, *,
             kinds_present):
    """Radiance of an area (or directionalarea) emitter on a direct hit
    (area.cpp ``eval``), where the hit is on the emissive front side;
    a ``register_emitter`` kind's from its ``eval_hit_fn`` at the hit's
    ``uv`` (None where the caller has no surface record).  Only the
    plugin kinds in ``kinds_present`` (the scene's emitter kinds) are
    evaluated, as in the reference (:513-538)."""
    safe = torch.clamp(si_emitter_idx, min=0).long()
    kind = table["kind"][safe]
    vis = ((si_emitter_idx >= 0)
           & ((kind == KIND_AREA) | (kind == KIND_DIRECTIONALAREA))
           & (wi_local_z > 0.0))
    out = torch.where(vis[..., None], take_rows(table["radiance"], safe),
                      0.0)
    custom = [k for k in _CUSTOM_EVAL_FNS if k in kinds_present]
    if custom:
        row = _Rows(table, safe)
        for ck in custom:
            out = torch.where(((si_emitter_idx >= 0) & (kind == ck))[..., None],
                              _CUSTOM_EVAL_FNS[ck](row, wi_local_z, uv), out)
    return out


def eval_env(table, kinds_present, d, active, textures=(),
             env_texture: int = -1):
    """Environment radiance of escaped rays (constant.cpp / envmap.cpp):
    the constant lights' radiance summed, plus the envmaps' scale times
    the lat-long bitmap at ``d``; zero where not ``active``."""
    out = torch.zeros_like(d)
    if KIND_CONSTANT not in kinds_present and KIND_ENVMAP not in kinds_present:
        return out
    kind = table["kind"]
    rad = torch.sum(torch.where((kind == KIND_CONSTANT)[:, None],
                                table["radiance"], 0.0), dim=0)
    out = torch.broadcast_to(rad[None, :], d.shape)
    if KIND_ENVMAP in kinds_present:
        scale = torch.sum(torch.where((kind == KIND_ENVMAP)[:, None],
                                      table["radiance"], 0.0), dim=0)
        env_tex = _env_tex(textures, env_texture)
        if env_tex is not None:
            val = tex_mod.eval_one(env_tex, _dir_to_latlong_uv(d))
            out = out + scale[None, :] * val
        else:
            out = out + torch.broadcast_to(scale[None, :], d.shape)
    return torch.where(active[..., None], out, 0.0)


# ---------------------------------------------------------------------------
# plugins (register_emitter)
# ---------------------------------------------------------------------------

#: the first kind id of ``register_emitter``
_CUSTOM_KIND_BASE = 1000
_CUSTOM_PDF_FNS: Dict[int, object] = {}
_CUSTOM_EVAL_FNS: Dict[int, object] = {}


def register_emitter(name: str, *, sample_fn, pdf_fn=None,
                     eval_hit_fn=None) -> int:
    """An emitter plugin (``register_emitter``, :396-464; the reference's
    ``PluginManager::register_python_plugin``).  Each function is torch,
    of the lanes' table rows ``row`` (``position``, ``direction``,
    ``intensity``, ``radiance``, ``cutoff_cos``, ...: the columns the
    loader parses for every emitter, leaves that take a gradient):

    - ``sample_fn(row, ref_p, s2) -> (DirectionSample, spec (N, 3))``: a
      next-event direction from ``ref_p``; its pdf is the solid-angle pdf
      without the 1/E pick, which the dispatcher applies, and ``delta``
      marks a Dirac light.  A light without ``eval_hit_fn`` can never be
      hit, so it must mark its samples delta;
    - ``pdf_fn(row, ref_p, d, hit_p, hit_n) -> pdf (N,)``: that pdf, for
      the MIS of a BSDF-sampled hit;
    - ``eval_hit_fn(row, wi_local_z, uv) -> (N, 3)``: the radiance of a
      light on a shape, hit from a BSDF sample.  It needs ``pdf_fn``:
      without it NEE would be weighted against a BSDF leg of full weight
      and the image biased bright, so that raises, as in the reference.

    A gradient of the light's parameters reaches the NEE term through
    ``sample_fn`` (``ad/prb.py`` ``attached_emitter_weight``) by autograd.
    A scene names it as ``{"type": name, ...}``.  Returns the kind id,
    numbered from ``_CUSTOM_KIND_BASE``.  A name taken raises."""
    if name in KIND_NAMES:
        raise ValueError(f"emitter type '{name}' already registered")
    if eval_hit_fn is not None and pdf_fn is None:
        raise ValueError(
            f"emitter type '{name}': eval_hit_fn without pdf_fn would "
            "double-count: NEE is MIS-weighted against a BSDF-hit leg "
            "whose pdf_direction would be 0. Shape-attached custom "
            "emitters require both hooks.")
    kind = _CUSTOM_KIND_BASE + sum(1 for k in _SAMPLE_FNS
                                   if k >= _CUSTOM_KIND_BASE)
    KIND_NAMES[name] = kind

    def _wrapped(p_em, ref_p, s2, em_idx):
        ds, spec = sample_fn(p_em, ref_p, s2)
        return ds.replace(emitter_index=em_idx), spec

    _SAMPLE_FNS[kind] = _wrapped
    if pdf_fn is not None:
        _CUSTOM_PDF_FNS[kind] = pdf_fn
    if eval_hit_fn is not None:
        _CUSTOM_EVAL_FNS[kind] = eval_hit_fn
    return kind
