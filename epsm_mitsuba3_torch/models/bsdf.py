"""BSDF models (counterpart of ``models/bsdf.py``): the diffuse BSDF, the
smooth conductor, the GGX rough conductor and the smooth dielectric, with
the two-sided wrapper.

All BSDFs of a scene live in one table of per-slot parameters.  ``sample``
and ``eval_pdf`` check the kinds present in the scene, evaluate each of
them on every lane and select per lane by the slot's kind, as the
reference does; a kind the port does not have yet raises.

A slot's ``reflectance`` may come from a texture (``reflectance_tex``,
-1 for none): ``sample`` and ``eval_pdf`` take the hit's ``uv``, the
textures the table names and the hit's vertex colour ``vcolor``, and
evaluate the texture per lane (``_apply_textures``, :1146-1170).  The
``normal_tex`` column (a normal or bump map) is read where the shading
frame is built (``ops/intersect.py``).

Conventions (bsdf.h): directions are in the local shading frame with the
normal = +Z; ``wi`` points away from the surface; ``sample`` returns
``weight = f * cos_theta_o / pdf``; ``eval_pdf`` returns ``f * cos_theta_o``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..core import math as m
from ..core import warp
from ..ops.gather import take_rows
from . import textures as tex_mod
from .records import BSDFSample


class BSDFFlags:
    """BSDFFlags bit layout (bsdf.h:18-80)."""

    Empty = 0x00000
    Null = 0x00001
    DiffuseReflection = 0x00002
    DiffuseTransmission = 0x00004
    GlossyReflection = 0x00008
    GlossyTransmission = 0x00010
    DeltaReflection = 0x00020
    DeltaTransmission = 0x00040
    Anisotropic = 0x01000
    SpatiallyVarying = 0x02000
    NonSymmetric = 0x04000
    FrontSide = 0x08000
    BackSide = 0x10000
    Reflection = DiffuseReflection | GlossyReflection | DeltaReflection
    Transmission = (DiffuseTransmission | GlossyTransmission
                    | DeltaTransmission | Null)
    Diffuse = DiffuseReflection | DiffuseTransmission
    Glossy = GlossyReflection | GlossyTransmission
    Smooth = Diffuse | Glossy
    Delta = DeltaReflection | DeltaTransmission | Null
    All = Reflection | Transmission


def has_flag(flags: torch.Tensor, flag: int) -> torch.Tensor:
    return (flags & flag) != 0


#: kind ids in the reference's numbering (``KIND_*``, :56-59)
KIND_DIFFUSE = 0
KIND_CONDUCTOR = 1
KIND_ROUGHCONDUCTOR = 2
KIND_DIELECTRIC = 3
KIND_NAMES = {"diffuse": KIND_DIFFUSE, "conductor": KIND_CONDUCTOR,
              "roughconductor": KIND_ROUGHCONDUCTOR,
              "dielectric": KIND_DIELECTRIC}
KIND_FLAGS = {
    KIND_DIFFUSE: BSDFFlags.DiffuseReflection | BSDFFlags.FrontSide,
    KIND_CONDUCTOR: BSDFFlags.DeltaReflection | BSDFFlags.FrontSide,
    KIND_ROUGHCONDUCTOR: BSDFFlags.GlossyReflection | BSDFFlags.FrontSide,
    KIND_DIELECTRIC: (BSDFFlags.DeltaReflection | BSDFFlags.DeltaTransmission
                      | BSDFFlags.FrontSide | BSDFFlags.BackSide
                      | BSDFFlags.NonSymmetric),
}
#: the table columns each kind reads, beside ``kind`` and ``twosided``
KIND_FIELDS = {
    KIND_DIFFUSE: ("reflectance",),
    KIND_CONDUCTOR: ("eta_c", "k_c", "specular_reflectance"),
    KIND_ROUGHCONDUCTOR: ("alpha", "eta_c", "k_c", "specular_reflectance"),
    KIND_DIELECTRIC: ("eta", "specular_reflectance",
                      "specular_transmittance"),
}
#: the roughness and relative IOR columns' defaults (``empty_table``,
#: :144-160)
DEFAULT_ALPHA, DEFAULT_ETA = 0.1, 1.5046


def check_kinds(kinds_present: Tuple[int, ...]) -> None:
    """Raise unless every kind of the scene is one the port has."""
    missing = [k for k in kinds_present if k not in KIND_FLAGS]
    if missing:
        raise NotImplementedError(
            f"BSDF kinds {missing}: the port has the diffuse, smooth "
            "conductor, rough conductor (GGX) and smooth dielectric BSDFs "
            "only")


def gather_params(table: Dict[str, torch.Tensor], idx: torch.Tensor,
                  fields=("twosided", "reflectance")):
    """Per-lane parameters: each field (B, ...) -> (N, ...) at idx; lanes
    with idx -1 (no surface) read slot 0."""
    safe = torch.clamp(idx, min=0)
    return {k: take_rows(table[k], safe) for k in fields}


def _kind_params(table, kinds_present, bsdf_idx):
    fields = ["kind", "twosided"]
    for kind in kinds_present:
        fields += [f for f in KIND_FIELDS[kind] if f not in fields]
    return gather_params(table, bsdf_idx, fields)


def _apply_textures(p, table, bsdf_idx, uv, textures, vcolor):
    """The textured slots' reflectance at the hit's ``uv``: the value of
    the slot's ``reflectance_tex``, the hit's vertex colour ``vcolor``
    for a ``mesh_attribute``; a slot without a texture keeps its row.
    ``textures``: the textures the table names, by index.  The reference
    also looks up ``diffuse_reflectance`` and ``blend_weight``, which only
    kinds the port does not have read."""
    if uv is None or not textures or "reflectance" not in p:
        return p
    idx = gather_params(table, bsdf_idx, ("reflectance_tex",))
    return {**p, "reflectance": tex_mod.eval_select(
        textures, idx["reflectance_tex"], uv, p["reflectance"], vcolor)}


def _diffuse_sample(p, wi, s1, s2):
    cos_i = wi[..., 2]
    wo = warp.square_to_cosine_hemisphere(s2)
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    bs = BSDFSample(
        wo=wo, pdf=pdf, eta=torch.ones_like(pdf),
        sampled_type=torch.full(pdf.shape, BSDFFlags.DiffuseReflection,
                                dtype=torch.int32, device=pdf.device),
        hf=torch.zeros_like(wo))
    ok = (cos_i > 0.0) & (pdf > 0.0)
    return bs, torch.where(ok[..., None], p["reflectance"], 0.0), ok


def _diffuse_eval_pdf(p, wi, wo):
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    ok = (cos_i > 0.0) & (cos_o > 0.0)
    value = p["reflectance"] * (math.pi ** -1) * cos_o[..., None]
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    return torch.where(ok[..., None], value, 0.0), torch.where(ok, pdf, 0.0)


def _conductor_sample(p, wi, s1, s2):
    """Smooth conductor (conductor.cpp): the mirror direction, a delta
    lobe of pdf 1 and weight R * F(cos_theta_i); the half vector is the
    normal."""
    cos_i = wi[..., 2]
    wo = m.reflect(wi)
    pdf = torch.ones_like(cos_i)
    f = m.fresnel_conductor(cos_i[..., None], p["eta_c"], p["k_c"])
    bs = BSDFSample(
        wo=wo, pdf=pdf, eta=torch.ones_like(pdf),
        sampled_type=torch.full(pdf.shape, BSDFFlags.DeltaReflection,
                                dtype=torch.int32, device=pdf.device),
        hf=torch.cat([torch.zeros_like(wo[..., :2]),
                      torch.ones_like(wo[..., 2:3])], dim=-1))
    ok = cos_i > 0.0
    weight = p["specular_reflectance"] * f
    return bs, torch.where(ok[..., None], weight, 0.0), ok


def _zero_eval_pdf(p, wi, wo):
    """eval_pdf of a delta lobe: no value, no density."""
    return (torch.zeros(wi.shape[:-1] + (3,), dtype=wi.dtype,
                        device=wi.device),
            torch.zeros(wi.shape[:-1], dtype=wi.dtype, device=wi.device))


def _roughconductor_sample(p, wi, s1, s2):
    """GGX visible-normal sampling (roughconductor.cpp:231-270): the
    weight F G1(wo, m); the half vector ``hf`` is the sampled m
    (roughconductor.cpp:255)."""
    cos_i = wi[..., 2]
    alpha = p["alpha"]
    mvec = warp.ggx_visible_normal_sample(wi, s2, alpha, alpha)
    wo = m.reflect_m(wi, mvec)
    pdf_m = warp.ggx_pdf_visible(wi, mvec, alpha, alpha)
    pdf = m.safe_div(pdf_m, 4.0 * torch.abs(m.dot(wo, mvec)))
    f = m.fresnel_conductor(m.dot(wi, mvec)[..., None], p["eta_c"], p["k_c"])
    g1_o = warp.ggx_smith_g1(wo, mvec, alpha, alpha)
    weight = p["specular_reflectance"] * f * g1_o[..., None]
    bs = BSDFSample(
        wo=wo, pdf=pdf, eta=torch.ones_like(pdf),
        sampled_type=torch.full(pdf.shape, BSDFFlags.GlossyReflection,
                                dtype=torch.int32, device=pdf.device),
        hf=mvec)
    ok = (cos_i > 0.0) & (wo[..., 2] > 0.0) & (pdf > 0.0)
    return bs, torch.where(ok[..., None], weight, 0.0), ok


def _roughconductor_eval_pdf(p, wi, wo):
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    alpha = p["alpha"]
    ok = (cos_i > 0.0) & (cos_o > 0.0)
    h = m.normalize(wi + wo)
    d = warp.ggx_ndf(h, alpha, alpha)
    g = warp.ggx_smith_g1(wi, h, alpha, alpha) * warp.ggx_smith_g1(
        wo, h, alpha, alpha)
    f = m.fresnel_conductor(m.dot(wi, h)[..., None], p["eta_c"], p["k_c"])
    value = (p["specular_reflectance"] * f
             * m.safe_div(d * g, 4.0 * cos_i)[..., None])
    pdf_m = warp.ggx_pdf_visible(wi, h, alpha, alpha)
    pdf = m.safe_div(pdf_m, 4.0 * torch.abs(m.dot(wo, h)))
    return torch.where(ok[..., None], value, 0.0), torch.where(ok, pdf, 0.0)


def _dielectric_sample(p, wi, s1, s2):
    """Smooth dielectric (dielectric.cpp): reflect with probability F,
    else refract; ``wi`` may come from below (the interior).  Radiance
    through the interface scales by eta_ti^2 (dielectric.cpp:391); the
    half vector is the normal."""
    cos_i = wi[..., 2]
    F, cos_t, eta_it, eta_ti = m.fresnel(cos_i, p["eta"])
    sel_r = s1 <= F
    normal = torch.cat([torch.zeros_like(wi[..., :2]),
                        torch.ones_like(wi[..., 2:3])], dim=-1)
    wo_t = m.refract(wi, normal, cos_t, eta_ti)
    wo = torch.where(sel_r[..., None], m.reflect(wi), wo_t)
    pdf = torch.where(sel_r, F, 1.0 - F)
    eta = torch.where(sel_r, 1.0, eta_it)
    w_t = p["specular_transmittance"] * (eta_ti ** 2)[..., None]
    weight = torch.where(sel_r[..., None], p["specular_reflectance"], w_t)
    sampled = torch.where(
        sel_r, torch.tensor(BSDFFlags.DeltaReflection, dtype=torch.int32,
                            device=wi.device),
        torch.tensor(BSDFFlags.DeltaTransmission, dtype=torch.int32,
                     device=wi.device))
    bs = BSDFSample(wo=wo, pdf=pdf, eta=eta, sampled_type=sampled,
                    hf=normal)
    ok = cos_i != 0.0
    return bs, torch.where(ok[..., None], weight, 0.0), ok


_SAMPLE_FNS = {KIND_DIFFUSE: _diffuse_sample,
               KIND_CONDUCTOR: _conductor_sample,
               KIND_ROUGHCONDUCTOR: _roughconductor_sample,
               KIND_DIELECTRIC: _dielectric_sample}
_EVAL_PDF_FNS = {KIND_DIFFUSE: _diffuse_eval_pdf,
                 KIND_CONDUCTOR: _zero_eval_pdf,
                 KIND_ROUGHCONDUCTOR: _roughconductor_eval_pdf,
                 KIND_DIELECTRIC: _zero_eval_pdf}


def _select_bs(mask, a: BSDFSample, b: BSDFSample) -> BSDFSample:
    mm = mask[..., None]
    return BSDFSample(
        wo=torch.where(mm, a.wo, b.wo), pdf=torch.where(mask, a.pdf, b.pdf),
        eta=torch.where(mask, a.eta, b.eta),
        sampled_type=torch.where(mask, a.sampled_type, b.sampled_type),
        hf=torch.where(mm, a.hf, b.hf))


def _apply_twosided_in(p, wi):
    """twosided wrapper (src/bsdfs/twosided.cpp): flip the frame when wi
    arrives from the back side."""
    flip = p["twosided"] & (wi[..., 2] < 0.0)
    return _flip_z(wi, flip), flip


def _flip_z(v, flip):
    flipped = torch.cat([v[..., :2], -v[..., 2:]], dim=-1)
    return torch.where(flip[..., None], flipped, v)


def sample(table, kinds_present: Tuple[int, ...], bsdf_idx, wi, s1, s2,
           active=None, uv=None, textures=(), vcolor=None):
    """BSDF::sample over the wavefront: (BSDFSample, weight (N,3), ok).
    ``uv``, ``textures``, ``vcolor``: the textured slots' lookup
    (``_apply_textures``)."""
    check_kinds(kinds_present)
    p = _apply_textures(_kind_params(table, kinds_present, bsdf_idx),
                        table, bsdf_idx, uv, textures, vcolor)
    wi_f, flip = _apply_twosided_in(p, wi)
    bs = w = ok = None
    for kind in kinds_present:
        bs_k, w_k, ok_k = _SAMPLE_FNS[kind](p, wi_f, s1, s2)
        is_k = p["kind"] == kind
        if bs is None:
            bs, w, ok = bs_k, w_k, ok_k & is_k
        else:
            bs = _select_bs(is_k, bs_k, bs)
            w = torch.where(is_k[..., None], w_k, w)
            ok = torch.where(is_k, ok_k, ok)
    bs = bs.replace(wo=_flip_z(bs.wo, flip), hf=_flip_z(bs.hf, flip))
    if active is not None:
        ok = ok & active
        w = torch.where(ok[..., None], w, 0.0)
    return bs, w, ok


def eval_pdf(table, kinds_present: Tuple[int, ...], bsdf_idx, wi, wo,
             active=None, uv=None, textures=(), vcolor=None):
    """BSDF::eval_pdf over the wavefront: (f * cos_theta_o (N,3), pdf)."""
    check_kinds(kinds_present)
    p = _apply_textures(_kind_params(table, kinds_present, bsdf_idx),
                        table, bsdf_idx, uv, textures, vcolor)
    wi_f, flip = _apply_twosided_in(p, wi)
    wo_f = _flip_z(wo, flip)
    val = torch.zeros_like(wi)
    pdf = torch.zeros_like(wi[..., 0])
    for kind in kinds_present:
        val_k, pdf_k = _EVAL_PDF_FNS[kind](p, wi_f, wo_f)
        is_k = p["kind"] == kind
        val = torch.where(is_k[..., None], val_k, val)
        pdf = torch.where(is_k, pdf_k, pdf)
    if active is not None:
        val = torch.where(active[..., None], val, 0.0)
        pdf = torch.where(active, pdf, 0.0)
    return val, pdf


def flags_of(table, bsdf_idx) -> torch.Tensor:
    """Per-lane BSDFFlags of the slot (slot 0 where idx is -1)."""
    return gather_params(table, bsdf_idx, ("flags",))["flags"]
