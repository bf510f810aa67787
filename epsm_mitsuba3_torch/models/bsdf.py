"""BSDF models (counterpart of ``models/bsdf.py``): every scalar BSDF of
the reference but the polarization elements -- diffuse, the smooth and
rough conductors, the smooth, thin and rough dielectrics, the smooth and
rough plastics (``pplastic`` is the rough one), ``null``, ``principled``,
``principledthin``, ``blendbsdf`` (a ``mask`` loads as a blend of
``null`` and its material) and ``measured`` (an RGL table baked at load,
``models/measured.py``) -- with the two-sided wrapper; each rough kind
takes GGX or Beckmann.  ``register_bsdf`` adds a kind written by the
user in torch.

All BSDFs of a scene live in one table of per-slot parameters.  ``sample``
and ``eval_pdf`` check the kinds present in the scene, evaluate each of
them on every lane and select per lane by the slot's kind, as the
reference does; a kind the port does not have raises.  Each evaluation
gathers only the columns its scene's kinds read (``KIND_FIELDS``), runs
a function that several kinds share once for all of them (``pplastic``
is ``roughplastic``; the delta lobes share one ``eval_pdf``), and runs
the Beckmann branch only where the kinds carry
``KIND_SENTINEL_BECKMANN``: a scene computes nothing for kinds it does
not have.

A slot's ``reflectance`` (and its ``diffuse_reflectance``) may come from
a texture (``reflectance_tex``, -1 for none), a blend's weight from
``blend_weight_tex``: ``sample`` and ``eval_pdf`` take the hit's ``uv``,
the textures the table names and the hit's vertex colour ``vcolor``, and
evaluate the textures per lane (``_apply_textures``, :1146-1171).  The
``normal_tex`` column (a normal or bump map) is read where the shading
frame is built (``ops/intersect.py``).

Conventions (bsdf.h): directions are in the local shading frame with the
normal = +Z; ``wi`` points away from the surface; ``sample`` returns
``weight = f * cos_theta_o / pdf``; ``eval_pdf`` returns ``f * cos_theta_o``.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

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


#: kind ids in the reference's numbering (``KIND_*``, :56-80); the
#: reference's 13-16 (the polarization elements and
#: ``measured_polarized``) are not ported
KIND_DIFFUSE = 0
KIND_CONDUCTOR = 1
KIND_ROUGHCONDUCTOR = 2
KIND_DIELECTRIC = 3
KIND_THINDIELECTRIC = 4
KIND_ROUGHDIELECTRIC = 5
KIND_PLASTIC = 6
KIND_ROUGHPLASTIC = 7
KIND_NULL = 8
KIND_PRINCIPLED = 9
KIND_BLEND = 10
KIND_PPLASTIC = 11
KIND_MEASURED = 12
KIND_PRINCIPLEDTHIN = 17
#: appended to a scene's kinds where a slot takes the Beckmann
#: distribution: the Beckmann branch is evaluated only then
KIND_SENTINEL_BECKMANN = 99
KIND_NAMES = {"diffuse": KIND_DIFFUSE, "conductor": KIND_CONDUCTOR,
              "roughconductor": KIND_ROUGHCONDUCTOR,
              "dielectric": KIND_DIELECTRIC,
              "thindielectric": KIND_THINDIELECTRIC,
              "roughdielectric": KIND_ROUGHDIELECTRIC,
              "plastic": KIND_PLASTIC, "roughplastic": KIND_ROUGHPLASTIC,
              "null": KIND_NULL, "principled": KIND_PRINCIPLED,
              "principledthin": KIND_PRINCIPLEDTHIN,
              "blendbsdf": KIND_BLEND, "pplastic": KIND_PPLASTIC,
              "measured": KIND_MEASURED}
_F = BSDFFlags
KIND_FLAGS = {
    KIND_DIFFUSE: _F.DiffuseReflection | _F.FrontSide,
    KIND_CONDUCTOR: _F.DeltaReflection | _F.FrontSide,
    KIND_ROUGHCONDUCTOR: _F.GlossyReflection | _F.FrontSide,
    KIND_DIELECTRIC: (_F.DeltaReflection | _F.DeltaTransmission
                      | _F.FrontSide | _F.BackSide | _F.NonSymmetric),
    KIND_THINDIELECTRIC: (_F.DeltaReflection | _F.Null | _F.FrontSide
                          | _F.BackSide),
    KIND_ROUGHDIELECTRIC: (_F.GlossyReflection | _F.GlossyTransmission
                           | _F.FrontSide | _F.BackSide | _F.NonSymmetric),
    KIND_PLASTIC: _F.DiffuseReflection | _F.DeltaReflection | _F.FrontSide,
    KIND_ROUGHPLASTIC: (_F.DiffuseReflection | _F.GlossyReflection
                        | _F.FrontSide),
    KIND_NULL: _F.Null | _F.FrontSide | _F.BackSide,
    KIND_PRINCIPLED: (_F.DiffuseReflection | _F.GlossyReflection
                      | _F.FrontSide),
    KIND_BLEND: _F.DiffuseReflection | _F.GlossyReflection | _F.FrontSide,
    KIND_PPLASTIC: (_F.DiffuseReflection | _F.GlossyReflection
                    | _F.FrontSide),
    KIND_PRINCIPLEDTHIN: (_F.GlossyReflection | _F.GlossyTransmission
                          | _F.DiffuseReflection | _F.DiffuseTransmission
                          | _F.FrontSide | _F.BackSide),
    KIND_MEASURED: _F.GlossyReflection | _F.FrontSide,
}
_PLASTIC_FIELDS = ("eta", "diffuse_reflectance", "specular_reflectance")
#: the table columns each kind reads, beside ``kind`` and ``twosided``;
#: the sentinel's is the slot's choice of distribution
KIND_FIELDS = {
    KIND_DIFFUSE: ("reflectance",),
    KIND_CONDUCTOR: ("eta_c", "k_c", "specular_reflectance"),
    KIND_ROUGHCONDUCTOR: ("alpha", "eta_c", "k_c", "specular_reflectance"),
    KIND_DIELECTRIC: ("eta", "specular_reflectance",
                      "specular_transmittance"),
    KIND_THINDIELECTRIC: ("eta", "specular_reflectance",
                          "specular_transmittance"),
    KIND_ROUGHDIELECTRIC: ("alpha", "eta", "specular_reflectance",
                           "specular_transmittance"),
    KIND_PLASTIC: _PLASTIC_FIELDS,
    KIND_ROUGHPLASTIC: ("alpha",) + _PLASTIC_FIELDS,
    KIND_NULL: (),
    KIND_PRINCIPLED: ("reflectance", "alpha", "metallic", "spec_tint",
                      "sheen", "sheen_tint", "clearcoat", "clearcoat_gloss",
                      "specular"),
    KIND_BLEND: ("blend_a", "blend_b", "blend_weight"),
    KIND_PPLASTIC: ("alpha",) + _PLASTIC_FIELDS,
    KIND_PRINCIPLEDTHIN: ("reflectance", "alpha", "eta", "spec_trans",
                          "diff_trans", "flatness", "spec_tint", "sheen",
                          "sheen_tint"),
    KIND_MEASURED: ("alpha", "reflectance_tex"),
    KIND_SENTINEL_BECKMANN: ("beckmann",),
}
#: the float columns of the table and their defaults (``empty_table``,
#: :144-186), beside the colours: the roughness, the relative IOR, the
#: principled and principledthin parameters and the blend weight
DEFAULT_ALPHA, DEFAULT_ETA = 0.1, 1.5046
SCALAR_DEFAULTS = {"alpha": DEFAULT_ALPHA, "eta": DEFAULT_ETA,
                   "metallic": 0.0, "spec_tint": 0.0, "sheen": 0.0,
                   "sheen_tint": 0.0, "clearcoat": 0.0,
                   "clearcoat_gloss": 1.0, "specular": 0.5,
                   "spec_trans": 0.0, "diff_trans": 0.0, "flatness": 0.0,
                   "blend_weight": 0.5}


#: the columns a kind of ``register_bsdf`` is handed: every colour and
#: scalar column of the table
_CUSTOM_FIELDS = ("reflectance", "specular_reflectance",
                  "specular_transmittance", "diffuse_reflectance", "eta_c",
                  "k_c") + tuple(k for k in SCALAR_DEFAULTS
                                 if k != "blend_weight")


def check_kinds(kinds_present: Tuple[int, ...]) -> None:
    """Raise unless every kind of the scene is one the port has."""
    missing = [k for k in kinds_present if k not in KIND_FIELDS]
    if missing:
        raise NotImplementedError(
            f"BSDF kinds {missing}: the port has every scalar BSDF but "
            "polarizer, retarder, circular and measured_polarized")


def gather_params(table: Dict[str, torch.Tensor], idx: torch.Tensor,
                  fields=("twosided", "reflectance")):
    """Per-lane parameters: each field (B, ...) -> (N, ...) at idx; lanes
    with idx -1 (no surface) read slot 0."""
    safe = torch.clamp(idx, min=0)
    return {k: take_rows(table[k], safe) for k in fields}


def _kind_params(table, kinds_present, bsdf_idx, uv, textures, vcolor):
    """The per-lane columns the scene's kinds read at ``bsdf_idx``, the
    textured ones looked up at the hit (``_apply_textures``)."""
    fields = ["kind", "twosided"]
    for kind in kinds_present:
        fields += [f for f in KIND_FIELDS[kind] if f not in fields]
    return _apply_textures(gather_params(table, bsdf_idx, fields), table,
                           bsdf_idx, uv, textures, vcolor)


def _apply_textures(p, table, bsdf_idx, uv, textures, vcolor):
    """The textured columns at the hit's ``uv`` (``_apply_textures``,
    :1146-1171), where ``p`` has them; a slot without a texture keeps its
    row.  ``textures``: the textures the table names, by index; the
    slots' texture columns are gathered at ``bsdf_idx``.

    - ``reflectance``: the slot's ``reflectance_tex``, the hit's vertex
      colour ``vcolor`` for a ``mesh_attribute``;
    - ``diffuse_reflectance``: the same ``reflectance_tex``; a
      ``mesh_attribute`` there reads the reference's placeholder texel, 0;
    - ``blend_weight``: the mean of the RGB of ``blend_weight_tex``
      (a mask's opacity), a ``mesh_attribute`` 0 as above."""
    tex_fields = tuple(dict.fromkeys(
        t for f, t in (("reflectance", "reflectance_tex"),
                       ("diffuse_reflectance", "reflectance_tex"),
                       ("blend_weight", "blend_weight_tex")) if f in p))
    if uv is None or not textures or not tex_fields:
        return p
    p = {**p, **gather_params(table, bsdf_idx, tex_fields)}
    if "reflectance" in p:
        p["reflectance"] = tex_mod.eval_select(
            textures, p["reflectance_tex"], uv, p["reflectance"], vcolor)
    if "diffuse_reflectance" not in p and "blend_weight" not in p:
        return p
    placeholder = torch.zeros(uv.shape[:-1] + (3,), dtype=uv.dtype,
                              device=uv.device)
    if "diffuse_reflectance" in p:
        p["diffuse_reflectance"] = tex_mod.eval_select(
            textures, p["reflectance_tex"], uv, p["diffuse_reflectance"],
            placeholder)
    if "blend_weight" in p:
        w = p["blend_weight"][..., None].expand(p["blend_weight"].shape
                                                + (3,))
        p["blend_weight"] = torch.mean(tex_mod.eval_select(
            textures, p["blend_weight_tex"], uv, w, placeholder), dim=-1)
    return p


def _z_axis(like: torch.Tensor) -> torch.Tensor:
    """(0, 0, 1) on every lane of ``like`` (..., 3)."""
    return torch.cat([torch.zeros_like(like[..., :2]),
                      torch.ones_like(like[..., 2:3])], dim=-1)


def _types(sel, a: int, b: int) -> torch.Tensor:
    """Per-lane sampled type: ``a`` where ``sel``, else ``b``."""
    return torch.full(sel.shape, b, dtype=torch.int32,
                      device=sel.device).masked_fill(sel, a)


# ---------------------------------------------------------------------------
# the microfacet distribution of a slot (:196-229): GGX, or Beckmann where
# the slot's ``beckmann`` column is set; ``p`` holds that column only when
# the scene's kinds carry KIND_SENTINEL_BECKMANN
# ---------------------------------------------------------------------------

def _mf_normal_sample(p, wi, s2):
    alpha = p["alpha"]
    mvec = warp.ggx_visible_normal_sample(wi, s2, alpha, alpha)
    if "beckmann" in p:
        mb = warp.beckmann_visible_normal_sample(wi, s2, alpha, alpha)
        mvec = torch.where(p["beckmann"][..., None], mb, mvec)
    return mvec


def _mf_pdf_visible(p, wi, mvec):
    alpha = p["alpha"]
    pdf = warp.ggx_pdf_visible(wi, mvec, alpha, alpha)
    if "beckmann" in p:
        pb = warp.beckmann_pdf_visible(wi, mvec, alpha, alpha)
        pdf = torch.where(p["beckmann"], pb, pdf)
    return pdf


def _mf_ndf(p, mvec):
    alpha = p["alpha"]
    d = warp.ggx_ndf(mvec, alpha, alpha)
    if "beckmann" in p:
        d = torch.where(p["beckmann"], warp.beckmann_ndf(mvec, alpha, alpha),
                        d)
    return d


def _mf_g1(p, v, mvec):
    alpha = p["alpha"]
    g = warp.ggx_smith_g1(v, mvec, alpha, alpha)
    if "beckmann" in p:
        g = torch.where(p["beckmann"],
                        warp.beckmann_smith_g1(v, mvec, alpha, alpha), g)
    return g


# ---------------------------------------------------------------------------
# the kinds: p holds the per-lane columns, wi / wo are in the local frame;
# ``*_sample`` returns (BSDFSample, weight, ok), ``*_eval_pdf`` (f cos,
# pdf); the caller masks ``active``
# ---------------------------------------------------------------------------

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
        hf=_z_axis(wo))
    ok = cos_i > 0.0
    weight = p["specular_reflectance"] * f
    return bs, torch.where(ok[..., None], weight, 0.0), ok


def _zero_eval_pdf(p, wi, wo):
    """eval_pdf of a delta lobe: no value, no density."""
    return (torch.zeros(wi.shape[:-1] + (3,), dtype=wi.dtype,
                        device=wi.device),
            torch.zeros(wi.shape[:-1], dtype=wi.dtype, device=wi.device))


def _roughconductor_sample(p, wi, s1, s2):
    """Visible-normal sampling (roughconductor.cpp:231-270): the weight
    F G1(wo, m); the half vector ``hf`` is the sampled m
    (roughconductor.cpp:255)."""
    cos_i = wi[..., 2]
    mvec = _mf_normal_sample(p, wi, s2)
    wo = m.reflect_m(wi, mvec)
    pdf_m = _mf_pdf_visible(p, wi, mvec)
    pdf = m.safe_div(pdf_m, 4.0 * torch.abs(m.dot(wo, mvec)))
    f = m.fresnel_conductor(m.dot(wi, mvec)[..., None], p["eta_c"], p["k_c"])
    weight = p["specular_reflectance"] * f * _mf_g1(p, wo, mvec)[..., None]
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
    ok = (cos_i > 0.0) & (cos_o > 0.0)
    h = m.normalize(wi + wo)
    d = _mf_ndf(p, h)
    g = _mf_g1(p, wi, h) * _mf_g1(p, wo, h)
    f = m.fresnel_conductor(m.dot(wi, h)[..., None], p["eta_c"], p["k_c"])
    value = (p["specular_reflectance"] * f
             * m.safe_div(d * g, 4.0 * cos_i)[..., None])
    pdf = m.safe_div(_mf_pdf_visible(p, wi, h),
                     4.0 * torch.abs(m.dot(wo, h)))
    return torch.where(ok[..., None], value, 0.0), torch.where(ok, pdf, 0.0)


def _dielectric_sample(p, wi, s1, s2):
    """Smooth dielectric (dielectric.cpp): reflect with probability F,
    else refract; ``wi`` may come from below (the interior).  Radiance
    through the interface scales by eta_ti^2 (dielectric.cpp:391); the
    half vector is the normal."""
    cos_i = wi[..., 2]
    F, cos_t, eta_it, eta_ti = m.fresnel(cos_i, p["eta"])
    sel_r = s1 <= F
    normal = _z_axis(wi)
    wo_t = m.refract(wi, normal, cos_t, eta_ti)
    wo = torch.where(sel_r[..., None], m.reflect(wi), wo_t)
    pdf = torch.where(sel_r, F, 1.0 - F)
    eta = torch.where(sel_r, 1.0, eta_it)
    w_t = p["specular_transmittance"] * (eta_ti ** 2)[..., None]
    weight = torch.where(sel_r[..., None], p["specular_reflectance"], w_t)
    bs = BSDFSample(wo=wo, pdf=pdf, eta=eta,
                    sampled_type=_types(sel_r, BSDFFlags.DeltaReflection,
                                        BSDFFlags.DeltaTransmission),
                    hf=normal)
    ok = cos_i != 0.0
    return bs, torch.where(ok[..., None], weight, 0.0), ok


def _thindielectric_sample(p, wi, s1, s2):
    """Thin dielectric (thindielectric.cpp, :386-407): reflect with the
    internal reflections' F' = 2F / (1 + F), else pass straight through
    (sampled type ``Null``)."""
    cos_i = wi[..., 2]
    F = m.fresnel(torch.abs(cos_i), p["eta"])[0]
    F = torch.where(F < 1.0, 2.0 * F / (1.0 + F), 1.0)
    sel_r = s1 <= F
    wo = torch.where(sel_r[..., None], m.reflect(wi), -wi)
    pdf = torch.where(sel_r, F, 1.0 - F)
    weight = torch.where(sel_r[..., None], p["specular_reflectance"],
                         p["specular_transmittance"])
    bs = BSDFSample(wo=wo, pdf=pdf, eta=torch.ones_like(pdf),
                    sampled_type=_types(sel_r, BSDFFlags.DeltaReflection,
                                        BSDFFlags.Null),
                    hf=_z_axis(wi))
    ok = cos_i != 0.0
    return bs, torch.where(ok[..., None], weight, 0.0), ok


def _flip_to(v, up):
    """``v`` where ``up``, else -v (``up`` per lane)."""
    return torch.where(up[..., None], v, -v)


def _roughdielectric_sample(p, wi, s1, s2):
    """Rough dielectric (roughdielectric.cpp, :415-456): a microfacet
    normal sampled on the side of ``wi``, then reflection with
    probability F(wi.m), else refraction through m."""
    cos_i = wi[..., 2]
    up = cos_i >= 0.0
    wi_flip = _flip_to(wi, up)
    mvec = _flip_to(_mf_normal_sample(p, wi_flip, s2), up)
    m_up = _flip_to(mvec, up)
    pdf_m = _mf_pdf_visible(p, wi_flip, m_up)
    F, cos_t, eta_it, eta_ti = m.fresnel(m.dot(wi, mvec), p["eta"])
    sel_r = s1 <= F
    wo = torch.where(sel_r[..., None], m.reflect_m(wi, mvec),
                     m.refract(wi, mvec, cos_t, eta_ti))
    eta = torch.where(sel_r, 1.0, eta_it)
    dwh_dwo_r = m.safe_div(torch.ones_like(cos_i),
                           4.0 * torch.abs(m.dot(wo, mvec)))
    sqrt_denom = m.dot(wi, mvec) + eta_it * m.dot(wo, mvec)
    dwh_dwo_t = m.safe_div((eta_it ** 2) * torch.abs(m.dot(wo, mvec)),
                           sqrt_denom ** 2)
    pdf = (pdf_m * torch.where(sel_r, F, 1.0 - F)
           * torch.where(sel_r, dwh_dwo_r, dwh_dwo_t))
    wo_flip = torch.where(sel_r[..., None], _flip_to(wo, up),
                          _flip_to(wo, ~up))
    g1_o = _mf_g1(p, wo_flip, m_up)
    w_t = p["specular_transmittance"] * (eta_ti ** 2)[..., None]
    weight = (torch.where(sel_r[..., None], p["specular_reflectance"], w_t)
              * g1_o[..., None])
    bs = BSDFSample(wo=wo, pdf=pdf, eta=eta,
                    sampled_type=_types(sel_r, BSDFFlags.GlossyReflection,
                                        BSDFFlags.GlossyTransmission),
                    hf=mvec)
    reflect_side = cos_i * wo[..., 2] > 0.0
    ok = (cos_i != 0.0) & (pdf > 0.0) & (sel_r == reflect_side)
    return bs, torch.where(ok[..., None], weight, 0.0), ok


def _roughdielectric_eval_pdf(p, wi, wo):
    """roughdielectric.cpp eval / pdf (:459-503): the generalized half
    vector, oriented up; radiance through the interface scales by
    eta_ti^2."""
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    reflect = cos_i * cos_o > 0.0
    eta_v = torch.where(cos_i > 0.0, p["eta"], 1.0 / p["eta"])
    h = m.normalize(wi + wo * torch.where(reflect, 1.0, eta_v)[..., None])
    h = h * torch.sign(h[..., 2:3])
    d = _mf_ndf(p, h)
    up_i, up_o = cos_i >= 0.0, cos_o >= 0.0
    h_i = _flip_to(h, up_i)
    g = (_mf_g1(p, _flip_to(wi, up_i), h_i)
         * _mf_g1(p, _flip_to(wo, up_o), _flip_to(h, up_o)))
    F, _, eta_it, eta_ti = m.fresnel(m.dot(wi, h), p["eta"])
    val_r = m.safe_div(F * d * g, 4.0 * torch.abs(cos_i))
    sqrt_denom = m.dot(wi, h) + eta_it * m.dot(wo, h)
    val_t = ((1.0 - F) * d * g
             * torch.abs(m.safe_div(m.dot(wi, h) * m.dot(wo, h),
                                    torch.abs(cos_i) * sqrt_denom ** 2)
                         * torch.sign(cos_i))
             * (eta_ti ** 2))
    value = torch.where(
        reflect[..., None], p["specular_reflectance"] * val_r[..., None],
        p["specular_transmittance"] * torch.abs(val_t)[..., None])
    pdf_m = _mf_pdf_visible(p, _flip_to(wi, up_i), h_i)
    dwh_dwo = torch.where(
        reflect,
        m.safe_div(torch.ones_like(cos_i), 4.0 * torch.abs(m.dot(wo, h))),
        m.safe_div((eta_it ** 2) * torch.abs(m.dot(wo, h)),
                   sqrt_denom ** 2))
    pdf = pdf_m * torch.where(reflect, F, 1.0 - F) * dwh_dwo
    ok = (cos_i != 0.0) & (d > 0.0)
    return torch.where(ok[..., None], value, 0.0), torch.where(ok, pdf, 0.0)


def _plastic_sample(p, wi, s1, s2):
    """Smooth plastic (plastic.cpp, :506-533): the specular delta lobe
    with probability F(cos_theta_i), as the reference chooses, else the
    cosine-sampled substrate through Fresnel transmission in and out."""
    cos_i = wi[..., 2]
    F_i = m.fresnel(cos_i, p["eta"])[0]
    sel_s = s1 < F_i
    wo_d = warp.square_to_cosine_hemisphere(s2)
    wo = torch.where(sel_s[..., None], m.reflect(wi), wo_d)
    pdf_d = warp.square_to_cosine_hemisphere_pdf(wo_d) * (1.0 - F_i)
    pdf = torch.where(sel_s, F_i, pdf_d)
    F_o = m.fresnel(wo[..., 2], p["eta"])[0]
    diff = (p["diffuse_reflectance"] * (1.0 - F_i[..., None])
            * (1.0 - F_o[..., None]))
    weight = torch.where(
        sel_s[..., None], p["specular_reflectance"],
        diff / torch.clamp(1.0 - F_i, min=1e-6)[..., None])
    bs = BSDFSample(wo=wo, pdf=pdf, eta=torch.ones_like(pdf),
                    sampled_type=_types(sel_s, BSDFFlags.DeltaReflection,
                                        BSDFFlags.DiffuseReflection),
                    hf=_z_axis(wi))
    ok = (cos_i > 0.0) & (wo[..., 2] > 0.0)
    return bs, torch.where(ok[..., None], weight, 0.0), ok


def _plastic_diffuse(p, cos_i, cos_o):
    """The substrate's f cos of the plastics: R / pi cos_o (1 - F_i)
    (1 - F_o), and F_i."""
    F_i = m.fresnel(cos_i, p["eta"])[0]
    F_o = m.fresnel(cos_o, p["eta"])[0]
    value = (p["diffuse_reflectance"] * (math.pi ** -1)
             * (cos_o * (1.0 - F_i) * (1.0 - F_o))[..., None])
    return value, F_i


def _plastic_eval_pdf(p, wi, wo):
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    ok = (cos_i > 0.0) & (cos_o > 0.0)
    value, F_i = _plastic_diffuse(p, cos_i, cos_o)
    pdf = warp.square_to_cosine_hemisphere_pdf(wo) * (1.0 - F_i)
    return torch.where(ok[..., None], value, 0.0), torch.where(ok, pdf, 0.0)


def _roughplastic_sample(p, wi, s1, s2):
    """Rough plastic (roughplastic.cpp, :551-576): the microfacet lobe
    with probability F(cos_theta_i), else the cosine lobe; the weight is
    eval / pdf of the mixture.  ``pplastic`` is the same BSDF."""
    cos_i = wi[..., 2]
    sel_s = s1 < m.fresnel(cos_i, p["eta"])[0]
    mvec = _mf_normal_sample(p, wi, s2)
    wo = torch.where(sel_s[..., None], m.reflect_m(wi, mvec),
                     warp.square_to_cosine_hemisphere(s2))
    value, pdf = _roughplastic_eval_pdf(p, wi, wo)
    weight = value / torch.clamp(pdf, min=1e-12)[..., None]
    bs = BSDFSample(wo=wo, pdf=pdf, eta=torch.ones_like(pdf),
                    sampled_type=_types(sel_s, BSDFFlags.GlossyReflection,
                                        BSDFFlags.DiffuseReflection),
                    hf=torch.where(sel_s[..., None], mvec, _z_axis(wi)))
    ok = (cos_i > 0.0) & (wo[..., 2] > 0.0) & (pdf > 0.0)
    return bs, torch.where(ok[..., None], weight, 0.0), ok


def _roughplastic_eval_pdf(p, wi, wo):
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    ok = (cos_i > 0.0) & (cos_o > 0.0)
    h = m.normalize(wi + wo)
    d = _mf_ndf(p, h)
    g = _mf_g1(p, wi, h) * _mf_g1(p, wo, h)
    F_h = m.fresnel(m.dot(wi, h), p["eta"])[0]
    spec = (p["specular_reflectance"]
            * m.safe_div(F_h * d * g, 4.0 * cos_i)[..., None])
    diff, F_i = _plastic_diffuse(p, cos_i, cos_o)
    pdf_spec = m.safe_div(_mf_pdf_visible(p, wi, h),
                          4.0 * torch.abs(m.dot(wo, h)))
    pdf = (F_i * pdf_spec
           + (1.0 - F_i) * warp.square_to_cosine_hemisphere_pdf(wo))
    return (torch.where(ok[..., None], spec + diff, 0.0),
            torch.where(ok, pdf, 0.0))


def _schlick(f0, cos_t):
    m_ = torch.clamp(1.0 - cos_t, 0.0, 1.0)
    return f0 + (1.0 - f0) * (m_ ** 2) * (m_ ** 2) * m_


def _gtr1_ndf(cos_h, alpha):
    """The clearcoat's GTR1 distribution (principledhelpers.h, :608-613),
    its denominator held away from 0 at 1e-12."""
    a2 = alpha * alpha
    denom = (math.pi * torch.log(torch.clamp(a2, min=1e-7))
             * (1.0 + (a2 - 1.0) * cos_h * cos_h))
    return (a2 - 1.0) / torch.where(torch.abs(denom) > 1e-12, denom, 1e-12)


def _tint(base):
    """The base colour over its luminance, 1 where that is 0."""
    lum = (base[..., 0] * 0.2126 + base[..., 1] * 0.7152
           + base[..., 2] * 0.0722)[..., None]
    return torch.where(lum > 0.0, base / torch.clamp(lum, min=1e-6), 1.0)


def _principled_eval_pdf(p, wi, wo):
    """The Disney principled BRDF (principled.cpp eval / pdf, :616-681):
    Burley diffuse with retro-reflection, sheen, the metallic / specular
    GGX lobe and the GTR1 clearcoat; the pdf is the cosine and GGX
    visible-normal mixture."""
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    ok = (cos_i > 0.0) & (cos_o > 0.0)
    base = p["reflectance"]
    rough = torch.clamp(p["alpha"], 0.02, 1.0)
    metallic = p["metallic"]
    h = m.normalize(wi + wo)
    cos_d = m.dot(wi, h)

    fl = (1.0 - cos_o) ** 5
    fv = (1.0 - cos_i) ** 5
    rr = 2.0 * rough * cos_d * cos_d
    f_lambert = (1.0 - 0.5 * fl) * (1.0 - 0.5 * fv)
    f_retro = rr * (fl + fv + fl * fv * (rr - 1.0))
    diffuse = base * ((1.0 / math.pi) * (f_lambert + f_retro)
                      * cos_o)[..., None]

    tint = _tint(base)
    sheen_col = ((1.0 - p["sheen_tint"][..., None])
                 + p["sheen_tint"][..., None] * tint)
    f_sheen = (p["sheen"][..., None] * sheen_col
               * ((1.0 - cos_d) ** 5 * cos_o)[..., None])

    alpha_g = torch.clamp(rough * rough, min=1e-3)
    d = warp.ggx_ndf(h, alpha_g, alpha_g)
    g = (warp.ggx_smith_g1(wi, h, alpha_g, alpha_g)
         * warp.ggx_smith_g1(wo, h, alpha_g, alpha_g))
    f0_d = 0.08 * p["specular"][..., None] * (
        (1.0 - p["spec_tint"][..., None]) + p["spec_tint"][..., None] * tint)
    f0 = f0_d * (1.0 - metallic[..., None]) + base * metallic[..., None]
    spec = (_schlick(f0, cos_d[..., None])
            * m.safe_div(d * g, 4.0 * cos_i)[..., None])

    alpha_cc = ((1.0 - p["clearcoat_gloss"]) * 0.1
                + p["clearcoat_gloss"] * 0.001)
    d_cc = _gtr1_ndf(h[..., 2], alpha_cc)
    g_cc = (warp.ggx_smith_g1(wi, h, 0.25, 0.25)
            * warp.ggx_smith_g1(wo, h, 0.25, 0.25))
    f_cc = 0.04 + 0.96 * (1.0 - cos_d) ** 5
    cc = m.safe_div(0.25 * p["clearcoat"] * d_cc * g_cc * f_cc, 4.0 * cos_i)

    value = ((diffuse + f_sheen) * (1.0 - metallic[..., None])
             + spec + cc[..., None])
    w_spec = torch.clamp(metallic + 0.5 * (1.0 - metallic), 0.1, 0.9)
    pdf_spec = m.safe_div(warp.ggx_pdf_visible(wi, h, alpha_g, alpha_g),
                          4.0 * torch.abs(cos_d))
    pdf = ((1.0 - w_spec) * warp.square_to_cosine_hemisphere_pdf(wo)
           + w_spec * pdf_spec)
    return torch.where(ok[..., None], value, 0.0), torch.where(ok, pdf, 0.0)


def _principled_sample(p, wi, s1, s2):
    """principled.cpp sample (:684-709): the GGX lobe at
    max(clip(alpha, 0.02, 1)^2, 1e-3) with probability clip(metallic +
    (1 - metallic) / 2, 0.1, 0.9), else the cosine lobe; weight = eval /
    pdf."""
    cos_i = wi[..., 2]
    rough = torch.clamp(p["alpha"], 0.02, 1.0)
    alpha_g = torch.clamp(rough * rough, min=1e-3)
    metallic = p["metallic"]
    w_spec = torch.clamp(metallic + 0.5 * (1.0 - metallic), 0.1, 0.9)
    sel_spec = s1 < w_spec
    mvec = warp.ggx_visible_normal_sample(wi, s2, alpha_g, alpha_g)
    wo = torch.where(sel_spec[..., None], m.reflect_m(wi, mvec),
                     warp.square_to_cosine_hemisphere(s2))
    value, pdf = _principled_eval_pdf(p, wi, wo)
    weight = value / torch.clamp(pdf, min=1e-12)[..., None]
    bs = BSDFSample(wo=wo, pdf=pdf, eta=torch.ones_like(pdf),
                    sampled_type=_types(sel_spec, BSDFFlags.GlossyReflection,
                                        BSDFFlags.DiffuseReflection),
                    hf=torch.where(sel_spec[..., None], mvec, _z_axis(wi)))
    ok = (cos_i > 0.0) & (wo[..., 2] > 0.0) & (pdf > 0.0)
    return bs, torch.where(ok[..., None], weight, 0.0), ok


def _thin_probs(p):
    """principledthin's lobe probabilities (principledthin.cpp:291-310):
    specular reflection and transmission, diffuse reflection and
    transmission, normalized."""
    st = torch.clamp(p["spec_trans"], 0.0, 1.0)
    dt = torch.clamp(p["diff_trans"], 0.0, 2.0) / 2.0
    pr = torch.stack([st * 0.5, st * 0.5, (1.0 - st) * (1.0 - dt),
                      (1.0 - st) * dt], -1)
    return pr / torch.clamp(torch.sum(pr, -1, keepdim=True), min=1e-12)


def _thin_alphas(p):
    """principledthin's roughness, the reflection lobe's GGX alpha and the
    transmission lobe's, scaled by Burley's (0.65 eta - 0.35)."""
    rough = torch.clamp(p["alpha"], 0.02, 1.0)
    eta_t = torch.clamp(p["eta"], min=1.01)
    rough_sc = torch.clamp((0.65 * eta_t - 0.35) * rough, 0.02, 1.0)
    return (rough, eta_t, torch.clamp(rough * rough, min=1e-4),
            torch.clamp(rough_sc * rough_sc, min=1e-4))


def _principledthin_eval_pdf(p, wi, wo):
    """The thin-surface Disney BSDF (principledthin.cpp eval / pdf,
    :723-829): a two-sided model whose transmission lobes mirror the
    reflection lobes to the other side; the specular reflection and
    transmission GGX lobes, Burley diffuse with the flatness lerp and
    sheen, Lambertian transmission, and the normalized lobe mixture's
    pdf."""
    cos_i0 = wi[..., 2]
    act = torch.abs(cos_i0) > 1e-7
    sgn = torch.where(cos_i0 >= 0.0, 1.0, -1.0)[..., None]
    wi_f = wi * sgn
    wo_t = wo * sgn
    cos_i = torch.abs(cos_i0)
    cos_o = wo_t[..., 2]
    reflect = cos_o > 0.0
    refract = cos_o < 0.0

    base = p["reflectance"]
    rough, eta_t, alpha_g, alpha_sc = _thin_alphas(p)
    st = torch.clamp(p["spec_trans"], 0.0, 1.0)
    dt = torch.clamp(p["diff_trans"], 0.0, 2.0) / 2.0
    flat = p["flatness"]

    wo_r = torch.cat([wo_t[..., :2], torch.abs(wo_t[..., 2:3])], -1)
    h = m.normalize(wi_f + wo_r)
    compat_r = (m.dot(wi_f, h) > 0.0) & (m.dot(wo_t, h) > 0.0)
    compat_t = (m.dot(wi_f, h) > 0.0) & (m.dot(wo_t, -h) > 0.0)

    cos_hi = m.dot(wi_f, h)
    F_diel = m.fresnel(cos_hi, eta_t)[0]
    c_tint = _tint(base)
    r0 = ((eta_t - 1.0) / (eta_t + 1.0)) ** 2
    F_schlick = (c_tint * r0[..., None] + (1.0 - c_tint * r0[..., None])
                 * (1.0 - torch.abs(cos_hi[..., None])) ** 5)
    F_thin = ((1.0 - p["spec_tint"][..., None]) * F_diel[..., None]
              + p["spec_tint"][..., None] * F_schlick)

    value = torch.zeros_like(base)
    d_r = warp.ggx_ndf(h, alpha_g, alpha_g)
    g_r = (warp.ggx_smith_g1(wi_f, h, alpha_g, alpha_g)
           * warp.ggx_smith_g1(wo_r, h, alpha_g, alpha_g))
    v_sr = st[..., None] * F_thin * m.safe_div(d_r * g_r,
                                               4.0 * cos_i)[..., None]
    value = value + torch.where((reflect & compat_r)[..., None], v_sr, 0.0)
    d_t = warp.ggx_ndf(h, alpha_sc, alpha_sc)
    g_t = (warp.ggx_smith_g1(wi_f, h, alpha_sc, alpha_sc)
           * warp.ggx_smith_g1(wo_r, h, alpha_sc, alpha_sc))
    v_st = ((st * (1.0 - F_diel))[..., None] * base
            * m.safe_div(d_t * g_t, 4.0 * cos_i)[..., None])
    value = value + torch.where((refract & compat_t)[..., None], v_st, 0.0)
    fo = (1.0 - torch.abs(cos_o)) ** 5
    fi = (1.0 - cos_i) ** 5
    f_diff = (1.0 - 0.5 * fi) * (1.0 - 0.5 * fo)
    cos_d = m.dot(h, wo_t)
    rr = 2.0 * rough * cos_d * cos_d
    f_retro = rr * (fo + fi + fo * fi * (rr - 1.0))
    fss90 = rr / 2.0
    fss = m.lerp(1.0, fss90, fo) * m.lerp(1.0, fss90, fi)
    f_ss = 1.25 * (fss * (m.safe_div(torch.ones_like(cos_i),
                                     torch.abs(cos_o) + cos_i) - 0.5) + 0.5)
    v_dr = (((1.0 - st) * (1.0 - dt))[..., None] * base / math.pi
            * (cos_o * m.lerp(f_diff + f_retro, f_ss, flat))[..., None])
    fd = (1.0 - torch.abs(cos_d)) ** 5
    sheen_col = ((1.0 - p["sheen_tint"][..., None])
                 + p["sheen_tint"][..., None] * c_tint)
    v_dr = v_dr + (p["sheen"] * (1.0 - st) * (1.0 - dt) * fd
                   * torch.abs(cos_o))[..., None] * sheen_col
    value = value + torch.where(reflect[..., None], v_dr, 0.0)
    v_dt = ((1.0 - st) * dt * torch.abs(cos_o))[..., None] * base / math.pi
    value = value + torch.where(refract[..., None], v_dt, 0.0)

    pr = _thin_probs(p)
    dwh_dwo = m.safe_div(torch.ones_like(cos_i),
                         4.0 * torch.abs(m.dot(wo_r, h)))
    pdf_sr = warp.ggx_pdf_visible(wi_f, h, alpha_g, alpha_g) * dwh_dwo
    pdf_st = warp.ggx_pdf_visible(wi_f, h, alpha_sc, alpha_sc) * dwh_dwo
    pdf = torch.where(reflect & compat_r, pr[..., 0] * pdf_sr, 0.0)
    pdf = pdf + torch.where(refract & compat_t, pr[..., 1] * pdf_st, 0.0)
    cos_pdf = torch.abs(cos_o) / math.pi
    pdf = pdf + torch.where(reflect, pr[..., 2] * cos_pdf, 0.0)
    pdf = pdf + torch.where(refract, pr[..., 3] * cos_pdf, 0.0)
    ok = act & (cos_o != 0.0)
    return torch.where(ok[..., None], value, 0.0), torch.where(ok, pdf, 0.0)


def _principledthin_sample(p, wi, s1, s2):
    """principledthin.cpp sample (:832-893): a lobe by the normalized
    probabilities, a GGX visible normal (the transmission lobe's scaled)
    or the cosine hemisphere, transmission mirrored below the surface;
    weight = eval / pdf, eta 1."""
    cos_i0 = wi[..., 2]
    sgn = torch.where(cos_i0 >= 0.0, 1.0, -1.0)[..., None]
    wi_f = wi * sgn
    _, _, alpha_g, alpha_sc = _thin_alphas(p)
    pr = _thin_probs(p)
    c0 = pr[..., 0]
    c1 = c0 + pr[..., 1]
    c2 = c1 + pr[..., 2]
    sel_sr = s1 < c0
    sel_st = (s1 >= c0) & (s1 < c1)
    sel_dr = (s1 >= c1) & (s1 < c2)
    sel_dt = s1 >= c2

    m_r = warp.ggx_visible_normal_sample(wi_f, s2, alpha_g, alpha_g)
    m_t = warp.ggx_visible_normal_sample(wi_f, s2, alpha_sc, alpha_sc)
    mvec = torch.where(sel_st[..., None], m_t, m_r)
    spec = sel_sr | sel_st
    wo_t = torch.where(spec[..., None], m.reflect_m(wi_f, mvec),
                       warp.square_to_cosine_hemisphere(s2))
    flip = sel_st | sel_dt
    wo_t = torch.cat([wo_t[..., :2],
                      torch.where(flip, -torch.abs(wo_t[..., 2]),
                                  wo_t[..., 2])[..., None]], -1)
    wo = wo_t * sgn

    value, pdf = _principledthin_eval_pdf(p, wi, wo)
    weight = value * m.safe_div(torch.ones_like(pdf), pdf)[..., None]
    stype = torch.full(sel_sr.shape, BSDFFlags.DiffuseTransmission,
                       dtype=torch.int32, device=wi.device)
    stype = stype.masked_fill(sel_dr, BSDFFlags.DiffuseReflection)
    stype = stype.masked_fill(sel_st, BSDFFlags.GlossyTransmission)
    stype = stype.masked_fill(sel_sr, BSDFFlags.GlossyReflection)
    bs = BSDFSample(wo=wo, pdf=pdf, eta=torch.ones_like(pdf),
                    sampled_type=stype,
                    hf=torch.where(spec[..., None], mvec * sgn, _z_axis(wi)))
    side_ok = torch.where(sel_sr | sel_dr, wo_t[..., 2] > 0.0,
                          wo_t[..., 2] < 0.0)
    ok = (torch.abs(cos_i0) > 1e-7) & (pdf > 1e-12) & side_ok
    return bs, torch.where(ok[..., None], weight, 0.0), ok


def _null_sample(p, wi, s1, s2):
    """null (null.cpp, :906-915): straight through, weight 1."""
    pdf = torch.ones(wi.shape[:-1], dtype=wi.dtype, device=wi.device)
    bs = BSDFSample(wo=-wi, pdf=pdf, eta=torch.ones_like(pdf),
                    sampled_type=torch.full(pdf.shape, BSDFFlags.Null,
                                            dtype=torch.int32,
                                            device=wi.device),
                    hf=torch.zeros_like(wi))
    return bs, torch.ones_like(wi), torch.ones_like(pdf, dtype=torch.bool)


def _measured_sample(p, wi, s1, s2):
    """measured (``_measured_sample``, :955-974): a GGX visible normal at
    the fitted ``alpha`` (the proxy), reflected; the weight here is a
    placeholder, which ``sample`` replaces by f_r cos / pdf from the
    baked table."""
    alpha = p["alpha"]
    mvec = warp.ggx_visible_normal_sample(wi, s2, alpha, alpha)
    wo = m.reflect_m(wi, mvec)
    pdf = m.safe_div(warp.ggx_pdf_visible(wi, mvec, alpha, alpha),
                     4.0 * torch.abs(m.dot(wo, mvec)))
    bs = BSDFSample(wo=wo, pdf=pdf, eta=torch.ones_like(pdf),
                    sampled_type=torch.full(pdf.shape,
                                            BSDFFlags.GlossyReflection,
                                            dtype=torch.int32,
                                            device=wi.device), hf=mvec)
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0) & (pdf > 1e-12)
    return bs, torch.ones_like(wi), ok


def _measured_eval_pdf(p, wi, wo):
    """The proxy's pdf (``_measured_eval_pdf``, :977-986); the value is 0
    here and filled in from the baked table by ``_eval_table``."""
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    alpha = p["alpha"]
    h = m.normalize(wi + wo)
    pdf = m.safe_div(warp.ggx_pdf_visible(wi, h, alpha, alpha),
                     4.0 * torch.abs(m.dot(wo, h)))
    return torch.zeros_like(wi), torch.where(ok, pdf, 0.0)


def _measured_tex_eval(textures, tex_idx, wi, wo):
    """f_r (no cosine) of each lane's baked table, by ``tex_idx``
    (``_measured_tex_eval``, :989-999); 0 where the lane names none."""
    from . import measured as meas_mod
    items = (textures.items() if isinstance(textures, Mapping)
             else enumerate(textures))
    out = torch.zeros_like(wi)
    for i, tex in items:
        if tex.kind == "measured_brdf":
            out = torch.where((tex_idx == i)[..., None],
                              meas_mod.eval_table(tex, wi, wo), out)
    return out


_SAMPLE_FNS = {KIND_DIFFUSE: _diffuse_sample,
               KIND_CONDUCTOR: _conductor_sample,
               KIND_ROUGHCONDUCTOR: _roughconductor_sample,
               KIND_DIELECTRIC: _dielectric_sample,
               KIND_THINDIELECTRIC: _thindielectric_sample,
               KIND_ROUGHDIELECTRIC: _roughdielectric_sample,
               KIND_PLASTIC: _plastic_sample,
               KIND_ROUGHPLASTIC: _roughplastic_sample,
               KIND_NULL: _null_sample,
               KIND_PRINCIPLED: _principled_sample,
               KIND_PPLASTIC: _roughplastic_sample,
               KIND_PRINCIPLEDTHIN: _principledthin_sample,
               KIND_MEASURED: _measured_sample}
_EVAL_PDF_FNS = {KIND_DIFFUSE: _diffuse_eval_pdf,
                 KIND_CONDUCTOR: _zero_eval_pdf,
                 KIND_ROUGHCONDUCTOR: _roughconductor_eval_pdf,
                 KIND_DIELECTRIC: _zero_eval_pdf,
                 KIND_THINDIELECTRIC: _zero_eval_pdf,
                 KIND_ROUGHDIELECTRIC: _roughdielectric_eval_pdf,
                 KIND_PLASTIC: _plastic_eval_pdf,
                 KIND_ROUGHPLASTIC: _roughplastic_eval_pdf,
                 KIND_NULL: _zero_eval_pdf,
                 KIND_PRINCIPLED: _principled_eval_pdf,
                 KIND_PPLASTIC: _roughplastic_eval_pdf,
                 KIND_PRINCIPLEDTHIN: _principledthin_eval_pdf,
                 KIND_MEASURED: _measured_eval_pdf}

#: the first kind id of ``register_bsdf`` (the reference's
#: ``_CUSTOM_KIND_BASE``)
_CUSTOM_KIND_BASE = 1000


def register_bsdf(name: str, *, eval_pdf_fn, sample_fn,
                  flags: int = None) -> int:
    """A BSDF plugin (``register_bsdf``, :1101-1127; the reference's
    ``PluginManager::register_python_plugin``, src/core/plugin.cpp:168).

    ``eval_pdf_fn(p, wi, wo) -> (f * cos_theta_o (N, 3), pdf (N,))`` and
    ``sample_fn(p, wi, s1, s2) -> (BSDFSample, weight (N, 3), ok (N,))``
    are torch functions of the lanes' table columns ``p`` (``kind``,
    ``twosided`` and every colour and scalar column: ``reflectance``,
    ``alpha``, ``eta``, ...), in the local frame; they are
    differentiated by autograd.  ``flags`` default to a diffuse front
    side.  The kind joins the evaluation of every kind present on every
    lane; a scene names it as ``{"type": name, ...}``.  Returns the kind
    id, numbered from ``_CUSTOM_KIND_BASE``.  A name taken raises."""
    if name in KIND_NAMES:
        raise ValueError(f"bsdf type '{name}' already registered")
    kind = _CUSTOM_KIND_BASE + sum(1 for k in _SAMPLE_FNS
                                   if k >= _CUSTOM_KIND_BASE)
    KIND_NAMES[name] = kind
    _SAMPLE_FNS[kind] = sample_fn
    _EVAL_PDF_FNS[kind] = eval_pdf_fn
    KIND_FLAGS[kind] = (flags if flags is not None
                        else BSDFFlags.DiffuseReflection | BSDFFlags.FrontSide)
    KIND_FIELDS[kind] = _CUSTOM_FIELDS
    return kind


def _by_function(fns, kinds_present):
    """The scene's kinds grouped by their function in ``fns`` (``pplastic``
    is ``roughplastic``; the delta lobes share one ``eval_pdf``): each
    function runs once for its kinds' lanes.  Kinds without one (the
    blend, the sentinel) are left out."""
    groups = {}
    for kind in kinds_present:
        if kind in fns:
            groups.setdefault(fns[kind], []).append(kind)
    return groups.items()


def _is_kind(p, kinds) -> torch.Tensor:
    """The lanes whose slot is of one of ``kinds``."""
    is_k = p["kind"] == kinds[0]
    for kind in kinds[1:]:
        is_k = is_k | (p["kind"] == kind)
    return is_k


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
    (``_apply_textures``).

    A blend slot picks its second child with probability ``blend_weight``
    and its first otherwise, rescales ``s1`` to the pick and samples the
    child's row (:1184-1201); a lane whose pick is itself a blend samples
    nothing (ok False), as in the reference."""
    check_kinds(kinds_present)
    p = _kind_params(table, kinds_present, bsdf_idx, uv, textures, vcolor)
    if KIND_BLEND in kinds_present:
        is_blend = p["kind"] == KIND_BLEND
        wgt = p["blend_weight"]
        pick_b = s1 < wgt
        child = torch.where(pick_b, p["blend_b"], p["blend_a"])
        s1 = torch.where(
            is_blend,
            torch.where(pick_b, s1 / torch.clamp(wgt, min=1e-6),
                        (s1 - wgt) / torch.clamp(1.0 - wgt, min=1e-6)), s1)
        eff_idx = torch.where(is_blend, child, torch.clamp(bsdf_idx, min=0))
        p = _kind_params(table, kinds_present, eff_idx, uv, textures, vcolor)
    wi_f, flip = _apply_twosided_in(p, wi)
    bs = w = ok = None
    for fn, kinds in _by_function(_SAMPLE_FNS, kinds_present):
        bs_k, w_k, ok_k = fn(p, wi_f, s1, s2)
        is_k = _is_kind(p, kinds)
        if bs is None:
            bs, w, ok = bs_k, w_k, ok_k & is_k
        else:
            bs = _select_bs(is_k, bs_k, bs)
            w = torch.where(is_k[..., None], w_k, w)
            ok = torch.where(is_k, ok_k, ok)
    if KIND_MEASURED in kinds_present:
        # f_r cos / pdf of the proxy from the baked table (:1213-1222):
        # unbiased whatever the fit
        f_val = _measured_tex_eval(textures, p["reflectance_tex"], wi_f,
                                   bs.wo)
        w_m = f_val * (torch.clamp(bs.wo[..., 2:3], min=0.0)
                       / torch.clamp(bs.pdf, min=1e-12)[..., None])
        w = torch.where(((p["kind"] == KIND_MEASURED) & ok)[..., None], w_m,
                        w)
    bs = bs.replace(wo=_flip_z(bs.wo, flip), hf=_flip_z(bs.hf, flip))
    if active is not None:
        ok = ok & active
        w = torch.where(ok[..., None], w, 0.0)
    return bs, w, ok


def _eval_table(p, kinds_present, wi, wo, textures):
    """The per-kind eval_pdf selected by each lane's kind; 0 on a blend
    lane; a measured lane's value from its baked table (``textures``)."""
    wi_f, flip = _apply_twosided_in(p, wi)
    wo_f = _flip_z(wo, flip)
    val = torch.zeros_like(wi)
    pdf = torch.zeros_like(wi[..., 0])
    for fn, kinds in _by_function(_EVAL_PDF_FNS, kinds_present):
        val_k, pdf_k = fn(p, wi_f, wo_f)
        is_k = _is_kind(p, kinds)
        val = torch.where(is_k[..., None], val_k, val)
        pdf = torch.where(is_k, pdf_k, pdf)
    if KIND_MEASURED in kinds_present:
        f_val = _measured_tex_eval(textures, p["reflectance_tex"], wi_f,
                                   wo_f)
        val = torch.where((p["kind"] == KIND_MEASURED)[..., None],
                          f_val * torch.clamp(wo_f[..., 2:3], min=0.0), val)
    return val, pdf


def eval_pdf(table, kinds_present: Tuple[int, ...], bsdf_idx, wi, wo,
             active=None, uv=None, textures=(), vcolor=None):
    """BSDF::eval_pdf over the wavefront: (f * cos_theta_o (N,3), pdf).
    A blend slot's is the lerp of its two children's by ``blend_weight``
    (:1284-1298); a child that is itself a blend contributes 0.  The
    reference evaluates the table at the lanes' slots and at both
    children; here a lane's first evaluation is at its first child where
    its slot is a blend and at its own slot elsewhere, which gives every
    lane the same values with one evaluation of the table fewer."""
    check_kinds(kinds_present)
    p = _kind_params(table, kinds_present, bsdf_idx, uv, textures, vcolor)
    if KIND_BLEND not in kinds_present:
        val, pdf = _eval_table(p, kinds_present, wi, wo, textures)
    else:
        is_blend = p["kind"] == KIND_BLEND
        idx_a = torch.where(is_blend, p["blend_a"], bsdf_idx)
        val, pdf = _eval_table(_kind_params(table, kinds_present, idx_a, uv,
                                            textures, vcolor),
                               kinds_present, wi, wo, textures)
        vb, pb = _eval_table(_kind_params(table, kinds_present, p["blend_b"],
                                          uv, textures, vcolor),
                             kinds_present, wi, wo, textures)
        w_ = p["blend_weight"]
        val = torch.where(is_blend[..., None],
                          val * (1.0 - w_[..., None]) + vb * w_[..., None],
                          val)
        pdf = torch.where(is_blend, pdf * (1.0 - w_) + pb * w_, pdf)
    if active is not None:
        val = torch.where(active[..., None], val, 0.0)
        pdf = torch.where(active, pdf, 0.0)
    return val, pdf


def flags_of(table, bsdf_idx) -> torch.Tensor:
    """Per-lane BSDFFlags of the slot (slot 0 where idx is -1)."""
    return gather_params(table, bsdf_idx, ("flags",))["flags"]
