"""BSDF models (counterpart of ``models/bsdf.py``): the diffuse BSDF with
the two-sided wrapper.

All BSDFs of a scene live in one table of per-slot parameters.  ``sample``
and ``eval_pdf`` check the kinds present in the scene and run the diffuse
BSDF on every lane; a kind the port does not have yet raises.

Conventions (bsdf.h): directions are in the local shading frame with the
normal = +Z; ``wi`` points away from the surface; ``sample`` returns
``weight = f * cos_theta_o / pdf``; ``eval_pdf`` returns ``f * cos_theta_o``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..core import warp
from ..ops.gather import take_rows
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


KIND_DIFFUSE = 0
KIND_NAMES = {"diffuse": KIND_DIFFUSE}
KIND_FLAGS = {KIND_DIFFUSE: BSDFFlags.DiffuseReflection | BSDFFlags.FrontSide}

def check_kinds(kinds_present: Tuple[int, ...]) -> None:
    """Raise unless every kind of the scene is one the port has."""
    missing = [k for k in kinds_present if k != KIND_DIFFUSE]
    if missing:
        raise NotImplementedError(
            f"BSDF kinds {missing}: the port has the diffuse BSDF only")


def gather_params(table: Dict[str, torch.Tensor], idx: torch.Tensor,
                  fields=("twosided", "reflectance")):
    """Per-lane parameters: each field (B, ...) -> (N, ...) at idx; lanes
    with idx -1 (no surface) read slot 0."""
    safe = torch.clamp(idx, min=0)
    return {k: take_rows(table[k], safe) for k in fields}


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


def _apply_twosided_in(p, wi):
    """twosided wrapper (src/bsdfs/twosided.cpp): flip the frame when wi
    arrives from the back side."""
    flip = p["twosided"] & (wi[..., 2] < 0.0)
    return _flip_z(wi, flip), flip


def _flip_z(v, flip):
    flipped = torch.cat([v[..., :2], -v[..., 2:]], dim=-1)
    return torch.where(flip[..., None], flipped, v)


def sample(table, kinds_present: Tuple[int, ...], bsdf_idx, wi, s1, s2,
           active=None):
    """BSDF::sample over the wavefront: (BSDFSample, weight (N,3), ok)."""
    check_kinds(kinds_present)
    p = gather_params(table, bsdf_idx)
    wi_f, flip = _apply_twosided_in(p, wi)
    bs, w, ok = _diffuse_sample(p, wi_f, s1, s2)
    bs = bs.replace(wo=_flip_z(bs.wo, flip), hf=_flip_z(bs.hf, flip))
    if active is not None:
        ok = ok & active
        w = torch.where(ok[..., None], w, 0.0)
    return bs, w, ok


def eval_pdf(table, kinds_present: Tuple[int, ...], bsdf_idx, wi, wo,
             active=None):
    """BSDF::eval_pdf over the wavefront: (f * cos_theta_o (N,3), pdf)."""
    check_kinds(kinds_present)
    p = gather_params(table, bsdf_idx)
    wi_f, flip = _apply_twosided_in(p, wi)
    val, pdf = _diffuse_eval_pdf(p, wi_f, _flip_z(wo, flip))
    if active is not None:
        val = torch.where(active[..., None], val, 0.0)
        pdf = torch.where(active, pdf, 0.0)
    return val, pdf


def flags_of(table, bsdf_idx) -> torch.Tensor:
    """Per-lane BSDFFlags of the slot (slot 0 where idx is -1)."""
    return gather_params(table, bsdf_idx, ("flags",))["flags"]
