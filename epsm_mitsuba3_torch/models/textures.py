"""Textures (counterpart of ``models/textures.py``, the reference's
src/textures/{bitmap,checkerboard}.cpp and the ``mesh_attribute``
texture): the bitmap, looked up with bilinear filtering and wrapped at
its edges, the checkerboard, and ``mesh_attribute``, whose value is the
hit's interpolated vertex colour.

A scene carries a tuple of ``Texture`` records whose tensors are
differentiable leaves (``textures.<i>.data`` and the rest), so an
envmap's texels and a BSDF's take a gradient.  ``eval_select`` evaluates
the textures it is given and selects per lane; the reference evaluates
every texture of the scene, and the BSDFs and normal maps here pass only
those their slots name (``Scene.bsdf_textures``, ``normal_textures``),
which gives every lane the same value.  A ``measured_brdf`` texture is
a measured BSDF's baked table (``models/measured.py``), read by the BSDF
and skipped here; a ``pbsdf`` texture a pBSDF's (``grid3d`` (Np, Nd, Nh,
48), ``nodes`` its three node vectors end to end;
``models/measured_polarized.py``), whose colour is its placeholder
bitmap's texel, 0, as in the reference.  ``register_texture`` adds a kind written by the user
in torch.  The volume texture is not ported and raises by name."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Mapping, Optional

import torch

from ..ops.gather import take_rows

#: a colour texture's tensors
ARRAYS = ("data", "color0", "color1", "uv_scale", "uv_offset")
#: every texture tensor, ``textures.<i>.<name>`` among the scene's leaves:
#: the colour textures' and a measured table's
LEAF_ARRAYS = ARRAYS + ("grid3d", "nodes")


@dataclass(frozen=True)
class Texture:
    kind: str = "bitmap"                  # bitmap | checkerboard |
    #                                       mesh_attribute
    data: torch.Tensor = None             # (H, W, C) linear RGB (bitmap)
    color0: torch.Tensor = None           # (3,) checkerboard
    color1: torch.Tensor = None
    uv_scale: torch.Tensor = None         # (2,) to_uv scaling
    uv_offset: Optional[torch.Tensor] = None  # (2,) to_uv translation
    #: a measured BSDF's baked table (Ti, To, Pd, 3) and its theta_i grid,
    #: or a pBSDF's (Np, Nd, Nh, 48) and its phi_d, theta_d, theta_h nodes
    grid3d: Optional[torch.Tensor] = None
    nodes: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "Texture":
        return replace(self, **kw)

    def detach(self) -> "Texture":
        return replace(self, **{k: getattr(self, k).detach()
                                for k in LEAF_ARRAYS
                                if getattr(self, k) is not None})


def _t(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def bitmap(data, uv_scale=(1.0, 1.0), uv_offset=(0.0, 0.0),
           device=None) -> Texture:
    data = _t(data, device)
    return Texture(kind="bitmap", data=data,
                   color0=torch.zeros(3, device=data.device),
                   color1=torch.ones(3, device=data.device),
                   uv_scale=_t(uv_scale, data.device),
                   uv_offset=_t(uv_offset, data.device))


def checkerboard(color0=(0.4, 0.4, 0.4), color1=(0.2, 0.2, 0.2),
                 uv_scale=(1.0, 1.0), uv_offset=(0.0, 0.0),
                 device=None) -> Texture:
    c0 = _t(color0, device)
    return Texture(kind="checkerboard",
                   data=torch.zeros((1, 1, 3), device=c0.device),
                   color0=c0, color1=_t(color1, c0.device),
                   uv_scale=_t(uv_scale, c0.device),
                   uv_offset=_t(uv_offset, c0.device))


def volume3d(*_a, **_kw):
    raise NotImplementedError(
        "the volume texture (models/textures.py volume3d) is not ported")


#: the kinds of ``register_texture``: name -> eval fn
_CUSTOM_TEXTURE_FNS = {}


def register_texture(name: str, eval_fn) -> None:
    """A texture plugin (``register_texture``, :104-118; the reference's
    ``PluginManager::register_python_plugin``).  ``eval_fn(tex, uv (N,
    2), pos) -> (N, 3)`` is a torch function of the ``Texture``'s tensors
    (``color0``, ``color1``, ``uv_scale``, ``data``, parsed from the scene
    dict; they are leaves and take a gradient) and the hit's uv; ``pos``
    is None, as the reference's BSDF lookups give it on a surface without
    a volume texture.  A scene names it wherever a reflectance texture
    may stand, as ``{"type": name, ...}``.  A name taken raises."""
    if name in _CUSTOM_TEXTURE_FNS or name in KINDS:
        raise ValueError(f"texture type '{name}' already registered")
    _CUSTOM_TEXTURE_FNS[name] = eval_fn


#: the built-in kinds
KINDS = ("bitmap", "checkerboard", "mesh_attribute", "measured_brdf",
         "pbsdf")


def is_kind(kind: str) -> bool:
    """``kind`` is a texture the port evaluates."""
    return kind in KINDS or kind in _CUSTOM_TEXTURE_FNS


def _to_uv(tex: Texture, uv: torch.Tensor) -> torch.Tensor:
    """The texture's to_uv transform: scale, then translate
    (xml.cpp:379-410 builds translate([uoffset, voffset]) @ scale)."""
    st = uv if tex.uv_scale is None else uv * tex.uv_scale
    if tex.uv_offset is not None:
        st = st + tex.uv_offset
    return st


def eval_one(tex: Texture, uv: torch.Tensor) -> torch.Tensor:
    """One texture at (N, 2) uv -> (N, C)."""
    if tex.kind in _CUSTOM_TEXTURE_FNS:
        return _CUSTOM_TEXTURE_FNS[tex.kind](tex, uv, None)
    if tex.kind == "checkerboard":
        st = _to_uv(tex, uv)
        mask = ((torch.floor(st[..., 0]) + torch.floor(st[..., 1]))
                % 2.0) < 1.0
        return torch.where(mask[..., None], tex.color0, tex.color1)
    if tex.kind != "bitmap":
        raise NotImplementedError(f"texture kind '{tex.kind}' is not ported")
    st = _to_uv(tex, uv)
    h, w = tex.data.shape[:2]
    flat = tex.data.reshape(h * w, -1)
    x = st[..., 0] * w - 0.5
    y = st[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def at(xi, yi):
        # floor-mod wraps negative texel indices, as jnp's % does
        xi = torch.clamp(xi.to(torch.int32) % w, 0, w - 1)
        yi = torch.clamp(yi.to(torch.int32) % h, 0, h - 1)
        return take_rows(flat, yi * w + xi)

    return ((at(x0, y0) * (1 - fx) + at(x0 + 1, y0) * fx) * (1 - fy)
            + (at(x0, y0 + 1) * (1 - fx) + at(x0 + 1, y0 + 1) * fx) * fy)


def eval_select(textures, tex_idx: torch.Tensor, uv: torch.Tensor,
                fallback: torch.Tensor,
                vcolor: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Texture ``tex_idx`` of each lane (-1: ``fallback``).  ``textures``:
    a sequence (index = position) or a mapping of index to texture.  A
    ``mesh_attribute`` texture's value is ``vcolor``, the hit's vertex
    colour (``bsdf.py`` ``_apply_textures``, :1157-1160); without one
    its lanes keep ``fallback`` (only a BSDF slot names such a texture,
    and the BSDFs always pass the colour)."""
    items = (textures.items() if isinstance(textures, Mapping)
             else enumerate(textures))
    out = fallback
    for i, tex in items:
        if tex.kind == "measured_brdf":      # a BRDF table, no colour
            continue
        if tex.kind == "pbsdf":
            # the reference samples the table's placeholder bitmap, a
            # (1, 1, 3) of zeros
            out = torch.where((tex_idx == i)[..., None], 0.0, out)
            continue
        if tex.kind == "mesh_attribute":
            if vcolor is not None:
                out = torch.where((tex_idx == i)[..., None], vcolor, out)
            continue
        out = torch.where((tex_idx == i)[..., None], eval_one(tex, uv), out)
    return out
