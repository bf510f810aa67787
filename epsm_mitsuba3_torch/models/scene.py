"""Scene container, Mitsuba-style dict loader, the array interface and
``traverse`` (counterpart of ``models/scene.py``).

Geometry is one flat set of arrays (all meshes concatenated); structure
(kinds present, integrator settings, film sizes) is static metadata.
``load_dict`` takes the subset of the reference schema that the port
renders: ``rectangle``/``cube``/``disk``/``sphere``/``cylinder`` shapes
(the sphere tessellated, or analytic with ``analytic``: a row of
``Scene.sph_data``, ``ops/quadric.py``), in-memory ``mesh`` shapes and mesh files
(``obj``, ``ply``, ``serialized``, through ``mesh_io``), ``shapegroup``
and ``instance`` (flattened at load) and ``merge``; every scalar BSDF of
``models/bsdf.py`` (all of the reference's but ``polarizer``,
``retarder``, ``circular`` and ``measured_polarized``; a ``measured``
table is baked at load into a ``measured_brdf`` texture),
its rough kinds with the GGX or the Beckmann distribution, a
``blendbsdf`` with a scalar or textured weight and ``mask`` (a blend of
``null`` and its material), optionally ``twosided``, ``normalmap`` or
``bumpmap``, also stand-alone with an ``id`` and referenced by
``{"type": "ref"}``, their reflectance a colour, a tabulated
``regular`` or ``irregular`` spectrum or a ``bitmap``, ``checkerboard``
or ``mesh_attribute`` texture; the eight emitter kinds of
``models/emitters.py``, on a shape (area, directionalarea) or on their
own (point, spot, directional, constant, envmap from a bitmap file,
projector with a bitmap or checkerboard irradiance), and a scene with no
emitter (one constant-black row, as in the reference); the
seven sensor kinds of ``models/sensors.py`` (``batch`` with perspective
children), the five samplers of ``models/samplers.py``, ``hdrfilm``
with any of the six filters of ``models/films.py`` (``gaussian`` where
none is named); and the ``path``, ``prb``, ``prb_basic``,
``prb_reparam``, ``manifold``, ``manifold_caustic``, ``direct``,
``direct_reparam``, ``emission_reparam``, ``depth``, ``aov``, ``moment``
and ``ptracer`` integrators; and the kinds given to ``register_shape``,
``register_bsdf``, ``register_emitter``, ``register_sensor``,
``register_sampler`` and ``register_texture``.  Under a ``*_double``
variant (``config.py``) every float leaf is cast to float64 at the end
of ``scene_from_arrays``; the BVH stays float32.  The spectral types are not scene elements
in the reference either: ``render``'s ``integrator`` argument names
them, and a scene naming one raises ``ValueError`` as the reference's
loader does.  Any other plugin raises ``NotImplementedError`` with its
name.  Shapes keep
their names and vertex ranges, by which the experiments (``app/exp``) and ``traverse``
move them.  A scene of more than ``ops/accel.py``
``BRUTE_FORCE_MAX_TRIS`` triangles gets a BVH at load, packed once into
the records of kernels K2/K3.

``scene_from_arrays`` builds a scene from numpy arrays under the JAX
``Scene``'s field names: it carries the scene state between the two
packages, so that both render the very same scene.  The textures the
emitters and the BSDFs read are ``Scene.textures``, the vertex colours
a ``mesh_attribute`` texture reads ``Scene.vertex_colors``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import config
from ..core.device import resolve_device
from ..core.spectral import project_to_rgb
from ..core.spectrum import blackbody_rgb
from ..core.transform import ScalarTransform4f
from ..ops import accel
from ..ops import bvh as bvh_mod
from ..ops import cuda_traverse as CT
from ..ops import normals as nrm_mod
from . import bsdf as bsdf_mod
from . import emitters as em_mod
from . import mesh_io
from . import shapes as shapes_mod
from . import textures as tex_mod
from . import films
from . import samplers as smp_mod
from . import sensors as sns_mod
from .records import Ray, RayFlags
from .sensors import Sensor

#: per-vertex / per-face / per-shape arrays of the reference Scene
GEOMETRY_FIELDS = ("vertices", "normals", "uvs", "faces", "face_shape",
                   "shape_bsdf", "shape_emitter", "em_faces")
#: a sensor's float arrays, ``sensors.<i>.<name>`` (the batch sensor's
#: sub-sensor transforms only where it has them)
SENSOR_ARRAYS = ("to_world", "sub_to_world")


@dataclass(frozen=True)
class SceneStatic:
    shape_names: Tuple[str, ...] = ()
    #: per shape (vertex_start, vertex_count)
    vertex_ranges: Tuple[Tuple[int, int], ...] = ()
    bsdf_kinds: Tuple[int, ...] = ()
    emitter_kinds: Tuple[int, ...] = ()
    integrator: Tuple[Tuple[str, Any], ...] = ()
    spp: int = 16
    sampler_kind: str = "independent"
    #: index into ``Scene.textures`` of the (single) envmap bitmap, or -1
    env_texture: int = -1
    #: the textures the BSDF table's ``reflectance_tex`` and
    #: ``blend_weight_tex`` columns name, and its ``normal_tex`` column
    #: (``Scene.bsdf_textures``, ``Scene.normal_textures``)
    bsdf_textures: Tuple[int, ...] = ()
    normal_textures: Tuple[int, ...] = ()
    #: a texture is a ``mesh_attribute`` (the hit reads vertex colours)
    has_vertex_colors: bool = False

    @property
    def has_normal_maps(self) -> bool:
        """Some BSDF slot carries a normal or bump map."""
        return bool(self.normal_textures)


@dataclass(frozen=True)
class Scene:
    vertices: torch.Tensor       # (V, 3)
    normals: torch.Tensor        # (V, 3) zero rows -> face normal at hit
    uvs: torch.Tensor            # (V, 2)
    faces: torch.Tensor          # (F, 3) int32 global vertex ids
    face_shape: torch.Tensor     # (F,) int32
    shape_bsdf: torch.Tensor     # (S,) int32
    shape_emitter: torch.Tensor  # (S,) int32, -1 if not emissive
    bsdfs: Dict[str, torch.Tensor]
    emitters: Dict[str, torch.Tensor]
    em_faces: torch.Tensor       # (E, Tmax) int32 global face ids, -1 pad
    sensors: Tuple[Sensor, ...] = ()
    static: SceneStatic = field(default_factory=SceneStatic)
    #: the textures the emitters read (the envmap's bitmap, a projector's
    #: bitmap or checkerboard), by ``emitters["texture_index"]``
    textures: Tuple[tex_mod.Texture, ...] = ()
    #: (V, 3) per-vertex colours of the meshes that carry them (PLY
    #: ``red``/``green``/``blue``), zero rows elsewhere; a
    #: ``mesh_attribute`` texture reads them
    vertex_colors: Optional[torch.Tensor] = None
    #: BVH above ``accel.BRUTE_FORCE_MAX_TRIS`` triangles, else None
    bvh: Optional[bvh_mod.BVH] = None
    #: its K2/K3 inputs (``cuda_traverse.pack_bvh4``): node records
    #: (n4, 32), leaf-ordered triangles (F, 9), and the same triangles in
    #: the layout the K2/K3 kernels read
    bvh_nodes: Optional[torch.Tensor] = None
    bvh_tris: Optional[torch.Tensor] = None
    bvh_tris_k: Optional[torch.Tensor] = None
    #: (F, 3) int8: the edge opposite face vertex k is open (one adjacent
    #: triangle), from the geometry at load (``_open_edge_mask``); the
    #: topology is fixed, so moved vertices keep it.  The reparameterised
    #: integrators' boundary test reads it (``ad/reparam.py``)
    face_open: Optional[torch.Tensor] = None
    #: analytic spheres (``ops/quadric.py``): (S, 4) rows [center,
    #: radius], a differentiable leaf, and (S,) int32 the shape each
    #: belongs to; None without any
    sph_data: Optional[torch.Tensor] = None
    sph_shape: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    # -- differentiable state (ad/prb.py split_scene / merge_scene) ---------
    def leaves(self) -> Dict[str, torch.Tensor]:
        """The differentiable leaves by name: every float tensor of the
        scene state, i.e. the float geometry fields, the float columns of
        the BSDF and emitter tables (``bsdfs.<k>``, ``emitters.<k>``),
        each sensor's ``sensors.<i>.to_world`` (and a batch sensor's
        ``sensors.<i>.sub_to_world``) and each texture's tensors
        (``textures.<i>.data``, ``.color0``, ``.color1``, ``.uv_scale``,
        ``.uv_offset``, a measured BSDF's ``.grid3d`` and ``.nodes``), so
        that an envmap's or a BSDF's texels take a gradient, the
        ``vertex_colors`` and the analytic spheres' ``sph_data``.  The BVH
        and its packed records derive from the vertices and are no
        leaves."""
        out = {k: getattr(self, k) for k in GEOMETRY_FIELDS
               if getattr(self, k).is_floating_point()}
        if self.vertex_colors is not None:
            out["vertex_colors"] = self.vertex_colors
        if self.sph_data is not None:
            out["sph_data"] = self.sph_data
        for prefix in ("bsdfs", "emitters"):
            out.update({f"{prefix}.{k}": v
                        for k, v in getattr(self, prefix).items()
                        if v.is_floating_point()})
        for i, sensor in enumerate(self.sensors):
            for k in SENSOR_ARRAYS:
                if getattr(sensor, k) is not None:
                    out[f"sensors.{i}.{k}"] = getattr(sensor, k)
        for i, tex in enumerate(self.textures):
            for k in tex_mod.LEAF_ARRAYS:
                if getattr(tex, k) is not None:
                    out[f"textures.{i}.{k}"] = getattr(tex, k)
        return out

    def with_leaves(self, leaves: Mapping[str, torch.Tensor]) -> "Scene":
        """This scene with the named leaves replaced, values unchanged:
        the BVH is kept as it is (a vertex edit goes through
        ``set_vertices``)."""
        kw = {k: v for k, v in leaves.items()
              if k in GEOMETRY_FIELDS or k in ("vertex_colors", "sph_data")}
        for prefix in ("bsdfs", "emitters"):
            table = dict(getattr(self, prefix))
            table.update({k.split(".", 1)[1]: v for k, v in leaves.items()
                          if k.startswith(prefix + ".")})
            kw[prefix] = table
        kw["sensors"] = tuple(
            replace(s, **{k: leaves.get(f"sensors.{i}.{k}", getattr(s, k))
                          for k in SENSOR_ARRAYS})
            for i, s in enumerate(self.sensors))
        kw["textures"] = tuple(
            t.replace(**{k: leaves.get(f"textures.{i}.{k}", getattr(t, k))
                         for k in tex_mod.LEAF_ARRAYS})
            for i, t in enumerate(self.textures))
        return replace(self, **kw)

    def bsdf_textures(self) -> Dict[int, tex_mod.Texture]:
        """The textures of the BSDF slots' reflectance and blend weight,
        by index: what ``bsdf.sample`` and ``bsdf.eval_pdf`` evaluate."""
        return {i: self.textures[i] for i in self.static.bsdf_textures}

    def normal_textures(self) -> Dict[int, tex_mod.Texture]:
        """The normal and bump maps of the BSDF slots, by index."""
        return {i: self.textures[i] for i in self.static.normal_textures}

    def set_vertices(self, vertices: torch.Tensor) -> "Scene":
        """The scene with its vertex buffer replaced, and its BVH refit and
        its K2/K3 records re-packed from the (detached) new vertices
        (``Scene.set_vertices``, models/scene.py:117-130).  A scene whose
        BVH is left at the old geometry loses hits silently, so every
        vertex edit goes through here; ``vertices`` may carry a
        gradient."""
        sc = replace(self, vertices=vertices)
        if sc.bvh is None:
            return sc
        return sc.with_bvh(bvh_mod.refit(
            sc.bvh, vertices.detach().to(torch.float32), sc.faces))

    def with_bvh(self, bvh: bvh_mod.BVH) -> "Scene":
        """The scene with the BVH ``bvh`` (e.g. ``bvh_mod.build(...,
        builder="numpy")``) and its K2/K3 records packed from the
        vertices."""
        nodes, tris, tris_k = CT.pack_bvh4(
            bvh, self.vertices.detach().to(torch.float32), self.faces)
        return replace(self, bvh=bvh, bvh_nodes=nodes, bvh_tris=tris,
                       bvh_tris_k=tris_k)

    # -- ray queries (scene.cpp:116-142) ------------------------------------
    def ray_intersect_preliminary(self, ray: Ray,
                                  multi_pop: Optional[int] = None):
        """The triangle query (K1, or K2/K4 through the BVH), then the
        analytic spheres merged by the nearest t."""
        pi = accel.ray_intersect(self, ray, multi_pop=multi_pop)
        if self.sph_data is not None:
            from ..ops import quadric
            pi = quadric.merge_spheres(self, ray, pi)
        return pi

    def ray_intersect(self, ray: Ray, ray_flags: int = RayFlags.All):
        from ..ops import intersect as I
        pi = self.ray_intersect_preliminary(ray)
        return I.compute_surface_interaction(self, ray, pi, ray_flags)

    def ray_test(self, ray: Ray):
        occ = accel.ray_test(self, ray)
        if self.sph_data is not None:
            from ..ops import quadric
            occ = occ | quadric.sphere_occluded(ray, self.sph_data)
        return occ


# ===========================================================================
# Dict loader (mi.load_dict subset)
# ===========================================================================

_SHAPE_TYPES = ("obj", "ply", "serialized", "rectangle", "cube", "disk",
                "sphere", "cylinder", "instance", "shapegroup", "mesh")
_SENSOR_TYPES = sns_mod.KINDS
_INTEGRATOR_TYPES = ("path", "prb", "prb_basic", "prb_reparam", "manifold",
                     "manifold_caustic", "direct", "direct_reparam",
                     "emission_reparam", "depth", "aov", "moment",
                     "ptracer")
#: integrator types that ``render`` runs but the reference's loader does
#: not list (JAX models/scene.py:1041-1044): a scene naming one is refused
_RENDER_ONLY_TYPES = ("spectral", "spectral_mono", "spectral_spec")


#: the kinds of ``register_shape``: name -> build fn
_CUSTOM_SHAPE_FNS: Dict[str, Any] = {}


def register_shape(name: str, build_fn) -> None:
    """A shape plugin (``register_shape``, :148-161; the reference's
    ``PluginManager::register_python_plugin``).  ``build_fn(props) ->
    {"vertices": (V, 3), "faces": (F, 3)}``, with ``normals``, ``uvs`` or
    ``colors`` where it has them, turns the scene-dict entry into mesh
    arrays; ``to_world``, the BSDF and emitter children,
    ``face_normals``, ``flip_normals`` and the BVH are the shared
    pipeline's.  A scene names it as ``{"type": name, ...}``.  A name
    taken (a built-in one too) raises."""
    if name in _SHAPE_TYPES or name in _CUSTOM_SHAPE_FNS:
        raise ValueError(f"shape type '{name}' already registered")
    _CUSTOM_SHAPE_FNS[name] = build_fn


def _is_shape(t) -> bool:
    return t in _SHAPE_TYPES or t in _CUSTOM_SHAPE_FNS


def _open_edge_mask(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """(F, 3) int8: 1 where the edge opposite face vertex k has exactly
    one adjacent triangle (``_open_edge_mask``, :265-281).  Edges are keyed
    by quantised vertex positions, so the seams of split normals or uvs
    (duplicated vertex ids) count as shared."""
    if len(faces) == 0:
        return np.zeros((0, 3), np.int8)
    scale = float(np.abs(vertices).max()) or 1.0
    q = np.round(vertices / (scale * 1e-6)).astype(np.int64)
    _, vid = np.unique(q, axis=0, return_inverse=True)
    f = vid.reshape(-1)[faces]                         # (F, 3) position ids
    e = np.stack([f[:, [1, 2]], f[:, [2, 0]], f[:, [0, 1]]], 1)
    e = np.sort(e.reshape(-1, 2), axis=1)
    _, inv, cnt = np.unique(e, axis=0, return_inverse=True,
                            return_counts=True)
    return (cnt[inv.reshape(-1)] == 1).reshape(len(faces), 3).astype(
        np.int8)


def _parse_spd(value: dict):
    """A tabulated spectrum -> (wavelengths (M,), values (M,)) float64
    (``_parse_spd``, :164-185): ``regular`` values over [wavelength_min,
    wavelength_max] (360-830 nm by default), ``irregular`` explicit
    ``wavelengths`` and ``values``, or the string "lam0:v0, lam1:v1, ..."
    as ``value``."""
    if isinstance(value.get("value"), str):
        pairs = [p.split(":") for p in value["value"].split(",") if ":" in p]
        lams = np.asarray([float(a) for a, _ in pairs], np.float64)
        vals = np.asarray([float(b) for _, b in pairs], np.float64)
        return lams, vals
    vals = np.asarray(value.get("values", value.get("value")), np.float64)
    if value.get("type") == "regular" or "wavelengths" not in value:
        lo = float(value.get("wavelength_min", value.get("lambda_min", 360)))
        hi = float(value.get("wavelength_max", value.get("lambda_max", 830)))
        lams = np.linspace(lo, hi, len(vals))
    else:
        lams = np.asarray(value["wavelengths"], np.float64)
    return lams, vals


def _rgb(value, default=(1.0, 1.0, 1.0)):
    """Parse a colour: scalar | [r, g, b] | {'type': 'rgb', 'value': ...}
    | a blackbody | a tabulated spectrum, projected to linear sRGB
    through ``core/spectral.py``."""
    if value is None:
        return np.asarray(default, np.float32)
    if isinstance(value, dict):
        t = value.get("type", "rgb")
        if t in ("rgb", "srgb", "d65", "uniform"):
            return _rgb(value.get("value", value.get("color", default)))
        if t in ("regular", "irregular"):
            lams, vals = _parse_spd(value)
            rgb = project_to_rgb(
                lambda lam: np.interp(np.asarray(lam, np.float64), lams,
                                      vals, left=0.0, right=0.0))
            return np.asarray(rgb, np.float32) * float(value.get("scale",
                                                                 1.0))
        if t == "blackbody":
            rgb = blackbody_rgb(float(value.get("temperature", 5000.0)),
                                normalize=False)
            return rgb * float(value.get("scale", 1.0))
        if t in ("bitmap", "checkerboard", "mesh_attribute"):
            raise NotImplementedError(
                f"a '{t}' texture here is not ported: textures serve a "
                "BSDF's reflectance, a normal or bump map, an envmap and "
                "a projector")
        raise NotImplementedError(f"spectrum type '{t}' is not ported")
    arr = np.asarray(value, np.float32)
    if arr.ndim == 0:
        arr = np.full((3,), float(arr), np.float32)
    return arr.reshape(3)


#: named indices of refraction (``_IOR_NAMES``, :253-254)
_IOR_NAMES = {"bk7": 1.5046, "air": 1.000277, "water": 1.3330,
              "diamond": 2.419, "glass": 1.5046, "acrylic": 1.49}


def _ior(value, default: float) -> float:
    """An index of refraction: a number or a name of ``_IOR_NAMES``."""
    if value is None:
        return default
    if isinstance(value, str):
        if value not in _IOR_NAMES:
            raise NotImplementedError(
                f"index of refraction '{value}': not a named IOR of the "
                "port")
        return _IOR_NAMES[value]
    return float(value)


def _uv2(d: dict, key: str, default: float):
    """A texture's (u, v) pair ``key``: a list, a number for both, or
    ``<key>_x`` / ``<key>_y`` (the legacy upgrade's names)."""
    v = d.get(key, default)
    if isinstance(v, (list, tuple)):
        return tuple(float(x) for x in v)
    return (float(d.get(key + "_x", v)), float(d.get(key + "_y", v)))


def _transform(value) -> np.ndarray:
    if value is None:
        return np.eye(4, dtype=np.float32)
    if isinstance(value, ScalarTransform4f):
        return np.asarray(value.matrix, np.float32)
    return np.asarray(value, np.float32).reshape(4, 4)


#: the reference's BSDF plugin names (its ``KIND_NAMES``); the port has
#: all but the last four (``bsdf.KIND_NAMES``): the polarization elements
#: raise by name
_BSDF_PLUGINS = ("diffuse", "conductor", "roughconductor", "dielectric",
                 "thindielectric", "roughdielectric", "plastic",
                 "roughplastic", "null", "principled", "principledthin",
                 "blendbsdf", "pplastic", "measured", "polarizer",
                 "retarder", "circular", "measured_polarized")
#: the texture plugins a BSDF's reflectance may name
_REFLECTANCE_TEXTURES = ("bitmap", "checkerboard", "mesh_attribute",
                         "volume")


def _is_bsdf(t, extra=()) -> bool:
    """``t`` names a BSDF plugin (the reference's or one of
    ``register_bsdf``), or one of ``extra``."""
    return t in _BSDF_PLUGINS or t in bsdf_mod.KIND_NAMES or t in extra


def _is_texture(t) -> bool:
    """``t`` names a texture a reflectance may take (a plugin of
    ``register_texture`` too)."""
    return t in _REFLECTANCE_TEXTURES or t in tex_mod._CUSTOM_TEXTURE_FNS


def _unwrap_bsdf(d: dict):
    """(the nested BSDF, twosided) of ``d`` under its ``twosided``,
    ``mask``, ``normalmap`` and ``bumpmap`` wrappers (``_parse_bsdf``,
    :224-249): a wrapper's child is its ``material``, ``bsdf`` or
    ``nested`` entry, else its first entry that is a BSDF or a twosided
    wrapper.  A ``mask`` under another wrapper is unwrapped like them, its
    opacity dropped, as in the reference (``add_bsdf`` turns a mask on
    the outside into a blend)."""
    twosided = False
    while d.get("type") in ("twosided", "mask", "bumpmap", "normalmap"):
        twosided = twosided or d["type"] == "twosided"
        child = next((d[k] for k in ("material", "bsdf", "nested")
                      if isinstance(d.get(k), dict)), None)
        if child is None:
            child = next((v for v in d.values() if isinstance(v, dict)
                          and _is_bsdf(v.get("type"), ("twosided",))),
                         None)
        if child is None:
            raise ValueError(f"wrapper bsdf '{d['type']}' without nested "
                             "material")
        d = child
    return d, twosided


class _Builder:
    def __init__(self):
        self.vertices, self.normals, self.uvs, self.faces = [], [], [], []
        self.vertex_colors = []
        self.face_shape, self.shape_bsdf, self.shape_emitter = [], [], []
        self.shape_names, self.vertex_ranges = [], []
        self.bsdf_rows = []
        self.bsdf_by_id = {}
        self.shapegroups = {}
        self.em_rows, self.em_shape, self.em_face_list = [], [], []
        self.textures = []
        self.env_texture = -1
        self.sensors = []
        self.integrator = {"type": "path", "max_depth": 6, "rr_depth": 5}
        self.spp = 16
        self.sampler_kind = "independent"
        self.sph_rows, self.sph_shape_rows = [], []
        self._v_off = 0
        self._f_off = 0

    # -- BSDFs (_Builder.add_bsdf) ------------------------------------------
    def add_bsdf(self, d: dict) -> int:
        """A row of the BSDF table for ``d`` (a ``ref`` is the row of its
        ``id``); a BSDF with an ``id`` is registered under it.  A blend's
        two children get their rows first; a ``mask`` is a blend of
        ``null`` and its material with the opacity as the weight
        (:386-399)."""
        if d.get("type") == "ref":
            if d["id"] not in self.bsdf_by_id:
                raise KeyError(f"bsdf reference to an unknown id "
                               f"'{d['id']}'")
            return self.bsdf_by_id[d["id"]]
        if d.get("type") == "mask":
            nested = next((v for k, v in d.items() if isinstance(v, dict)
                           and k != "opacity"
                           and v.get("type") not in ("bitmap", "checkerboard",
                                                     "mesh_attribute")), None)
            if nested is None:
                raise ValueError("mask bsdf without nested material")
            d = {"type": "blendbsdf", "weight": d.get("opacity", 0.5),
                 "a": {"type": "null"}, "b": nested,
                 **({"id": d["id"]} if "id" in d else {})}
        # a normal or bump map wrapper's texture, recorded before the
        # unwrapping (:402-415); a bump map's texture is read as a
        # tangent-space normal map, as the reference does
        normal_tex = -1
        if d.get("type") in ("bumpmap", "normalmap"):
            for key in ("bumpmap", "normalmap", "texture"):
                tex = d.get(key)
                if isinstance(tex, dict) and tex.get("type") in (
                        "bitmap", "checkerboard"):
                    normal_tex = self.add_texture(tex)
        p, twosided = _unwrap_bsdf(d)
        kind_name = p.get("type")
        if kind_name not in bsdf_mod.KIND_NAMES:
            raise NotImplementedError(f"bsdf type '{kind_name}' is not ported")
        kind = bsdf_mod.KIND_NAMES[kind_name]
        conductor = kind in (bsdf_mod.KIND_CONDUCTOR,
                             bsdf_mod.KIND_ROUGHCONDUCTOR)
        if conductor and isinstance(p.get("material"), str):
            raise NotImplementedError(
                f"conductor material '{p['material']}': the spectral "
                "tables of named materials are not ported; give eta and k")
        alpha = p.get("alpha", p.get("roughness", bsdf_mod.DEFAULT_ALPHA))
        if isinstance(alpha, dict):
            # a textured roughness loads as the default, as in the
            # reference (:514-516)
            alpha = bsdf_mod.DEFAULT_ALPHA
        elif isinstance(alpha, (list, tuple)):
            raise NotImplementedError(
                "a roughness given as a list is not ported; give alpha as "
                "a number")
        # a measured BSDF's table, baked from its tensor file (:420-434),
        # is a texture the slot's reflectance_tex names; its alpha is the
        # fitted roughness of the sampling proxy
        measured_tex = -1
        if kind == bsdf_mod.KIND_MEASURED:
            from . import measured as meas_mod
            table, ti_nodes, alpha = meas_mod.bake(p["filename"])
            self.textures.append({
                "kind": "measured_brdf",
                "data": np.zeros((1, 1, 3), np.float32),
                "color0": np.zeros(3, np.float32),
                "color1": np.ones(3, np.float32),
                "uv_scale": np.ones(2, np.float32),
                "grid3d": table, "nodes": ti_nodes})
            measured_tex = len(self.textures) - 1
        # a blend's children first (:454-464): BSDFs, twosided wrappers and
        # references among its entries, in order
        blend_a = blend_b = 0
        if kind == bsdf_mod.KIND_BLEND:
            children = [v for v in p.values() if isinstance(v, dict)
                        and _is_bsdf(v.get("type"), ("twosided", "ref"))]
            if len(children) < 2:
                raise ValueError("blendbsdf needs two nested BSDFs")
            blend_a = self.add_bsdf(children[0])
            blend_b = self.add_bsdf(children[1])
        refl = p.get("reflectance", p.get("base_color"))
        refl_tex = -1
        if isinstance(refl, dict) and _is_texture(refl.get("type")):
            refl_tex = self.add_texture(refl)
            refl = None
        diffuse = p.get("diffuse_reflectance")
        if isinstance(diffuse, dict) and diffuse.get("type") in \
                _REFLECTANCE_TEXTURES:
            # as the reference's ``_rgb`` (:185-208): a plastic's textured
            # diffuse reflectance is refused; its ``reflectance`` texture
            # serves it
            raise ValueError(f"unsupported spectrum type {diffuse['type']}")
        # the relative IOR column: int_ior / ext_ior for the dielectrics and
        # the plastics but pplastic (:526-530), any other kind's scalar eta
        # (an rgb eta is the conductor's eta_c)
        if kind in (bsdf_mod.KIND_DIELECTRIC, bsdf_mod.KIND_THINDIELECTRIC,
                    bsdf_mod.KIND_ROUGHDIELECTRIC, bsdf_mod.KIND_PLASTIC,
                    bsdf_mod.KIND_ROUGHPLASTIC):
            eta = (_ior(p.get("int_ior"), 1.5046)
                   / _ior(p.get("ext_ior"), 1.000277))
        elif isinstance(p.get("eta"), (dict, list)):
            eta = bsdf_mod.DEFAULT_ETA
        else:
            eta = float(p.get("eta", bsdf_mod.DEFAULT_ETA))
        weight = p.get("weight")
        row = {
            "kind": kind,
            "flags": bsdf_mod.KIND_FLAGS[kind]
            | (bsdf_mod.BSDFFlags.BackSide if twosided else 0)
            | (bsdf_mod.BSDFFlags.SpatiallyVarying if refl_tex >= 0 else 0),
            "twosided": twosided,
            "reflectance": _rgb(refl, (0.5, 0.5, 0.5)),
            "reflectance_tex": refl_tex,
            "normal_tex": normal_tex,
            "specular_reflectance": _rgb(p.get("specular_reflectance")),
            "specular_transmittance": _rgb(p.get("specular_transmittance",
                                                 p.get("transmittance"))),
            "diffuse_reflectance": _rgb(diffuse, (0.5, 0.5, 0.5)),
            "alpha": float(alpha),
            # the microfacet distribution (:517-521): GGX unless the slot
            # names Beckmann, as the reference's loader defaults
            "beckmann": str(p.get("distribution", "ggx")) == "beckmann",
            "eta_c": _rgb(p.get("eta"), (0.0, 0.0, 0.0)) if conductor
            else np.zeros(3, np.float32),
            "k_c": _rgb(p.get("k"), (1.0, 1.0, 1.0)),
            "eta": eta,
            # the principled and principledthin parameters (:477-488)
            **{k: float(p.get(k, v))
               for k, v in bsdf_mod.SCALAR_DEFAULTS.items()
               if k not in ("alpha", "eta", "blend_weight")},
            "blend_a": blend_a,
            "blend_b": blend_b,
            # a scalar or textured weight (a mask's opacity, :489-492)
            "blend_weight": 0.5 if isinstance(weight, dict)
            else float(p.get("weight", 0.5)),
            "blend_weight_tex": self.add_texture(weight)
            if isinstance(weight, dict) else -1,
        }
        if measured_tex >= 0:
            row["reflectance_tex"] = measured_tex
        self.bsdf_rows.append(row)
        idx = len(self.bsdf_rows) - 1
        if "id" in d:
            self.bsdf_by_id[d["id"]] = idx
        return idx

    # -- textures (_Builder.add_texture) ------------------------------------
    def add_texture(self, d: dict) -> int:
        """A texture (``_Builder.add_texture``, :308-380): a ``bitmap``
        read from its ``filename``, a ``checkerboard`` or a
        ``mesh_attribute``.  Returns its index into ``Scene.textures``."""
        t = d.get("type")
        uv = {"uv_scale": _uv2(d, "uv_scale", 1.0),
              "uv_offset": _uv2(d, "uv_offset", 0.0)}
        if t == "bitmap":
            from ..core.bitmap import read_image
            tex = {"kind": "bitmap", "data": read_image(d["filename"]).data,
                   "color0": np.zeros(3, np.float32),
                   "color1": np.ones(3, np.float32), **uv}
        elif t == "checkerboard":
            tex = {"kind": "checkerboard",
                   "data": np.zeros((1, 1, 3), np.float32),
                   "color0": _rgb(d.get("color0"), (0.4, 0.4, 0.4)),
                   "color1": _rgb(d.get("color1"), (0.2, 0.2, 0.2)), **uv}
        elif t == "mesh_attribute":
            # the reference's placeholder arrays (no offset): the value
            # is the hit's vertex colour
            tex = {"kind": t, "data": np.zeros((1, 1, 3), np.float32),
                   "color0": np.zeros(3, np.float32),
                   "color1": np.ones(3, np.float32),
                   "uv_scale": np.ones(2, np.float32)}
        elif t in tex_mod._CUSTOM_TEXTURE_FNS:
            # a register_texture plugin (:357-376): the dict's filename,
            # colours and uv_scale in the generic fields
            data = np.zeros((1, 1, 3), np.float32)
            if d.get("filename"):
                from ..core.bitmap import read_image
                data = read_image(d["filename"]).data
            scale = d.get("uv_scale", 1.0)
            tex = {"kind": t, "data": data,
                   "color0": _rgb(d.get("color0"), (1, 1, 1)),
                   "color1": _rgb(d.get("color1"), (0, 0, 0)),
                   "uv_scale": np.asarray(
                       scale if isinstance(scale, (list, tuple))
                       else (float(scale),) * 2, np.float32)}
        else:
            raise NotImplementedError(f"texture type '{t}' is not ported")
        self.textures.append(tex)
        return len(self.textures) - 1

    # -- emitters (_Builder.add_emitter) ------------------------------------
    def add_emitter(self, d: dict, shape_index: int = -1) -> int:
        """A row of the emitter table (``_Builder.add_emitter``,
        :586-645); ``shape_index`` -1 for a light without a shape."""
        t = d["type"]
        if t not in em_mod.KIND_NAMES:
            raise NotImplementedError(
                f"emitter type '{t}' is not ported (register_emitter "
                "plugins are not)")
        kind = em_mod.KIND_NAMES[t]
        to_world = _transform(d.get("to_world"))
        pos = to_world[:3, 3]
        direction = to_world[:3, :3] @ np.array([0, 0, 1], np.float32)
        if "position" in d:
            pos = np.asarray(d["position"], np.float32)
        if "direction" in d:
            direction = np.asarray(d["direction"], np.float32)
        cutoff = float(d.get("cutoff_angle", 20.0))
        beam = float(d.get("beam_width", cutoff * 0.75))
        tex_idx = -1
        if kind == em_mod.KIND_ENVMAP and "filename" in d:
            tex_idx = self.add_texture({"type": "bitmap",
                                        "filename": d["filename"]})
            self.env_texture = tex_idx
        rad = d.get("radiance")
        if isinstance(rad, dict) and rad.get("type") in ("bitmap",
                                                         "checkerboard"):
            tex_idx = self.add_texture(rad)
            rad = None
        # the projector: an irradiance texture, a frame from to_world
        frame_x = to_world[:3, :3] @ np.array([1, 0, 0], np.float32)
        frame_y = to_world[:3, :3] @ np.array([0, 1, 0], np.float32)
        tan_fov = np.tan(np.deg2rad(float(d.get("fov", 45.0))) / 2.0)
        intensity = _rgb(d.get("intensity"))
        irr = d.get("irradiance")
        irr_tex = isinstance(irr, dict) and irr.get("type") in (
            "bitmap", "checkerboard")
        if kind == em_mod.KIND_PROJECTOR:
            if irr_tex:
                tex_idx = self.add_texture(irr)
            elif irr is not None:
                intensity = _rgb(irr)
            intensity = intensity * float(d.get("scale", 1.0))
        self.em_rows.append({
            "kind": kind,
            "texture_index": tex_idx,
            "radiance": _rgb(rad) * float(d.get("scale", 1.0)),
            "intensity": intensity,
            "frame_x": frame_x,
            "frame_y": frame_y,
            "tan_fov": np.asarray([tan_fov, tan_fov], np.float32),
            "irradiance": _rgb(None) if irr_tex else _rgb(irr),
            "position": pos,
            "direction": direction,
            "cutoff_cos": np.cos(np.deg2rad(cutoff)),
            "beam_cos": np.cos(np.deg2rad(beam)),
            "shape_index": shape_index,
        })
        return len(self.em_rows) - 1

    # -- shapes (_Builder.add_shape) ----------------------------------------
    def add_shape(self, d: dict, name: str):
        t = d["type"]
        if t == "shapegroup":
            # a group definition: its children, no geometry of its own
            # (shapegroup.cpp)
            self.shapegroups[d.get("id", name)] = [
                v for v in d.values()
                if isinstance(v, dict) and _is_shape(v.get("type"))]
            return
        if t == "instance":
            # flattened at load: the group's shapes under the instance's
            # transform (instance.cpp)
            ref = next((v for v in d.values()
                        if isinstance(v, dict) and v.get("type") == "ref"),
                       None)
            gid = ref["id"] if ref else d.get("shapegroup")
            if gid not in self.shapegroups:
                raise ValueError(f"instance references unknown group "
                                 f"'{gid}'")
            inst_t = _transform(d.get("to_world"))
            for j, child in enumerate(self.shapegroups[gid]):
                child = dict(child)
                child["to_world"] = inst_t @ _transform(child.get("to_world"))
                self.add_shape(child, f"{name}.{gid}_{j}")
            return
        if t in ("obj", "ply", "serialized"):
            mesh = mesh_io.load_mesh_file(d["filename"],
                                          int(d.get("shape_index", 0)))
        elif t == "mesh":
            # raw in-memory mesh: vertex and face arrays
            mesh = {"vertices": np.asarray(d["vertices"], np.float32),
                    "faces": np.asarray(d["faces"], np.int32)}
            for k in ("normals", "uvs"):
                if k in d:
                    mesh[k] = np.asarray(d[k], np.float32)
        elif t in _CUSTOM_SHAPE_FNS:
            # a register_shape plugin: its mesh arrays, then the shared
            # pipeline (to_world, children, the BVH)
            mesh = dict(_CUSTOM_SHAPE_FNS[t](d))
            mesh["vertices"] = np.asarray(mesh["vertices"], np.float32)
            mesh["faces"] = np.asarray(mesh["faces"], np.int32)
            for k in ("normals", "uvs", "colors"):
                if mesh.get(k) is not None:
                    mesh[k] = np.asarray(mesh[k], np.float32)
        elif t == "sphere":
            if bool(d.get("analytic", False)):
                return self._add_analytic_sphere(d, name)
            mesh = shapes_mod.sphere(
                radius=float(d.get("radius", 1.0)),
                center=tuple(d.get("center", (0.0, 0.0, 0.0))),
                subdiv=int(d.get("subdiv", 32)))
        elif t == "cylinder":
            mesh = shapes_mod.cylinder(radius=float(d.get("radius", 1.0)))
        else:
            mesh = getattr(shapes_mod, t)()
        to_world = _transform(d.get("to_world"))
        v = mesh["vertices"]
        vh = np.concatenate([v, np.ones((len(v), 1), np.float32)], -1)
        v = (vh @ to_world.T)[:, :3]
        # normals by the inverse transpose, in the reference's order of
        # float32 operations (scene.py:734-744)
        n = mesh.get("normals")
        if n is not None:
            nrm_mat = np.linalg.inv(to_world[:3, :3]).T
            n = n @ nrm_mat.T
            n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                               1e-20)
        if n is None or bool(d.get("face_normals", False)):
            n = np.zeros_like(v)     # zero rows: the face normal at a hit
        uv = mesh.get("uvs")
        if uv is None:
            uv = np.zeros((len(v), 2), np.float32)
        vcol = mesh.get("colors")
        if vcol is None:
            vcol = np.zeros((len(v), 3), np.float32)
        f = mesh["faces"]
        if bool(d.get("flip_normals", False)):
            f = f[:, ::-1].copy()
            n = -n

        shape_index = len(self.shape_bsdf)
        bsdf_idx = em_idx = -1
        for key, val in d.items():
            if not isinstance(val, dict):
                continue
            vt = val.get("type")
            if vt == "ref" or key == "bsdf" or vt in ("twosided", "mask") \
                    or vt in bsdf_mod.KIND_NAMES:
                bsdf_idx = self.add_bsdf(val)
            elif key == "emitter" or vt in em_mod.KIND_NAMES:
                em_idx = self.add_emitter(val, shape_index)
            else:
                raise NotImplementedError(
                    f"shape child '{key}' of type '{vt}' is not ported")
        if bsdf_idx < 0:
            bsdf_idx = self.add_bsdf({"type": "diffuse"})

        nf, nv = len(f), len(v)
        self.shape_names.append(name)
        self.vertex_ranges.append((self._v_off, nv))
        self.shape_bsdf.append(bsdf_idx)
        self.shape_emitter.append(em_idx)
        self.vertices.append(v.astype(np.float32))
        self.normals.append(n.astype(np.float32))
        self.uvs.append(uv.astype(np.float32))
        self.vertex_colors.append(vcol.astype(np.float32))
        self.faces.append((f + self._v_off).astype(np.int32))
        self.face_shape.append(np.full((nf,), shape_index, np.int32))
        if em_idx >= 0:
            self.em_shape.append(em_idx)
            self.em_face_list.append(
                np.arange(self._f_off, self._f_off + nf, dtype=np.int32))
        self._v_off += nv
        self._f_off += nf

    def _add_analytic_sphere(self, d: dict, name: str):
        """A quadric sphere (``_add_analytic_sphere``, :799-840): a shape
        slot without triangles and a row [center, radius] of the spheres'
        table, under ``to_world``, which must scale uniformly.  A BSDF
        child is loaded as on a mesh; an emitter child raises (the
        reference tessellates such a sphere instead: load it without
        ``analytic``)."""
        to_world = _transform(d.get("to_world"))
        lin = to_world[:3, :3]
        scales = np.linalg.norm(lin, axis=0)
        if not np.allclose(scales, scales[0], rtol=1e-4):
            raise ValueError(
                f"shape '{name}': analytic sphere needs a uniform-scale "
                "to_world (non-uniform scale makes it an ellipsoid; "
                "tessellate instead)")
        c = lin @ np.asarray(d.get("center", (0.0, 0.0, 0.0)), np.float32) \
            + to_world[:3, 3]
        r = float(d.get("radius", 1.0)) * float(scales[0])
        shape_index = len(self.shape_bsdf)
        bsdf_idx = -1
        for key, val in d.items():
            if not isinstance(val, dict):
                continue
            vt = val.get("type")
            if key == "emitter" or vt in em_mod.KIND_NAMES:
                raise ValueError(
                    f"shape '{name}': an analytic sphere with an emitter "
                    "is not supported; load the sphere tessellated")
            if vt == "ref" or key == "bsdf" or vt in ("twosided", "mask") \
                    or vt in bsdf_mod.KIND_NAMES:
                bsdf_idx = self.add_bsdf(val)
            else:
                raise NotImplementedError(
                    f"shape child '{key}' of type '{vt}' is not ported")
        if bsdf_idx < 0:
            bsdf_idx = self.add_bsdf({"type": "diffuse"})
        self.shape_names.append(name)
        self.vertex_ranges.append((self._v_off, 0))
        self.shape_bsdf.append(bsdf_idx)
        self.shape_emitter.append(-1)
        self.vertices.append(np.zeros((0, 3), np.float32))
        self.normals.append(np.zeros((0, 3), np.float32))
        self.uvs.append(np.zeros((0, 2), np.float32))
        self.vertex_colors.append(np.zeros((0, 3), np.float32))
        self.faces.append(np.zeros((0, 3), np.int32))
        self.face_shape.append(np.zeros((0,), np.int32))
        self.sph_rows.append([c[0], c[1], c[2], r])
        self.sph_shape_rows.append(shape_index)

    # -- sensor (_Builder.add_sensor) ---------------------------------------
    def add_sensor(self, d: dict):
        """A sensor row (``_Builder.add_sensor``, :847-911).  A ``batch``
        sensor tiles its perspective children side by side on its film,
        whose width must divide by their number (batch.cpp:49-58); as in
        the reference, it sets the scene's spp but not its sampler kind."""
        film = d.get("film", {})
        if film.get("type", "hdrfilm") != "hdrfilm":
            raise NotImplementedError(f"film '{film['type']}' is not ported")
        sampler = d.get("sampler", {})
        rf = film.get("rfilter", {})
        rfk = rf.get("type", "gaussian") if isinstance(rf, dict) else str(rf)
        if rfk not in films.FILTERS:
            raise NotImplementedError(f"rfilter '{rfk}' is not ported")
        self.spp = int(sampler.get("sample_count", self.spp))
        if d.get("type") == "batch":
            subs = [v for v in d.values() if isinstance(v, dict)
                    and sns_mod.is_kind(v.get("type"))
                    and v.get("type") != "batch"]
            if not subs:
                raise ValueError("batch sensor needs nested sensors")
            for sub in subs:
                if sub.get("type") != "perspective":
                    raise ValueError(
                        "batch sensor: only perspective sub-sensors are "
                        f"supported (got {sub.get('type')!r})")
            sub_tw = np.stack([_transform(sub.get("to_world"))
                               for sub in subs])
            w0 = int(subs[0].get("film", {}).get("width", 256))
            h0 = int(subs[0].get("film", {}).get("height", 256))
            bw = int(film.get("width", w0 * len(subs)))
            if bw % len(subs) != 0:
                raise ValueError(
                    f"batch sensor: film width {bw} must be divisible by "
                    f"the number of child sensors {len(subs)} "
                    "(batch.cpp:50-54)")
            self.sensors.append(dict(
                to_world=sub_tw[0], sub_to_world=sub_tw, kind="batch",
                width=bw, height=int(film.get("height", h0)), rfilter=rfk,
                sub_fov_x=tuple(float(sub.get("fov", 45.0))
                                for sub in subs)))
            return
        kind = sampler.get("type", self.sampler_kind)
        if kind not in smp_mod.KINDS \
                and kind not in smp_mod._CUSTOM_SAMPLER_FNS:
            raise NotImplementedError(f"sampler '{kind}' is not ported")
        self.sampler_kind = kind
        self.sensors.append(dict(
            to_world=_transform(d.get("to_world")),
            kind=d.get("type", "perspective"),
            fov_x=float(d.get("fov", 45.0)),
            near=float(d.get("near_clip", 1e-2)),
            far=float(d.get("far_clip", 1e4)),
            width=int(film.get("width", 256)),
            height=int(film.get("height", 256)),
            rfilter=rfk,
            aperture_radius=float(d.get("aperture_radius", 0.0)),
            focus_distance=float(d.get("focus_distance", 1.0))))

    def arrays(self) -> Dict[str, np.ndarray]:
        """The scene state under the reference Scene's field names."""
        if not self.shape_bsdf:
            raise ValueError("scene has no shapes")
        out = {
            "vertices": np.concatenate(self.vertices),
            "normals": np.concatenate(self.normals),
            "uvs": np.concatenate(self.uvs),
            "vertex_colors": np.concatenate(self.vertex_colors),
            "faces": np.concatenate(self.faces),
            "face_shape": np.concatenate(self.face_shape),
            "shape_bsdf": np.asarray(self.shape_bsdf, np.int32),
            "shape_emitter": np.asarray(self.shape_emitter, np.int32),
        }
        n_e = max(len(self.em_rows), 1)
        tmax = max((len(x) for x in self.em_face_list), default=1)
        em_faces = np.full((n_e, tmax), -1, np.int32)
        for em_idx, face_ids in zip(self.em_shape, self.em_face_list):
            em_faces[em_idx, :len(face_ids)] = face_ids
        out["em_faces"] = em_faces
        if self.sph_rows:
            out["sph_data"] = np.asarray(self.sph_rows, np.float32)
            out["sph_shape"] = np.asarray(self.sph_shape_rows, np.int32)
        for k in self.bsdf_rows[0]:
            out[f"bsdfs.{k}"] = np.asarray([r[k] for r in self.bsdf_rows])
        # the emitter table: the reference's defaults, then the rows
        # (``build``, :926-939); no emitter leaves one constant-black row
        etable = {k: v.numpy().copy()
                  for k, v in em_mod.empty_table(n_e).items()}
        for i, row in enumerate(self.em_rows):
            for k, val in row.items():
                etable[k][i] = val
        if not self.em_rows:
            etable["kind"][:] = em_mod.KIND_CONSTANT
            etable["radiance"][:] = 0.0
        out.update({f"emitters.{k}": v for k, v in etable.items()})
        for i, tex in enumerate(self.textures):
            out.update({f"textures.{i}.{k}": tex[k]
                        for k in tex_mod.LEAF_ARRAYS if k in tex})
        for i, s in enumerate(self.sensors):
            for k in SENSOR_ARRAYS:
                if k in s:
                    out[f"sensors.{i}.{k}"] = s[k]
        return out


def load_dict(d: Mapping[str, Any], device=None) -> Scene:
    """mi.load_dict for the ported subset of the schema.  ``device=None``
    means the GPU; without CUDA that raises."""
    device = resolve_device(device)
    if d.get("type") != "scene":
        raise ValueError("top-level dict must have type 'scene'")
    b = _Builder()
    for key, val in d.items():
        if key == "type" or not isinstance(val, dict):
            continue
        t = val.get("type")
        if sns_mod.is_kind(t):
            b.add_sensor(val)
        elif t in _INTEGRATOR_TYPES:
            b.integrator = dict(val)
        elif t in _RENDER_ONLY_TYPES:
            raise ValueError(f"unsupported scene element '{key}' type={t}")
        elif _is_shape(t):
            b.add_shape(val, key)
        elif t in bsdf_mod.KIND_NAMES or t in ("twosided", "mask"):
            b.add_bsdf(val)          # stand-alone, referenced by its id
        elif t in em_mod.KIND_NAMES:
            b.add_emitter(val)       # a light without a shape
        elif t == "merge":
            for k2, v2 in val.items():
                if isinstance(v2, dict) and _is_shape(v2.get("type")):
                    b.add_shape(v2, f"{key}.{k2}")
        else:
            raise NotImplementedError(
                f"scene element '{key}' of type '{t}' is not ported")
    if not b.sensors:
        b.add_sensor({"type": "perspective"})
    sensors = [{k: v for k, v in s.items() if k not in SENSOR_ARRAYS}
               for s in b.sensors]
    return scene_from_arrays(b.arrays(), sensors=sensors,
                             integrator=b.integrator, spp=b.spp,
                             sampler_kind=b.sampler_kind,
                             shape_names=b.shape_names,
                             vertex_ranges=b.vertex_ranges,
                             textures=[{"kind": t["kind"]}
                                       for t in b.textures],
                             env_texture=b.env_texture, device=device)


def _named(column: torch.Tensor) -> Tuple[int, ...]:
    """The texture indices a table column names (-1: none)."""
    return tuple(int(i) for i in torch.unique(column).tolist() if i >= 0)


def scene_from_arrays(arrays: Mapping[str, np.ndarray],
                      sensors: Sequence[Mapping[str, Any]] = (),
                      integrator: Mapping[str, Any] = None,
                      spp: int = 16, sampler_kind: str = "independent",
                      shape_names: Sequence[str] = (),
                      vertex_ranges: Sequence[Tuple[int, int]] = (),
                      textures: Sequence[Mapping[str, Any]] = (),
                      env_texture: int = -1, device=None) -> Scene:
    """Build a Scene from numpy arrays named as the reference Scene's
    fields: ``vertices``, ``normals``, ``uvs``, ``faces``, ``face_shape``,
    ``shape_bsdf``, ``shape_emitter``, ``em_faces``, the table columns
    ``bsdfs.<field>`` and ``emitters.<field>`` (every column of
    ``emitters.empty_table``), ``sensors.<i>.to_world`` and, for a batch
    sensor, ``sensors.<i>.sub_to_world``, and each texture's
    ``textures.<i>.data``, ``.color0``, ``.color1``, ``.uv_scale`` and
    ``.uv_offset``.  BSDF columns the port does not use are ignored;
    its columns that are not given take ``bsdf.empty_table``'s defaults
    (the texture columns -1).  A ``bsdfs.beckmann`` slot adds
    ``bsdf.KIND_SENTINEL_BECKMANN`` to the scene's kinds.

    ``vertex_colors`` (V, 3) is taken where it is given, zeros
    otherwise; ``face_open`` (F, 3) where it is given, else computed from
    the vertices and faces (``_open_edge_mask``); ``sph_data`` (S, 4) and
    ``sph_shape`` (S,), the analytic spheres, where they are given.

    ``sensors``: per sensor, the static fields of ``Sensor`` other than
    its arrays (kind, fov_x, near, far, width, height, rfilter,
    aperture_radius, focus_distance, sub_fov_x).
    ``textures``: per texture its static fields (``kind``: bitmap,
    checkerboard or mesh_attribute), beside its arrays.  ``env_texture``: the index of the
    envmap's bitmap among them, or -1.
    ``integrator``: the scene's integrator properties (type, max_depth,
    rr_depth).  ``shape_names`` / ``vertex_ranges``: per shape its name
    and (vertex_start, vertex_count).  ``device=None`` means the GPU; without CUDA that raises.

    The BVH of a scene of more than ``accel.BRUTE_FORCE_MAX_TRIS``
    triangles is taken from the arrays ``bvh.<field>`` (the reference
    BVH's ``bmin``, ``bmax``, ``meta``, ``order``, ``levels``, ``c4_id``,
    ``c4_cnt``, ``c4_node``) where they are given, and built otherwise."""
    device = resolve_device(device)

    def t(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    geo = {k: t(arrays[k], torch.int32 if k in (
        "faces", "face_shape", "shape_bsdf", "shape_emitter", "em_faces")
        else torch.float32) for k in GEOMETRY_FIELDS}
    bsdfs = {
        "kind": t(arrays["bsdfs.kind"], torch.int32),
        "flags": t(np.asarray(arrays["bsdfs.flags"]).astype(np.int64),
                   torch.int32),
        "twosided": t(arrays["bsdfs.twosided"], torch.bool),
        "reflectance": t(arrays["bsdfs.reflectance"], torch.float32),
    }
    # the texture slots (:152, :176, :178): the reflectance's, the blend
    # weight's and the normal or bump map's texture, -1 for none; the
    # blends' children
    n_b = len(arrays["bsdfs.kind"])

    def col(k, default, dtype):
        return t(arrays.get(f"bsdfs.{k}", default), dtype)

    bsdfs.update({k: col(k, np.full(n_b, -1), torch.int32) for k in (
        "reflectance_tex", "normal_tex", "blend_weight_tex")})
    bsdfs.update({k: col(k, np.zeros(n_b), torch.int32)
                  for k in ("blend_a", "blend_b")})
    # the colour and scalar columns of the other kinds (``models/scene.py``
    # :477-531), at ``empty_table``'s defaults where not given
    bsdfs.update({k: t(arrays[f"bsdfs.{k}"], torch.float32) for k in (
        "specular_reflectance", "specular_transmittance", "eta_c", "k_c")})
    bsdfs["diffuse_reflectance"] = col("diffuse_reflectance",
                                       np.full((n_b, 3), 0.5), torch.float32)
    bsdfs.update({k: col(k, np.full(n_b, v), torch.float32)
                  for k, v in bsdf_mod.SCALAR_DEFAULTS.items()})
    bsdfs["beckmann"] = col("beckmann", np.zeros(n_b, bool), torch.bool)
    emitters = {
        k: t(arrays[f"emitters.{k}"],
             torch.int32 if k in em_mod.INT_COLUMNS else torch.float32)
        for k in em_mod.COLUMNS}
    texs = tuple(
        tex_mod.Texture(kind=str(s["kind"]), **{
            k: t(arrays[f"textures.{i}.{k}"], torch.float32)
            for k in tex_mod.LEAF_ARRAYS if f"textures.{i}.{k}" in arrays})
        for i, s in enumerate(textures))
    for tex in texs:
        if not tex_mod.is_kind(tex.kind):
            raise NotImplementedError(
                f"texture kind '{tex.kind}' is not ported")
    bsdf_kinds = tuple(sorted({int(k) for k in arrays["bsdfs.kind"]}))
    if bool(bsdfs["beckmann"].any()):
        # the Beckmann branch is evaluated only where a slot takes it
        # (``build``, :947-951)
        bsdf_kinds += (bsdf_mod.KIND_SENTINEL_BECKMANN,)
    emitter_kinds = tuple(sorted({int(k) for k in arrays["emitters.kind"]}))
    bsdf_mod.check_kinds(bsdf_kinds)
    em_mod.check_kinds(emitter_kinds)
    sensor_objs = tuple(
        Sensor(**{k: t(arrays[f"sensors.{i}.{k}"], torch.float32)
                  for k in SENSOR_ARRAYS if f"sensors.{i}.{k}" in arrays},
               **dict(s))
        for i, s in enumerate(sensors))
    static = SceneStatic(
        shape_names=tuple(str(x) for x in shape_names),
        vertex_ranges=tuple((int(a), int(b)) for a, b in vertex_ranges),
        bsdf_kinds=bsdf_kinds, emitter_kinds=emitter_kinds,
        integrator=tuple(sorted(dict(integrator or {}).items())),
        spp=int(spp), sampler_kind=sampler_kind,
        env_texture=int(env_texture),
        bsdf_textures=_named(torch.cat([bsdfs["reflectance_tex"],
                                        bsdfs["blend_weight_tex"]])),
        normal_textures=_named(bsdfs["normal_tex"]),
        has_vertex_colors=any(x.kind == "mesh_attribute" for x in texs))
    bvh = nodes = tris = tris_k = None
    if geo["faces"].shape[0] > accel.BRUTE_FORCE_MAX_TRIS:
        if "bvh.order" in arrays:
            bvh = bvh_mod.from_arrays(
                {k: arrays[f"bvh.{k}"] for k in bvh_mod.ARRAY_FIELDS},
                device)
        else:
            bvh = bvh_mod.build(arrays["vertices"], arrays["faces"], device)
        nodes, tris, tris_k = CT.pack_bvh4(bvh, geo["vertices"],
                                           geo["faces"])
    vcol = arrays.get("vertex_colors")
    vcol = (torch.zeros_like(geo["vertices"]) if vcol is None
            else t(vcol, torch.float32))
    face_open = arrays.get("face_open")
    if face_open is None:
        face_open = _open_edge_mask(np.asarray(arrays["vertices"]),
                                    np.asarray(arrays["faces"]))
    sph = {}
    if arrays.get("sph_data") is not None:
        sph = {"sph_data": t(arrays["sph_data"], torch.float32),
               "sph_shape": t(arrays["sph_shape"], torch.int32)}
    scene = Scene(bsdfs=bsdfs, emitters=emitters, sensors=sensor_objs,
                  static=static, textures=texs, bvh=bvh, bvh_nodes=nodes,
                  bvh_tris=tris, bvh_tris_k=tris_k, vertex_colors=vcol,
                  face_open=t(face_open, torch.int8), **sph, **geo)
    if config.dtype != torch.float32:
        # a *_double variant (config.py): every float leaf in its type,
        # at this one point (:1016-1030); the BVH and its K2/K3 records
        # stay float32
        scene = scene.with_leaves({k: v.to(config.dtype)
                                   for k, v in scene.leaves().items()})
    return scene


# ===========================================================================
# traverse / SceneParameters (util.py:12-346)
# ===========================================================================

class SceneParameters:
    """Dict-like view of a scene's differentiable parameters, under the
    reference's keys: ``<shape>.vertex_positions``,
    ``<shape>.vertex_normals``, ``<shape>.bsdf.reflectance.value``,
    ``<shape>.bsdf.alpha``, ``<shape>.emitter.radiance.value``,
    ``sensor[i].to_world`` and an analytic sphere's ``<shape>.center`` and
    ``<shape>.radius`` (in place of its vertices).  Assignments are
    buffered; ``update()``
    applies them in order and returns the new Scene (also kept as
    ``self.scene``), differentiable in every value written.  It
    recomputes the smooth normals of the shapes whose positions changed,
    except those whose normals were written in the same update, and
    refits and re-packs a BVH (``Scene.set_vertices``)."""

    def __init__(self, scene: Scene):
        self.scene = scene
        self._pending: Dict[str, Any] = {}

    def _spheres(self):
        """The shape indices of the analytic spheres, by slot."""
        sph = self.scene.sph_shape
        return [] if sph is None else sph.tolist()

    def keys(self):
        ks = []
        emissive = self.scene.shape_emitter.tolist()
        spheres = self._spheres()
        for i, name in enumerate(self.scene.static.shape_names):
            ks += ([f"{name}.center", f"{name}.radius"] if i in spheres
                   else [f"{name}.vertex_positions",
                         f"{name}.vertex_normals"])
            ks += [f"{name}.bsdf.reflectance.value", f"{name}.bsdf.alpha"]
            if emissive[i] >= 0:
                ks.append(f"{name}.emitter.radiance.value")
        ks += [f"sensor[{i}].to_world" for i in range(len(self.scene.sensors))]
        return ks

    def __contains__(self, key):
        try:
            self._resolve(key)
            return True
        except KeyError:
            return False

    def _resolve(self, key: str):
        if key.startswith("sensor[") and key.endswith("].to_world"):
            return ("sensor", int(key[len("sensor["):key.index("]")]))
        name, _, rest = key.partition(".")
        try:
            idx = self.scene.static.shape_names.index(name)
        except ValueError:
            raise KeyError(key) from None
        if rest in ("center", "radius"):
            spheres = self._spheres()
            if idx not in spheres:
                raise KeyError(key)
            return ("sphere", spheres.index(idx), rest)
        if rest == "vertex_positions":
            return ("verts", idx)
        if rest == "vertex_normals":
            return ("norms", idx)
        if rest in ("bsdf.reflectance.value", "bsdf.reflectance"):
            return ("bsdf", idx, "reflectance")
        if rest == "bsdf.alpha":
            return ("bsdf", idx, "alpha")
        if rest in ("emitter.radiance.value", "emitter.radiance"):
            return ("emitter", idx, "radiance")
        raise KeyError(key)

    def __getitem__(self, key: str):
        if key in self._pending:
            return self._pending[key]
        kind = self._resolve(key)
        sc = self.scene
        if kind[0] in ("verts", "norms"):
            s, c = sc.static.vertex_ranges[kind[1]]
            arr = sc.vertices if kind[0] == "verts" else sc.normals
            return arr[s:s + c]
        if kind[0] == "bsdf":
            return sc.bsdfs[kind[2]][int(sc.shape_bsdf[kind[1]])]
        if kind[0] == "emitter":
            return sc.emitters[kind[2]][int(sc.shape_emitter[kind[1]])]
        if kind[0] == "sphere":
            row = sc.sph_data[kind[1]]
            return row[:3] if kind[2] == "center" else row[3]
        return sc.sensors[kind[1]].to_world

    def __setitem__(self, key: str, value):
        self._resolve(key)
        self._pending[key] = value

    def update(self, values: Optional[Mapping[str, Any]] = None) -> Scene:
        for k, v in (values or {}).items():
            self[k] = v
        sc = self.scene

        def as_t(value, like):
            return torch.as_tensor(value, dtype=like.dtype,
                                   device=like.device)

        def set_rows(arr, s, c, value):
            return torch.cat([arr[:s], as_t(value, arr).reshape(c, -1),
                              arr[s + c:]])

        def set_row(arr, i, value):
            return torch.cat([arr[:i], as_t(value, arr).reshape(
                (1,) + arr.shape[1:]), arr[i + 1:]])

        verts_shapes, norms_shapes = [], []
        for key, value in self._pending.items():
            kind = self._resolve(key)
            if kind[0] == "verts":
                s, c = sc.static.vertex_ranges[kind[1]]
                sc = replace(sc, vertices=set_rows(sc.vertices, s, c, value))
                verts_shapes.append(kind[1])
            elif kind[0] == "norms":
                s, c = sc.static.vertex_ranges[kind[1]]
                sc = replace(sc, normals=set_rows(sc.normals, s, c, value))
                norms_shapes.append(kind[1])
            elif kind[0] in ("bsdf", "emitter"):
                table = "bsdfs" if kind[0] == "bsdf" else "emitters"
                owner = sc.shape_bsdf if kind[0] == "bsdf" \
                    else sc.shape_emitter
                tab = dict(getattr(sc, table))
                tab[kind[2]] = set_row(tab[kind[2]], int(owner[kind[1]]),
                                       value)
                sc = replace(sc, **{table: tab})
            elif kind[0] == "sphere":
                row = sc.sph_data[kind[1]]
                val = as_t(value, row)
                row = (torch.cat([val.reshape(3), row[3:]])
                       if kind[2] == "center"
                       else torch.cat([row[:3], val.reshape(1)]))
                sc = replace(sc, sph_data=set_row(sc.sph_data, kind[1], row))
            else:
                sensors = list(sc.sensors)
                s0 = sensors[kind[1]]
                sensors[kind[1]] = replace(
                    s0, to_world=as_t(value, s0.to_world).reshape(4, 4))
                sc = replace(sc, sensors=tuple(sensors))
        if verts_shapes:
            # the moved shapes' smooth normals, differentiably
            # (mesh.cpp:85-87); a shape whose normals were written in
            # this update keeps them
            rows = torch.zeros(sc.vertices.shape[0], dtype=torch.bool,
                               device=sc.device)
            for i in set(verts_shapes) - set(norms_shapes):
                s, c = sc.static.vertex_ranges[i]
                rows[s:s + c] = True
            if bool(rows.any()):
                sc = nrm_mod.refresh_smooth_normals(sc, rows)
            sc = sc.set_vertices(sc.vertices)
        self._pending = {}
        self.scene = sc
        return sc


def traverse(scene: Scene) -> SceneParameters:
    """mi.traverse: the scene's parameters under the reference's keys."""
    return SceneParameters(scene)
