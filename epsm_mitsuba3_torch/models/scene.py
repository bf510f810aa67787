"""Scene container, Mitsuba-style dict loader and the array interface
(counterpart of ``models/scene.py``).

Geometry is one flat set of arrays (all meshes concatenated); structure
(kinds present, integrator settings, film sizes) is static metadata.
``load_dict`` takes the subset of the reference schema that the port's
scenes use: ``rectangle``/``cube`` shapes and in-memory ``mesh`` shapes,
``diffuse`` (optionally ``twosided``), ``area``, ``perspective``,
``independent``, ``hdrfilm`` with a ``box`` filter, and the ``path``
integrator.  A scene of more than ``ops/accel.py``
``BRUTE_FORCE_MAX_TRIS`` triangles gets a BVH at load, packed once into
the records of kernels K2/K3.

``scene_from_arrays`` builds a scene from numpy arrays under the JAX
``Scene``'s field names: it carries the scene state between the two
packages, so that both render the very same scene.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.transform import ScalarTransform4f
from ..ops import accel
from ..ops import bvh as bvh_mod
from ..ops import cuda_traverse as CT
from . import bsdf as bsdf_mod
from . import emitters as em_mod
from . import shapes as shapes_mod
from .records import Ray, RayFlags
from .sensors import Sensor

#: per-vertex / per-face / per-shape arrays of the reference Scene
GEOMETRY_FIELDS = ("vertices", "normals", "uvs", "faces", "face_shape",
                   "shape_bsdf", "shape_emitter", "em_faces")


@dataclass(frozen=True)
class SceneStatic:
    bsdf_kinds: Tuple[int, ...] = ()
    emitter_kinds: Tuple[int, ...] = ()
    integrator: Tuple[Tuple[str, Any], ...] = ()
    spp: int = 16
    sampler_kind: str = "independent"


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
    #: BVH above ``accel.BRUTE_FORCE_MAX_TRIS`` triangles, else None
    bvh: Optional[bvh_mod.BVH] = None
    #: its K2/K3 inputs (``cuda_traverse.pack_bvh4``): node records
    #: (n4, 32), leaf-ordered triangles (F, 9), and the same triangles in
    #: the layout the K2/K3 kernels read
    bvh_nodes: Optional[torch.Tensor] = None
    bvh_tris: Optional[torch.Tensor] = None
    bvh_tris_k: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    # -- differentiable state (ad/prb.py split_scene / merge_scene) ---------
    def leaves(self) -> Dict[str, torch.Tensor]:
        """The differentiable leaves by name: every float tensor of the
        scene state, i.e. the float geometry fields, the float columns of
        the BSDF and emitter tables (``bsdfs.<k>``, ``emitters.<k>``) and
        each sensor's ``sensors.<i>.to_world``.  The BVH and its packed
        records derive from the vertices and are no leaves."""
        out = {k: getattr(self, k) for k in GEOMETRY_FIELDS
               if getattr(self, k).is_floating_point()}
        for prefix in ("bsdfs", "emitters"):
            out.update({f"{prefix}.{k}": v
                        for k, v in getattr(self, prefix).items()
                        if v.is_floating_point()})
        for i, sensor in enumerate(self.sensors):
            out[f"sensors.{i}.to_world"] = sensor.to_world
        return out

    def with_leaves(self, leaves: Mapping[str, torch.Tensor]) -> "Scene":
        """This scene with the named leaves replaced, values unchanged:
        the BVH is kept as it is (a vertex edit goes through
        ``set_vertices``)."""
        kw = {k: v for k, v in leaves.items() if k in GEOMETRY_FIELDS}
        for prefix in ("bsdfs", "emitters"):
            table = dict(getattr(self, prefix))
            table.update({k.split(".", 1)[1]: v for k, v in leaves.items()
                          if k.startswith(prefix + ".")})
            kw[prefix] = table
        kw["sensors"] = tuple(
            replace(s, to_world=leaves.get(f"sensors.{i}.to_world",
                                           s.to_world))
            for i, s in enumerate(self.sensors))
        return replace(self, **kw)

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
        v = vertices.detach()
        bvh = bvh_mod.refit(sc.bvh, v, sc.faces)
        nodes, tris, tris_k = CT.pack_bvh4(bvh, v, sc.faces)
        return replace(sc, bvh=bvh, bvh_nodes=nodes, bvh_tris=tris,
                       bvh_tris_k=tris_k)

    # -- ray queries (scene.cpp:116-142) ------------------------------------
    def ray_intersect_preliminary(self, ray: Ray,
                                  multi_pop: Optional[int] = None):
        return accel.ray_intersect(self, ray, multi_pop=multi_pop)

    def ray_intersect(self, ray: Ray, ray_flags: int = RayFlags.All):
        from ..ops import intersect as I
        pi = self.ray_intersect_preliminary(ray)
        return I.compute_surface_interaction(self, ray, pi, ray_flags)

    def ray_test(self, ray: Ray):
        return accel.ray_test(self, ray)


# ===========================================================================
# Dict loader (mi.load_dict subset)
# ===========================================================================

_SHAPE_FNS = {"rectangle": shapes_mod.rectangle, "cube": shapes_mod.cube}
_SENSOR_TYPES = ("perspective",)
_INTEGRATOR_TYPES = ("path",)


def _rgb(value, default=(1.0, 1.0, 1.0)):
    """Parse a colour: scalar | [r, g, b] | {'type': 'rgb', 'value': ...}."""
    if value is None:
        return np.asarray(default, np.float32)
    if isinstance(value, dict):
        t = value.get("type", "rgb")
        if t not in ("rgb", "srgb", "d65", "uniform"):
            raise NotImplementedError(f"spectrum type '{t}' is not ported")
        return _rgb(value.get("value", value.get("color", default)))
    arr = np.asarray(value, np.float32)
    if arr.ndim == 0:
        arr = np.full((3,), float(arr), np.float32)
    return arr.reshape(3)


def _transform(value) -> np.ndarray:
    if value is None:
        return np.eye(4, dtype=np.float32)
    if isinstance(value, ScalarTransform4f):
        return np.asarray(value.matrix, np.float32)
    return np.asarray(value, np.float32).reshape(4, 4)


class _Builder:
    def __init__(self):
        self.vertices, self.normals, self.uvs, self.faces = [], [], [], []
        self.face_shape, self.shape_bsdf, self.shape_emitter = [], [], []
        self.bsdf_rows = []
        self.em_rows, self.em_shape, self.em_face_list = [], [], []
        self.sensors = []
        self.integrator = {"type": "path", "max_depth": 6, "rr_depth": 5}
        self.spp = 16
        self.sampler_kind = "independent"
        self._v_off = 0
        self._f_off = 0

    # -- BSDFs (_Builder.add_bsdf) ------------------------------------------
    def add_bsdf(self, d: dict) -> int:
        twosided = False
        p = d
        while p.get("type") == "twosided":
            twosided = True
            p = next((v for v in p.values() if isinstance(v, dict)), None)
            if p is None:
                raise ValueError("twosided bsdf without nested material")
        kind_name = p.get("type")
        if kind_name not in bsdf_mod.KIND_NAMES:
            raise NotImplementedError(f"bsdf type '{kind_name}' is not ported")
        kind = bsdf_mod.KIND_NAMES[kind_name]
        self.bsdf_rows.append({
            "kind": kind,
            "flags": bsdf_mod.KIND_FLAGS[kind]
            | (bsdf_mod.BSDFFlags.BackSide if twosided else 0),
            "twosided": twosided,
            "reflectance": _rgb(p.get("reflectance"), (0.5, 0.5, 0.5)),
        })
        return len(self.bsdf_rows) - 1

    # -- emitters (_Builder.add_emitter) ------------------------------------
    def add_emitter(self, d: dict, shape_index: int) -> int:
        t = d["type"]
        if t not in em_mod.KIND_NAMES:
            raise NotImplementedError(f"emitter type '{t}' is not ported")
        self.em_rows.append({
            "kind": em_mod.KIND_NAMES[t],
            "radiance": _rgb(d.get("radiance")) * float(d.get("scale", 1.0)),
            "shape_index": shape_index,
        })
        return len(self.em_rows) - 1

    # -- shapes (_Builder.add_shape) ----------------------------------------
    def add_shape(self, d: dict):
        t = d["type"]
        if t == "mesh":
            # raw in-memory mesh: vertex and face arrays
            mesh = {"vertices": np.asarray(d["vertices"], np.float32),
                    "faces": np.asarray(d["faces"], np.int32)}
            for k in ("normals", "uvs"):
                if k in d:
                    mesh[k] = np.asarray(d[k], np.float32)
        else:
            mesh = _SHAPE_FNS[t]()
        to_world = _transform(d.get("to_world"))
        v = mesh["vertices"]
        vh = np.concatenate([v, np.ones((len(v), 1), np.float32)], -1)
        v = (vh @ to_world.T)[:, :3]
        n = mesh.get("normals")
        if n is None or bool(d.get("face_normals", False)):
            n = np.zeros_like(v)     # zero rows: the face normal at a hit
        else:
            n = n @ np.linalg.inv(to_world[:3, :3])
            n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                               1e-20)
        uv = mesh.get("uvs")
        if uv is None:
            uv = np.zeros((len(v), 2), np.float32)
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
            if key == "emitter" or vt in em_mod.KIND_NAMES:
                em_idx = self.add_emitter(val, shape_index)
            elif key == "bsdf" or vt == "twosided" \
                    or vt in bsdf_mod.KIND_NAMES:
                bsdf_idx = self.add_bsdf(val)
            else:
                raise NotImplementedError(
                    f"shape child '{key}' of type '{vt}' is not ported")
        if bsdf_idx < 0:
            bsdf_idx = self.add_bsdf({"type": "diffuse"})

        nf, nv = len(f), len(v)
        self.shape_bsdf.append(bsdf_idx)
        self.shape_emitter.append(em_idx)
        self.vertices.append(v.astype(np.float32))
        self.normals.append(n.astype(np.float32))
        self.uvs.append(uv.astype(np.float32))
        self.faces.append((f + self._v_off).astype(np.int32))
        self.face_shape.append(np.full((nf,), shape_index, np.int32))
        if em_idx >= 0:
            self.em_shape.append(em_idx)
            self.em_face_list.append(
                np.arange(self._f_off, self._f_off + nf, dtype=np.int32))
        self._v_off += nv
        self._f_off += nf

    # -- sensor (_Builder.add_sensor) ---------------------------------------
    def add_sensor(self, d: dict):
        film = d.get("film", {})
        if film.get("type", "hdrfilm") != "hdrfilm":
            raise NotImplementedError(f"film '{film['type']}' is not ported")
        sampler = d.get("sampler", {})
        rf = film.get("rfilter", {})
        rfk = rf.get("type", "gaussian") if isinstance(rf, dict) else str(rf)
        self.spp = int(sampler.get("sample_count", self.spp))
        self.sampler_kind = sampler.get("type", self.sampler_kind)
        self.sensors.append(dict(
            to_world=_transform(d.get("to_world")),
            kind=d.get("type", "perspective"),
            fov_x=float(d.get("fov", 45.0)),
            width=int(film.get("width", 256)),
            height=int(film.get("height", 256)),
            rfilter=rfk))

    def arrays(self) -> Dict[str, np.ndarray]:
        """The scene state under the reference Scene's field names."""
        if not self.shape_bsdf:
            raise ValueError("scene has no shapes")
        if not self.em_rows:
            raise NotImplementedError(
                "a scene without an area emitter is not ported")
        out = {
            "vertices": np.concatenate(self.vertices),
            "normals": np.concatenate(self.normals),
            "uvs": np.concatenate(self.uvs),
            "faces": np.concatenate(self.faces),
            "face_shape": np.concatenate(self.face_shape),
            "shape_bsdf": np.asarray(self.shape_bsdf, np.int32),
            "shape_emitter": np.asarray(self.shape_emitter, np.int32),
        }
        tmax = max(len(x) for x in self.em_face_list)
        em_faces = np.full((len(self.em_rows), tmax), -1, np.int32)
        for em_idx, face_ids in zip(self.em_shape, self.em_face_list):
            em_faces[em_idx, :len(face_ids)] = face_ids
        out["em_faces"] = em_faces
        for prefix, rows in (("bsdfs", self.bsdf_rows),
                             ("emitters", self.em_rows)):
            for k in rows[0]:
                out[f"{prefix}.{k}"] = np.asarray([r[k] for r in rows])
        for i, s in enumerate(self.sensors):
            out[f"sensors.{i}.to_world"] = s["to_world"]
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
        if t in _SENSOR_TYPES:
            b.add_sensor(val)
        elif t in _INTEGRATOR_TYPES:
            b.integrator = dict(val)
        elif t in _SHAPE_FNS or t == "mesh":
            b.add_shape(val)
        else:
            raise NotImplementedError(
                f"scene element '{key}' of type '{t}' is not ported")
    if not b.sensors:
        b.add_sensor({"type": "perspective"})
    sensors = [{k: v for k, v in s.items() if k != "to_world"}
               for s in b.sensors]
    return scene_from_arrays(b.arrays(), sensors=sensors,
                             integrator=b.integrator, spp=b.spp,
                             sampler_kind=b.sampler_kind, device=device)


def scene_from_arrays(arrays: Mapping[str, np.ndarray],
                      sensors: Sequence[Mapping[str, Any]] = (),
                      integrator: Mapping[str, Any] = None,
                      spp: int = 16, sampler_kind: str = "independent",
                      device=None) -> Scene:
    """Build a Scene from numpy arrays named as the reference Scene's
    fields: ``vertices``, ``normals``, ``uvs``, ``faces``, ``face_shape``,
    ``shape_bsdf``, ``shape_emitter``, ``em_faces``, the table columns
    ``bsdfs.<field>`` and ``emitters.<field>``, and ``sensors.<i>.to_world``.
    Table columns the port does not use are ignored.

    ``sensors``: per sensor, the static fields of ``Sensor`` other than
    ``to_world`` (kind, fov_x, width, height, rfilter, ...).
    ``integrator``: the scene's integrator properties (type, max_depth,
    rr_depth).  ``device=None`` means the GPU; without CUDA that raises.

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
    emitters = {
        "kind": t(arrays["emitters.kind"], torch.int32),
        "radiance": t(arrays["emitters.radiance"], torch.float32),
        "shape_index": t(arrays["emitters.shape_index"], torch.int32),
    }
    bsdf_kinds = tuple(sorted({int(k) for k in arrays["bsdfs.kind"]}))
    emitter_kinds = tuple(sorted({int(k) for k in arrays["emitters.kind"]}))
    bsdf_mod.check_kinds(bsdf_kinds)
    em_mod.check_kinds(emitter_kinds)
    sensor_objs = tuple(
        Sensor(to_world=t(arrays[f"sensors.{i}.to_world"], torch.float32),
               **dict(s))
        for i, s in enumerate(sensors))
    static = SceneStatic(
        bsdf_kinds=bsdf_kinds, emitter_kinds=emitter_kinds,
        integrator=tuple(sorted(dict(integrator or {}).items())),
        spp=int(spp), sampler_kind=sampler_kind)
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
    return Scene(bsdfs=bsdfs, emitters=emitters, sensors=sensor_objs,
                 static=static, bvh=bvh, bvh_nodes=nodes, bvh_tris=tris,
                 bvh_tris_k=tris_k, **geo)
