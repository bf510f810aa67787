"""Scene dict -> Mitsuba XML (counterpart of ``utils/xmlwrite.py``, the
reference's src/python/python/xml.py): a scene built in code, written
out as scene XML.

Beyond the reference's writer, a ``mesh_attribute`` texture is written
as a texture, the ``normalmap`` and ``bumpmap`` wrappers as BSDFs, and a
``regular`` or ``irregular`` spectrum as a ``<spectrum>`` value tag of
``lam:v`` pairs (its ``scale`` multiplied into the values), which the
parser reads back as an ``irregular`` spectrum."""
from __future__ import annotations

import numpy as np

_PLUGIN_CATEGORY = {
    "perspective": "sensor", "thinlens": "sensor", "orthographic": "sensor",
    "distant": "sensor", "radiancemeter": "sensor",
    "irradiancemeter": "sensor", "batch": "sensor",
    "hdrfilm": "film", "specfilm": "film",
    "independent": "sampler", "stratified": "sampler",
    "multijitter": "sampler", "orthogonal": "sampler",
    "ldsampler": "sampler",
    "box": "rfilter", "tent": "rfilter", "gaussian": "rfilter",
    "mitchell": "rfilter", "catmullrom": "rfilter", "lanczos": "rfilter",
    "path": "integrator", "prb": "integrator", "direct": "integrator",
    "aov": "integrator", "moment": "integrator", "volpath": "integrator",
    "manifold": "integrator", "manifold_caustic": "integrator",
    "area": "emitter", "point": "emitter", "constant": "emitter",
    "envmap": "emitter", "directional": "emitter", "spot": "emitter",
    "obj": "shape", "ply": "shape", "rectangle": "shape", "cube": "shape",
    "sphere": "shape", "disk": "shape", "cylinder": "shape",
    "diffuse": "bsdf", "conductor": "bsdf", "roughconductor": "bsdf",
    "dielectric": "bsdf", "thindielectric": "bsdf",
    "roughdielectric": "bsdf", "plastic": "bsdf", "roughplastic": "bsdf",
    "twosided": "bsdf", "null": "bsdf", "principled": "bsdf",
    "blendbsdf": "bsdf", "mask": "bsdf", "pplastic": "bsdf",
    "principledthin": "bsdf", "normalmap": "bsdf", "bumpmap": "bsdf",
    "bitmap": "texture", "checkerboard": "texture",
    "mesh_attribute": "texture",
    "homogeneous": "medium", "heterogeneous": "medium",
    "isotropic": "phase", "hg": "phase",
}


def _emit(name, value, indent):
    pad = "    " * indent
    if isinstance(value, bool):
        return f'{pad}<boolean name="{name}" value="{str(value).lower()}"/>'
    if isinstance(value, int):
        return f'{pad}<integer name="{name}" value="{value}"/>'
    if isinstance(value, float):
        return f'{pad}<float name="{name}" value="{value}"/>'
    if isinstance(value, str):
        return f'{pad}<string name="{name}" value="{value}"/>'
    raise ValueError(f"cannot serialize {name}={value!r}")


def _spectrum_pairs(d) -> str:
    """A tabulated spectrum as the ``lam:v, ...`` text of a
    ``<spectrum>`` tag."""
    from ..models.scene import _parse_spd
    lams, vals = _parse_spd(d)
    vals = vals * float(d.get("scale", 1.0))
    return ", ".join(f"{float(a)!r}:{float(b)!r}" for a, b in zip(lams, vals))


def _emit_dict(name, d, indent, lines):
    pad = "    " * indent
    t = d.get("type")
    if t == "rgb":
        v = d.get("value", 1.0)
        if isinstance(v, (list, tuple, np.ndarray)):
            v = ", ".join(str(float(x)) for x in np.asarray(v).ravel())
        lines.append(f'{pad}<rgb name="{name}" value="{v}"/>')
        return
    if t == "ref":
        lines.append(f'{pad}<ref id="{d["id"]}"/>')
        return
    if t in ("regular", "irregular"):
        lines.append(f'{pad}<spectrum name="{name}" '
                     f'value="{_spectrum_pairs(d)}"/>')
        return
    cat = _PLUGIN_CATEGORY.get(t, "bsdf")
    attrs = f' name="{name}"' if cat == "texture" else ""
    idattr = f' id="{d["id"]}"' if "id" in d else ""
    lines.append(f'{pad}<{cat} type="{t}"{idattr}{attrs}>')
    for k, v in d.items():
        if k in ("type", "id"):
            continue
        if k == "to_world" or hasattr(v, "matrix"):
            mat = np.asarray(getattr(v, "matrix", v)).reshape(4, 4)
            vals = " ".join(str(float(x)) for x in mat.ravel())
            lines.append(f'{pad}    <transform name="{k}">')
            lines.append(f'{pad}        <matrix value="{vals}"/>')
            lines.append(f'{pad}    </transform>')
        elif isinstance(v, dict):
            _emit_dict(k, v, indent + 1, lines)
        elif isinstance(v, (list, tuple, np.ndarray)):
            vals = ", ".join(str(float(x)) for x in np.asarray(v).ravel())
            lines.append(f'{pad}    <rgb name="{k}" value="{vals}"/>')
        else:
            lines.append(_emit(k, v, indent + 1))
    lines.append(f"{pad}</{cat}>")


def dict_to_xml(scene_dict: dict, path: str = None) -> str:
    """mi.xml.dict_to_xml: the XML text of ``scene_dict``, also written
    to ``path`` where one is given."""
    if scene_dict.get("type") != "scene":
        raise ValueError("top-level dict must have type 'scene'")
    lines = ['<scene version="3.0.0">']
    for k, v in scene_dict.items():
        if k == "type" or not isinstance(v, dict):
            continue
        _emit_dict(k, v, 1, lines)
    lines.append("</scene>")
    out = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            f.write(out)
    return out
