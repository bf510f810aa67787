"""Mitsuba XML scenes (counterpart of ``core/xmlparse.py``, the
reference's src/core/xml.cpp).

The XML dialect is parsed into the nested-dict scene description that
``load_dict`` takes, in the reference's two stages (``parse_xml``
xml.cpp:431 builds the properties; ``instantiate_node`` :1067 the
objects).  Supported:

 * ``<scene version=...>`` and nested plugin tags (integrator, sensor,
   film, sampler, bsdf, shape, emitter, texture, rfilter, phase, medium,
   volume);
 * value tags: float, integer, boolean, string, point, vector, rgb,
   spectrum;
 * ``<transform name="to_world">`` with translate, rotate, scale, matrix
   and lookat, each applied after the ones before it;
 * ``<ref id=...>``, ``<alias>``, ``<default name=.. value=..>`` and
   ``$name`` substitution (xml.cpp's ``$`` handling, the CLI's -D);
 * ``<include filename=...>``;
 * the legacy upgrades of scenes older than version 2 (xml.cpp:338-430).

A ``filename`` string is resolved against the directory of the XML
that names it.
"""
from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from typing import Dict, Optional

import numpy as np

from .transform import ScalarTransform4f

_PLUGIN_TAGS = {
    "integrator", "sensor", "film", "sampler", "bsdf", "shape", "emitter",
    "texture", "rfilter", "phase", "medium", "volume", "spectrum_plugin",
}


def _subst(text: str, params: Dict[str, str]) -> str:
    """$name parameter substitution (xml.cpp:200-230)."""
    if "$" not in text:
        return text

    def repl(mm):
        key = mm.group(1)
        if key not in params:
            raise ValueError(f"undefined scene parameter ${key}")
        return str(params[key])

    return re.sub(r"\$(\w+)", repl, text)


def _floats(s: str):
    return [float(x) for x in re.split(r"[,\s]+", s.strip()) if x]


def _parse_transform(elem, params) -> ScalarTransform4f:
    """The ops of a ``<transform>``, each multiplied on from the left."""
    t = ScalarTransform4f()

    def then(mat):
        return ScalarTransform4f(np.asarray(mat) @ np.asarray(t.matrix))

    for child in elem:
        tag = child.tag

        def g(k, d=None):
            v = child.get(k)
            return _subst(v, params) if v is not None else d

        if tag == "translate":
            v = [float(g("x", 0)), float(g("y", 0)), float(g("z", 0))]
            if g("value"):
                v = _floats(g("value"))
            t = then(ScalarTransform4f().translate(v).matrix)
        elif tag == "scale":
            if g("value"):
                vals = _floats(g("value"))
                v = vals * 3 if len(vals) == 1 else vals
            else:
                v = [float(g("x", 1)), float(g("y", 1)), float(g("z", 1))]
            t = then(ScalarTransform4f().scale(v).matrix)
        elif tag == "rotate":
            axis = [float(g("x", 0)), float(g("y", 0)), float(g("z", 0))]
            t = then(ScalarTransform4f().rotate(axis,
                                                float(g("angle", 0))).matrix)
        elif tag == "matrix":
            mat = np.asarray(_floats(g("value")), np.float32)
            mat = mat.reshape(4, 4) if mat.size == 16 else _mat3_to4(mat)
            t = then(mat)
        elif tag in ("lookat", "look_at"):
            t = then(ScalarTransform4f().look_at(
                _floats(g("origin")), _floats(g("target")),
                _floats(g("up", "0, 1, 0"))).matrix)
        else:
            raise ValueError(f"unknown transform op <{tag}>")
    return t


def _mat3_to4(m):
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = m.reshape(3, 3)
    return out


def _parse_value(child, params):
    tag = child.tag
    val = child.get("value")
    if val is not None:
        val = _subst(val, params)
    if tag == "float":
        return float(val)
    if tag == "integer":
        return int(val)
    if tag == "boolean":
        return val.lower() == "true"
    if tag == "string":
        return val
    if tag in ("point", "vector"):
        if val is not None:
            return _floats(val)
        return [float(_subst(child.get(k, "0"), params)) for k in "xyz"]
    if tag == "rgb":
        v = _floats(val)
        return {"type": "rgb", "value": v if len(v) == 3 else v[0]}
    if tag == "spectrum":
        # a uniform value or a wavelength:value list
        if ":" in val:
            pairs = [p.split(":") for p in re.split(r"[,\s]+", val) if p]
            return {"type": "irregular",
                    "wavelengths": [float(p[0]) for p in pairs],
                    "values": [float(p[1]) for p in pairs]}
        return {"type": "uniform", "value": float(val)}
    raise ValueError(f"unknown value tag <{tag}>")


def parse_element(elem, params, base_dir, id_map) -> Dict:
    """A plugin element as a nested dict (xml.cpp parse_xml:431)."""
    d = {"type": _subst(elem.get("type", ""), params)}
    if elem.get("id"):
        d["id"] = elem.get("id")
    anon = 0
    for child in elem:
        tag = child.tag
        name = child.get("name")
        if tag == "transform":
            d[name or "to_world"] = _parse_transform(child, params)
        elif tag == "ref":
            d[name or f"_ref{anon}"] = {"type": "ref", "id": child.get("id")}
            anon += 1
        elif tag in _PLUGIN_TAGS:
            sub = parse_element(child, params, base_dir, id_map)
            key = name or tag
            if key in d:
                key = f"{tag}{anon}"
            d[key] = sub
            anon += 1
            if "id" in sub:
                id_map[sub["id"]] = sub
        elif tag == "default":
            params.setdefault(child.get("name"), child.get("value"))
        else:
            value = _parse_value(child, params)
            if tag == "string" and name == "filename":
                value = value if os.path.isabs(value) else os.path.join(
                    base_dir, value)
            d[name] = value
    return d


def _camel_to_underscore(name: str) -> str:
    out = []
    i = 0
    while i < len(name):
        c = name[i]
        if i + 1 < len(name) and c.islower() and name[i + 1].isupper():
            out.append(c)
            out.append("_")
            i += 1
            while i < len(name) and name[i].isupper():
                out.append(name[i].lower())
                i += 1
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _upgrade_tree(root, version: str):
    """Legacy upgrades (xml.cpp:338-430 ``upgrade_tree``): a scene of a
    version below 2.0 gets camelCase property names in underscore_case,
    ``<lookAt>`` as ``<lookat>``, a diffuse BSDF's
    ``diffuse_reflectance`` as ``reflectance``, and the old
    ``uoffset``/``voffset``/``uscale``/``vscale`` floats as per-axis
    ``uv_scale_*``/``uv_offset_*`` properties."""
    try:
        major = int(str(version).split(".")[0])
    except (ValueError, AttributeError):
        return
    if major >= 2:
        return
    for n in root.iter():
        if n.tag == "lookAt":
            n.tag = "lookat"
        if n.tag == "default":
            continue
        name = n.get("name")
        if name:
            n.set("name", _camel_to_underscore(name))
    for b in root.iter("bsdf"):
        if b.get("type") == "diffuse":
            for c in b:
                if c.get("name") == "diffuse_reflectance":
                    c.set("name", "reflectance")
    # uoffset/voffset/uscale/vscale -> the to_uv transform's per-axis
    # scale and offset (xml.cpp:379-410)
    for n in root.iter():
        uv = {c.get("name"): c for c in list(n)
              if c.tag == "float" and c.get("name") in
              ("uoffset", "voffset", "uscale", "vscale")}
        if not uv:
            continue
        for c in uv.values():
            n.remove(c)

        def val(key, default):
            c = uv.get(key)
            return c.get("value") if c is not None else default

        for prop, key, default in (("uv_scale_x", "uscale", "1"),
                                   ("uv_scale_y", "vscale", "1"),
                                   ("uv_offset_x", "uoffset", "0"),
                                   ("uv_offset_y", "voffset", "0")):
            ET.SubElement(n, "float", {"name": prop,
                                       "value": val(key, default)})


def parse_string(text: str, parameters: Optional[Dict[str, str]] = None,
                 base_dir: str = "."):
    """XML text -> the scene dict ``load_dict`` takes (or, for a root
    that is no ``<scene>``, that plugin's dict)."""
    params = dict(parameters or {})
    root = ET.fromstring(text)
    if root.get("version"):
        _upgrade_tree(root, root.get("version"))
    id_map: Dict[str, Dict] = {}
    if root.tag != "scene":
        return parse_element(root, params, base_dir, id_map)

    d = {"type": "scene"}
    anon = 0
    for child in root:
        if child.tag == "default":
            params.setdefault(child.get("name"), child.get("value"))
            continue
        if child.tag == "include":
            fn = os.path.join(base_dir, child.get("filename"))
            with open(fn) as f:
                sub = ET.fromstring(f.read())
            for sc in sub:
                cd = parse_element(sc, params, os.path.dirname(fn), id_map)
                d[cd.get("id") or f"_elem{anon}"] = cd
                anon += 1
            continue
        if child.tag in _PLUGIN_TAGS:
            cd = parse_element(child, params, base_dir, id_map)
            key = cd.get("id") or child.get("name") or f"_elem{anon}"
            d[key] = cd
            anon += 1
            if "id" in cd:
                id_map[cd["id"]] = cd
        elif child.tag == "alias":
            id_map[child.get("as")] = id_map[child.get("id")]
        else:
            raise ValueError(f"unexpected top-level tag <{child.tag}>")
    return d


def load_string(text: str, parameters: Optional[Dict[str, str]] = None,
                base_dir: str = ".", device=None):
    """mi.load_string: XML text -> Scene (a plugin's dict for a root that
    is no ``<scene>``).  ``device=None`` means the GPU; without CUDA that
    raises."""
    from ..models.scene import load_dict
    d = parse_string(text, parameters, base_dir)
    if d.get("type") != "scene":
        return d
    return load_dict(d, device=device)


def load_file(path: str, parameters: Optional[Dict[str, str]] = None,
              device=None):
    """mi.load_file (xml.cpp:1016): the scene of the XML file ``path``,
    its file names resolved against the file's directory.
    ``device=None`` means the GPU; without CUDA that raises."""
    with open(path) as f:
        text = f.read()
    return load_string(text, parameters,
                       os.path.dirname(os.path.abspath(path)), device)
