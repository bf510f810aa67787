"""Scenes lit by each emitter kind, loaded and rendered by the port
against the JAX package: ``load_dict`` of the Cornell box with a light of
each kind beside (or instead of) its area light, an envmap and a
projector's bitmap written to ``tmp_path``, and a scene with no emitter,
each against JAX's arrays; ``path`` renders of each at 16^2 x 4 spp, the
JAX scene carried across by ``scene_from_arrays``; and the no-emitter
scene's exact zeros.  The environment's MIS reading emitter row 0 is in
``test_torch_prb_emitters.py``.

Tolerances: arrays bit for bit; images ``assert_images_close`` of
``test_torch_render.py`` (mean |diff| <= 1e-4, >= 99 % of pixels within
1e-4: XLA and PyTorch round some operations differently, and a grazing
hit that flips changes one path of a pixel); the no-emitter image exactly
0 in both packages.
"""
import os

import numpy as np
import pytest

import epsm_mitsuba3_tpu as mi
from scenes import cornell_box as cornell_box_jax

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.core.bitmap import write_image
from epsm_mitsuba3_torch.models import emitters as ET
from epsm_mitsuba3_torch.models import textures as TT
from epsm_mitsuba3_torch.models.scene import GEOMETRY_FIELDS

from test_torch_render import assert_images_close, jax_arrays, port_scene_of
from torch_threads import one_torch_thread  # noqa: F401

RES, SPP, DEPTH = 16, 4, 3


def plain(d):
    """``d`` with every transform object replaced by its 4x4 matrix, so
    that both packages' loaders read the same dict."""
    if isinstance(d, dict):
        return {k: plain(v) for k, v in d.items()}
    if hasattr(d, "matrix"):
        return np.asarray(d.matrix, np.float32)
    return d


def lights(tmp):
    """One light of each kind (projector twice: a checkerboard and a
    bitmap), its files written to ``tmp`` from a numpy seed."""
    r = np.random.default_rng(11)
    env = (r.random((16, 32, 3)) ** 4 * 4).astype(np.float32)
    write_image(os.path.join(tmp, "sky.exr"), env)
    write_image(os.path.join(tmp, "slide.pfm"),
                r.random((6, 10, 3)).astype(np.float32))
    T = mi.ScalarTransform4f
    proj = T.look_at(origin=[0, 1, 2.5], target=[0, 1, -1], up=[0, 1, 0])
    return {
        "point": {"type": "point", "position": [0.2, 1.5, 0.3],
                  "intensity": {"type": "rgb", "value": [3.0, 2.0, 1.0]}},
        "spot": {"type": "spot", "to_world": T.look_at(
            origin=[0, 1.8, 0.2], target=[0, 0, 0], up=[0, 0, 1]),
            "intensity": 5.0, "cutoff_angle": 30.0},
        "directional": {"type": "directional",
                        "direction": [0.1, -0.5, -1.0], "irradiance": 2.0},
        "constant": {"type": "constant",
                     "radiance": {"type": "rgb", "value": 0.5}},
        "envmap": {"type": "envmap", "filename": os.path.join(tmp, "sky.exr"),
                   "scale": 0.7},
        "projector": {"type": "projector", "to_world": proj, "fov": 40.0,
                      "scale": 10.0, "irradiance": {
                          "type": "checkerboard", "color0": [1, 0.1, 0.1],
                          "color1": [0.1, 0.1, 1], "uv_scale": 4.0}},
        "projector bitmap": {"type": "projector", "to_world": proj,
                             "fov": 40.0, "scale": 10.0, "irradiance": {
                                 "type": "bitmap", "uv_offset": [0.1, 0.0],
                                 "filename": os.path.join(tmp,
                                                          "slide.pfm")}},
    }


CASES = ("area", "point", "spot", "directional", "constant", "envmap",
         "projector", "projector bitmap", "directionalarea", "no emitter",
         "constant only")


def case_dict(case, tmp, res=RES, spp=SPP, max_depth=DEPTH):
    """The JAX package's Cornell box with the light of ``case``."""
    d = cornell_box_jax(res=res, spp=spp, max_depth=max_depth)
    if case == "directionalarea":
        d["light"]["emitter"]["type"] = "directionalarea"
    elif case == "no emitter":
        del d["light"]
    elif case == "constant only":
        del d["light"]
        d["sky"] = lights(tmp)["constant"]
    elif case != "area":
        d["extra"] = lights(tmp)[case]
    return d


def _assert_arrays_equal(st, sj):
    ref = jax_arrays(sj)
    for k in GEOMETRY_FIELDS:
        np.testing.assert_array_equal(getattr(st, k).numpy(), ref[k], k)
    assert set(st.emitters) == set(sj.emitters)
    for k, v in st.emitters.items():
        np.testing.assert_array_equal(v.numpy(), ref[f"emitters.{k}"], k)
    assert len(st.textures) == len(sj.textures)
    for i, (a, b) in enumerate(zip(st.textures, sj.textures)):
        assert a.kind == b.kind
        for k in TT.ARRAYS:
            np.testing.assert_array_equal(getattr(a, k).numpy(),
                                          np.asarray(getattr(b, k)),
                                          f"textures.{i}.{k}")
    assert st.static.emitter_kinds == sj.static.emitter_kinds
    assert st.static.env_texture == sj.static.env_texture


@pytest.mark.parametrize("case", CASES)
def test_load_dict_equals_jax(case, tmp_path):
    """The port's own loader builds JAX's arrays for every kind: the
    table's every column, the padded emitter faces, the textures and the
    envmap's index; no emitter gives one constant-black row."""
    d = case_dict(case, str(tmp_path))
    sj = mi.load_dict(d)
    st = mt.load_dict(plain(d), device="cpu")
    _assert_arrays_equal(st, sj)
    if case == "no emitter":
        assert st.static.emitter_kinds == (ET.KIND_CONSTANT,)
        assert float(st.emitters["radiance"].abs().max()) == 0.0


def test_shapeless_emitters_at_top_level(tmp_path):
    """Every kind at once, as top-level elements beside the box's light,
    with a ``to_world`` instead of ``position``/``direction``."""
    d = cornell_box_jax(res=RES, spp=SPP, max_depth=DEPTH)
    T = mi.ScalarTransform4f
    for i, (k, v) in enumerate(lights(str(tmp_path)).items()):
        d[f"l{i}"] = v
    d["aimed"] = {"type": "spot", "to_world": T.translate([0.1, 1.7, 0.0])
                  .rotate([1, 0, 0], 90), "beam_width": 10.0}
    sj = mi.load_dict(d)
    st = mt.load_dict(plain(d), device="cpu")
    _assert_arrays_equal(st, sj)
    assert st.static.emitter_kinds == (0, 1, 2, 3, 4, 5, 6)


@pytest.mark.parametrize("case", CASES)
def test_render_matches_jax(case, tmp_path):
    sj = mi.load_dict(case_dict(case, str(tmp_path)))
    ref = np.asarray(mi.render(sj, spp=SPP, seed=0))
    img = mt.render(port_scene_of(sj), spp=SPP, seed=0, device="cpu").numpy()
    assert img.shape == (RES, RES, 3) and np.isfinite(img).all()
    assert_images_close(img, ref)
    if case == "no emitter":
        assert (img == 0).all() and (ref == 0).all()
    else:
        assert img.mean() > 0
