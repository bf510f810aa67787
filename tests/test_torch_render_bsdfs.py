"""The remaining scalar BSDFs, ``mask`` and Beckmann in scenes, against
the JAX package:

- ``load_dict`` of each kind and wrapper (every column of the port's
  BSDF table, the textures and ``static.bsdf_kinds``, the Beckmann
  sentinel included) equal to JAX's, and the refusal both packages
  share;
- a ``path`` render of a box with a Beckmann rough plastic floor, a
  masked principled back wall and a two-sided principledthin wall
  (``test_torch_prb_bsdfs.py`` renders the other kinds and holds the
  PRB gradients: each kind the reference evaluates on every lane adds to
  its compile, ~40 s for this box).

The JAX scene is carried across by ``scene_from_arrays``.

Tolerances: loader arrays bit for bit; images ``assert_images_close`` of
``test_torch_render.py`` (mean |diff| <= 1e-4, >= 99 % of pixels within
1e-4).
"""
import numpy as np
import pytest
import torch

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.utils import xmlwrite as WJ
from scenes import cornell_box as cornell_box_jax

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.utils import xmlwrite as WT

from test_torch_render import assert_images_close, jax_arrays, port_scene_of
from test_torch_render_emitters import plain
from torch_threads import one_torch_thread  # noqa: F401

RES, SPP, DEPTH = 16, 4, 3


def quad(center, scale, bsdf, rot=0.0):
    """A rectangle at ``center`` facing +z (turned by ``rot`` degrees about
    y), half-size ``scale``."""
    T = mi.ScalarTransform4f
    return {"type": "rectangle", "bsdf": bsdf,
            "to_world": T.translate(center).rotate([0, 1, 0], rot)
            .scale(scale)}


def box_a(res=RES, spp=SPP, max_depth=DEPTH):
    """The Cornell box with a Beckmann rough plastic floor, a masked
    principled back wall and a two-sided principledthin right wall."""
    d = cornell_box_jax(res=res, spp=spp, max_depth=max_depth)
    d["floor"]["bsdf"] = {"type": "roughplastic", "distribution": "beckmann",
                          "alpha": 0.25, "int_ior": 1.6,
                          "diffuse_reflectance": [0.6, 0.55, 0.4]}
    d["back"]["bsdf"] = {"type": "mask", "opacity": 0.6, "bsdf": {
        "type": "principled", "base_color": [0.7, 0.3, 0.2],
        "metallic": 0.3, "roughness": 0.4, "clearcoat": 0.5,
        "sheen": 0.3}}
    d["right"]["bsdf"] = {"type": "twosided", "bsdf": {
        "type": "principledthin", "base_color": [0.2, 0.6, 0.2],
        "spec_trans": 0.3, "diff_trans": 0.8, "eta": 1.45,
        "roughness": 0.3}}
    return d


def box_b(res=RES, spp=SPP, max_depth=DEPTH):
    """The Cornell box with a left wall blending a plastic and a GGX rough
    dielectric, and thin-dielectric and pplastic quads."""
    d = cornell_box_jax(res=res, spp=spp, max_depth=max_depth)
    d["left"]["bsdf"] = {"type": "blendbsdf", "weight": 0.35,
                         "a": {"type": "plastic",
                               "diffuse_reflectance": [0.6, 0.1, 0.1]},
                         "b": {"type": "roughdielectric", "alpha": 0.2}}
    d["sheet"] = quad([-0.4, 0.7, 0.2], 0.3,
                      {"type": "thindielectric", "int_ior": 1.5}, 20.0)
    d["panel"] = quad([0.2, 1.2, -0.4], 0.3,
                      {"type": "pplastic", "alpha": 0.15,
                       "diffuse_reflectance": [0.3, 0.4, 0.7]}, 15.0)
    return d


def check_render(d, kinds):
    """A ``path`` render of ``d`` against JAX's, and the kind set."""
    sj = mi.load_dict(d)
    st = port_scene_of(sj)
    assert st.static.bsdf_kinds == sj.static.bsdf_kinds == kinds
    st2 = mt.load_dict(plain(d), device="cpu")
    for k, v in st2.bsdfs.items():
        assert torch.equal(v, st.bsdfs[k]), k
    ref = np.asarray(mi.render(sj, spp=SPP, seed=0))
    img = mt.render(st, spp=SPP, seed=0, device="cpu").numpy()
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert_images_close(img, ref)
    assert img.std() > 0.05


def _ball(bsdf):
    return {"type": "scene",
            "ball": {"type": "sphere", "radius": 0.5, "bsdf": bsdf},
            "light": {"type": "rectangle", "to_world": np.asarray(
                [[1, 0, 0, 0], [0, 1, 0, 2], [0, 0, 1, 0], [0, 0, 0, 1]],
                np.float32), "emitter": {"type": "area", "radiance": 5.0}}}


CHECKER = {"type": "checkerboard", "color0": [0.8, 0.2, 0.1],
           "color1": [0.1, 0.3, 0.9], "uv_scale": 4.0}
LOAD_CASES = {
    "thindielectric": {"type": "thindielectric", "int_ior": "water",
                       "specular_transmittance": 0.8},
    "roughdielectric": {"type": "roughdielectric", "alpha": 0.3,
                        "int_ior": 1.7, "ext_ior": 1.1},
    "roughdielectric beckmann": {"type": "roughdielectric",
                                 "distribution": "beckmann"},
    "roughconductor beckmann": {"type": "roughconductor",
                                "distribution": "beckmann", "alpha": 0.2},
    "plastic": {"type": "plastic", "diffuse_reflectance": [0.2, 0.4, 0.6],
                "int_ior": 1.9},
    "plastic textured reflectance": {"type": "plastic",
                                     "reflectance": CHECKER},
    "roughplastic": {"type": "roughplastic", "roughness": 0.2,
                     "specular_reflectance": 0.8},
    "roughplastic beckmann": {"type": "roughplastic",
                              "distribution": "beckmann"},
    "pplastic": {"type": "pplastic", "eta": 1.3, "int_ior": 1.9,
                 "alpha": 0.05},
    "null": {"type": "null"},
    "principled": {"type": "principled", "base_color": [0.7, 0.2, 0.1],
                   "metallic": 0.7, "spec_tint": 0.2, "sheen": 0.4,
                   "sheen_tint": 0.5, "clearcoat": 0.6,
                   "clearcoat_gloss": 0.3, "specular": 0.8,
                   "roughness": 0.35},
    "principledthin": {"type": "principledthin", "spec_trans": 0.6,
                       "diff_trans": 1.5, "flatness": 0.4, "eta": 1.33},
    "blendbsdf": {"type": "blendbsdf", "weight": 0.3,
                  "a": {"type": "diffuse"},
                  "b": {"type": "roughconductor", "alpha": 0.2}},
    "blendbsdf textured weight": {"type": "blendbsdf", "weight": CHECKER,
                                  "a": {"type": "plastic"},
                                  "b": {"type": "principled"}},
    "nested blend": {"type": "blendbsdf", "weight": 0.6,
                     "a": {"type": "blendbsdf", "weight": 0.2,
                           "a": {"type": "null"},
                           "b": {"type": "diffuse"}},
                     "b": {"type": "thindielectric"}},
    "mask": {"type": "mask", "opacity": 0.25,
             "material": {"type": "roughplastic"}},
    "mask textured opacity": {"type": "mask", "opacity": CHECKER,
                              "bsdf": {"type": "diffuse",
                                       "reflectance": CHECKER}},
    "twosided mask": {"type": "twosided", "bsdf": {
        "type": "mask", "opacity": 0.3, "bsdf": {"type": "principled"}}},
    "mask twosided": {"type": "mask", "opacity": 0.3,
                      "bsdf": {"type": "twosided", "bsdf": {
                          "type": "plastic"}}},
    "diffuse named beckmann": {"type": "diffuse",
                               "distribution": "beckmann"},
}


@pytest.mark.parametrize("case", list(LOAD_CASES))
def test_load_dict_rows_and_kinds_equal_jax(case):
    """Every column of the port's table, the textures and the kind set
    (the Beckmann sentinel too) equal JAX's: blend children registered
    first, a mask as blend(null, material, opacity), the principled
    columns, ``eta`` from int_ior / ext_ior for the dielectrics and the
    plastics but from ``eta`` for pplastic, a twosided wrapper outside a
    mask dropping its opacity."""
    d = _ball(LOAD_CASES[case])
    sj = mi.load_dict(d)
    st = mt.load_dict(d, device="cpu")
    ref = jax_arrays(sj)
    for k, v in st.bsdfs.items():
        r = ref[f"bsdfs.{k}"]
        np.testing.assert_array_equal(v.numpy(), r.astype(v.numpy().dtype),
                                      k)
    assert st.static.bsdf_kinds == sj.static.bsdf_kinds
    assert len(st.textures) == len(sj.textures)
    for i, tex in enumerate(st.textures):
        assert tex.kind == sj.textures[i].kind
        np.testing.assert_array_equal(tex.color0.numpy(),
                                      ref[f"textures.{i}.color0"])
    # scene_from_arrays carries the same columns and kinds
    sa = port_scene_of(sj)
    for k, v in st.bsdfs.items():
        assert torch.equal(v, sa.bsdfs[k]), k
    assert sa.static.bsdf_kinds == st.static.bsdf_kinds
    assert sa.static.bsdf_textures == st.static.bsdf_textures


def test_textured_diffuse_reflectance_refused_as_jax():
    """A plastic's textured ``diffuse_reflectance`` is refused by both
    loaders, with the reference's ValueError (its ``reflectance``
    texture serves the diffuse reflectance)."""
    d = _ball({"type": "plastic", "diffuse_reflectance": CHECKER})
    with pytest.raises(ValueError, match="unsupported spectrum type"):
        mi.load_dict(d)
    with pytest.raises(ValueError, match="unsupported spectrum type"):
        mt.load_dict(d, device="cpu")


def test_xml_round_trip_equals_jax():
    """``dict_to_xml`` writes every new kind and wrapper as the JAX
    writer does, text for text, and ``load_string`` of that text loads
    the table ``load_dict`` loads."""
    d = plain(box_a())
    d.update(plain(box_b()))
    for i, case in enumerate(("mask textured opacity", "nested blend",
                              "pplastic", "null", "roughplastic beckmann")):
        d[f"extra{i}"] = {"type": "rectangle", "bsdf": LOAD_CASES[case],
                          "to_world": np.diag([0.1, 0.1, 0.1, 1.0]).astype(
                              np.float32)}
    text = WT.dict_to_xml(d)
    assert text == WJ.dict_to_xml(d)
    st, sx = mt.load_dict(d, device="cpu"), mt.load_string(text,
                                                           device="cpu")
    for k, v in st.bsdfs.items():
        assert torch.equal(v, sx.bsdfs[k]), k
    assert sx.static.bsdf_kinds == st.static.bsdf_kinds


def test_render_matches_jax():
    """Beckmann rough plastic, mask (null), principled and principledthin
    (``test_torch_prb_bsdfs.py`` renders the blend, the plastic, the
    rough and thin dielectrics and pplastic: each kind the reference
    evaluates on every lane adds to its compile)."""
    check_render(box_a(), (0, 7, 8, 9, 10, 17, 99))
