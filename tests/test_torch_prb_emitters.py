"""PRB gradients through every emitter kind against ``jax.grad`` through
the JAX package's ``render``: one Cornell box lit by all eight kinds
(``test_torch_emitters.all_kinds_scene``), face normals on its walls, and
the gradients of its vertices, reflectances, the lights' ``radiance``,
``intensity`` and ``irradiance``, the envmap's texels and the projector
bitmap's texels; and the environment's MIS reading emitter row 0 (a
reference quirk, ``ROADMAP.md`` queue 3) in both orders.

Tolerances: each gradient within 1e-4 of its largest entry, as
``tests/test_torch_prb.py`` holds the area light's (the fused replay's
remaining radiance, sums in other orders); images as
``assert_images_close``.

Face 0's vertices: where a lane picks a light of another kind, the
reference's area branch divides by that row's zero area, and its
gradient reaches face 0's vertices as 0 x inf = NaN through the select
(``ROADMAP.md`` queue 3).  The port gives that branch pdf 0 there: its
gradient is finite everywhere and equal to JAX's on every other vertex.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from scenes import cornell_box as cornell_box_jax

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.models import emitters as ET

from test_torch_emitters import all_kinds_scene
from test_torch_render import (assert_images_close, jax_leaf_grads,
                               port_scene_of)
from test_torch_render_emitters import plain
from torch_threads import one_torch_thread  # noqa: F401

RES, SPP, DEPTH = 16, 4, 3
WALLS = ("floor", "ceiling", "back", "left", "right")


def _port_grads(st, names, W):
    lv = {k: v.clone().requires_grad_(True)
          for k, v in st.leaves().items() if k in names}
    img = mt.render(st.with_leaves(lv), spp=SPP, seed=0, device="cpu")
    g = torch.autograd.grad((img * torch.from_numpy(W)).sum(),
                            list(lv.values()))
    return dict(zip(lv, (x.numpy() for x in g)))


def test_all_kinds_gradients_match_jax(tmp_path):
    d = all_kinds_scene(str(tmp_path))
    d["integrator"]["max_depth"] = DEPTH
    for k in WALLS:
        d[k]["face_normals"] = True
    sj = mi.load_dict(d)
    W = np.random.default_rng(12).uniform(0, 1, (RES, RES, 3)).astype(
        np.float32)
    st = port_scene_of(sj)
    env = st.static.env_texture
    slide = 1 - env                      # the projector's bitmap
    assert st.textures[slide].kind == "bitmap"
    _, ref = jax_leaf_grads(
        sj, lambda s: jnp.sum(mi.render(s, spp=SPP, seed=0) * W),
        ("vertices", "bsdfs.reflectance", "emitters.radiance",
         "emitters.intensity", "emitters.irradiance", f"textures.{env}.data",
         f"textures.{slide}.data"))
    got = _port_grads(st, tuple(ref), W)
    for k, r in ref.items():
        r, gk = np.asarray(r), got[k]
        assert np.isfinite(gk).all(), k
        ok = np.isfinite(r)
        if k == "vertices":
            # the reference's NaN: face 0's vertices, and nothing else
            face0 = np.zeros(len(r), bool)
            face0[st.faces[0].long().numpy()] = True
            assert np.all(ok | face0[:, None]), np.where(~ok)
        else:
            assert ok.all(), k
        scale = float(np.abs(r[ok]).max())
        assert scale > 0, k
        np.testing.assert_allclose(gk[ok], r[ok], rtol=0, atol=1e-4 * scale,
                                   err_msg=k)
    # every kind's own parameter moved the image
    kinds = st.emitters["kind"].numpy()
    for col, kset in (("intensity", (1, 5, 6)), ("irradiance", (4,)),
                      ("radiance", (0, 2, 3, 7))):
        rows = np.isin(kinds, kset)
        assert np.abs(got[f"emitters.{col}"][rows]).max(-1).min() > 0, col


@pytest.mark.parametrize("env_first", [True, False])
def test_environment_mis_reads_row_zero(env_first):
    """The environment's MIS pdf is ``pdf_direction`` of emitter row 0
    (JAX ``integrators/path.py:66-72``): with the constant light as row 0
    it is the uniform sphere's, after the area light it is the area
    branch's on the miss record.  Both orders equal JAX's renders."""
    box = cornell_box_jax(res=RES, spp=SPP, max_depth=DEPTH)
    sky = {"type": "constant", "radiance": {"type": "rgb",
                                            "value": [0.4, 0.5, 0.6]}}
    d = {"type": "scene", "sky": sky} if env_first else {"type": "scene"}
    d.update({k: v for k, v in box.items() if k != "type"})
    if not env_first:
        d["sky"] = sky
    sj = mi.load_dict(d)
    st = mt.load_dict(plain(d), device="cpu")
    row0 = int(st.emitters["kind"][0])
    assert row0 == int(sj.emitters["kind"][0]) == (
        ET.KIND_CONSTANT if env_first else ET.KIND_AREA)
    ref = np.asarray(mi.render(sj, spp=SPP, seed=1))
    img = mt.render(st, spp=SPP, seed=1, device="cpu").numpy()
    assert_images_close(img, ref)
