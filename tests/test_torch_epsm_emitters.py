"""The EPSM layer with a far light beside the area light, against the JAX
package: ``cornell_box(16, 4, 4)`` with a constant environment added
after its area light (so that emitter row 0 stays the area light) and a
directional light.  The logged pass (``PathLog``), whose NEE shadow rays
toward the far lights end 1e5 away; a ``manifold`` render; and its
backward from a seeded 5-channel cotangent.

Tolerances: the logged pass as ``tests/test_torch_epsm.py`` holds it
(integer fields equal, floats within 1e-4 + 2e-5 relative, the NEE fields
of lanes on the emitter and of grazing NEE rays left out); the image as
``assert_images_close``; the backward within 1e-3 of each gradient's
largest entry, as ``tests/test_torch_epsm_backward.py``.  The reference's
vertex gradient is NaN on face 0's vertices (the area branch's 0 x inf,
``tests/test_torch_prb_emitters.py``): the port's is finite there and
held on every other vertex.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from epsm_mitsuba3_tpu.integrators import epsm as EJ
from scenes import cornell_box as cornell_box_jax

from epsm_mitsuba3_torch.integrators import epsm as ET

from test_torch_epsm import (DEPTH, INT_FIELDS, NEE_FIELDS, RES, SPP,
                             _grazing_nee, _logged_case, _on_emitter)
from torch_threads import one_torch_thread  # noqa: F401
from test_torch_render import assert_images_close


def far_lit_box():
    d = cornell_box_jax(res=RES, spp=SPP, max_depth=DEPTH)
    d["integrator"] = {"type": "manifold", "max_depth": DEPTH}
    d["sky"] = {"type": "constant", "radiance": {"type": "rgb",
                                                 "value": [0.3, 0.4, 0.5]}}
    d["sun"] = {"type": "directional", "direction": [0.2, -0.6, -1.0],
                "irradiance": 1.5}
    return d


@pytest.fixture(scope="module")
def box():
    return _logged_case(far_lit_box())


def test_path_log_with_far_lights_matches_jax(box):
    st = box["st"]
    assert st.static.emitter_kinds == (0, 2, 4)
    assert int(st.emitters["kind"][0]) == 0
    L, valid, logs = ET.sample_path_logged(st, box["smp_t"], box["ray_t"],
                                           DEPTH, 5)
    lj = box["logs_j"]
    skip = {f: _on_emitter(st, lj) for f in NEE_FIELDS}
    grazing = _grazing_nee(st, lj)
    for f in ("em_b0", "em_b1", "em_dist_ratio"):
        skip[f] = skip[f] | grazing
    for f in ET.PathLog._fields:
        got, ref = getattr(logs, f).numpy(), np.asarray(getattr(lj, f))
        sel = ~skip.get(f, np.zeros(ref.shape[:2], bool))
        if f in INT_FIELDS:
            np.testing.assert_array_equal(got[sel], ref.astype(got.dtype)[sel],
                                          err_msg=f)
        else:
            np.testing.assert_allclose(got[sel], ref[sel], rtol=2e-5,
                                       atol=1e-4, err_msg=f)
    np.testing.assert_allclose(L.numpy(), np.asarray(box["L_j"]), rtol=2e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(box["valid_j"]))
    # some NEE rays went to a far light: their logged point is 1e5 away
    far = np.linalg.norm(np.asarray(lj.light) - np.asarray(lj.p), axis=-1)
    live = np.asarray(lj.active_em).astype(bool)
    assert (far[live] > 9e4).sum() > 100


def test_manifold_render_and_backward_match_jax(box):
    sj, st = box["sj"], box["st"]
    ref = np.asarray(EJ.render_epsm(sj, seed=3, spp=2, max_depth=DEPTH))
    img = ET.render_epsm(st, seed=3, spp=2, max_depth=DEPTH).numpy()
    assert img.shape == ref.shape == (RES, RES, 5) and img[..., :3].mean() > 0
    assert_images_close(img, ref)
    names = ("vertices", "bsdfs.reflectance", "emitters.radiance",
             "emitters.irradiance")
    g = np.random.default_rng(13).normal(size=(RES, RES, 5)).astype(
        np.float32) * 0.05
    rj = jax.jit(EJ.render_backward, static_argnums=(3, 4, 5, 6, 7))(
        sj, jnp.asarray(g), jnp.uint32(3), DEPTH, 5, False, -1, 2)
    got = ET.render_backward(st, names, torch.from_numpy(g), 3, DEPTH, 5,
                             False, -1, 2)
    face0 = np.zeros(st.vertices.shape[0], bool)
    face0[st.faces[0].long().numpy()] = True
    for k, r in (("vertices", rj.vertices),
                 ("bsdfs.reflectance", rj.bsdfs["reflectance"]),
                 ("emitters.radiance", rj.emitters["radiance"]),
                 ("emitters.irradiance", rj.emitters["irradiance"])):
        r, gk = np.asarray(r), got[k].numpy()
        assert gk.shape == r.shape and np.isfinite(gk).all(), k
        ok = np.isfinite(r)
        if k == "vertices":
            assert np.all(ok | face0[:, None]), np.where(~ok)
        else:
            assert ok.all(), k
        scale = float(np.abs(r[ok]).max())
        assert scale > 0, k
        np.testing.assert_allclose(gk[ok], r[ok], rtol=0, atol=1e-3 * scale,
                                   err_msg=k)
