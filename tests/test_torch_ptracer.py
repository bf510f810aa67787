"""The particle tracer (``integrators/ptracer.py``) of the port against the
JAX package's: ``sensor_connect``, a render of ``single_quad_direct``,
a light that is not an area light, and its zero gradient.

Tolerances, each with its reason:

- ``sensor_connect``: 1e-5 of each output's scale (XLA's and PyTorch's
  ``tan`` and matrix products round differently); ``valid`` equal but
  on points within 1e-5 of the film's edge;
- images: within 1e-5 of the largest pixel, as the card's ``splat`` is
  held: each pixel is a scatter-add of up to spp x depth float32
  contributions, which XLA and PyTorch sum in other orders (the same
  draws and the same pixel for every contribution).
"""
import numpy as np
import pytest
import torch

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.integrators import ptracer as pt_j
from scenes import single_quad_direct as single_quad_direct_jax

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.integrators import ptracer as pt_t
from epsm_mitsuba3_torch.scenes import cornell_box, single_quad_direct

from test_torch_render import port_scene_of
from torch_threads import one_torch_thread  # noqa: F401

INTEG = {"type": "ptracer", "max_depth": 3}


def _assert_film_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)


def test_sensor_connect_matches_jax():
    sj = mi.load_dict(single_quad_direct_jax(res=12, spp=1))
    st = port_scene_of(sj)
    p = np.random.default_rng(7).uniform(-2, 2, (4096, 3)).astype(np.float32)
    ref = [np.asarray(x) for x in pt_j.sensor_connect(sj.sensors[0], p)]
    got = [x.numpy() for x in pt_t.sensor_connect(st.sensors[0],
                                                  torch.from_numpy(p))]
    for name, a, b in zip(("uv", "d", "dist", "we"), got[:4], ref[:4]):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * float(np.abs(b).max()),
                                   err_msg=name)
    uv = ref[0]
    edge = np.abs(np.concatenate([uv, 1 - uv], -1)).min(-1) < 1e-5
    assert ref[4].sum() > 100
    assert np.array_equal(got[4][~edge], ref[4][~edge])


@pytest.fixture(scope="module")
def quad():
    sj = mi.load_dict(single_quad_direct_jax(res=8, spp=4))
    return sj, port_scene_of(sj)


def test_render_matches_jax(quad):
    """8^2 x 4 spp, depth 3: the emitter vertices and two bounces."""
    sj, st = quad
    ref = mi.render(sj, spp=4, seed=2, integrator=INTEG)
    img = mt.render(st, spp=4, seed=2, device="cpu", integrator=INTEG)
    assert img.shape == (8, 8, 3)
    _assert_film_close(img.numpy(), ref)


def test_point_light_beside_the_area_light_matches_jax():
    """A point light has no triangle: the reference's particles from its
    row start on face 0 with a weight of ~1e-12 and add no light of their
    own.  Its image is finite, and the port's equals it."""
    d = single_quad_direct_jax(res=8, spp=4)
    d["bulb"] = {"type": "point", "position": [0, 1.5, 0.3],
                 "intensity": 2.0}
    sj = mi.load_dict(d)
    ref = np.asarray(mi.render(sj, spp=4, seed=1, integrator=INTEG))
    assert np.isfinite(ref).all()
    img = mt.render(port_scene_of(sj), spp=4, seed=1, device="cpu",
                    integrator=INTEG)
    _assert_film_close(img.numpy(), ref)


def test_gradients_are_zero():
    sc = mt.load_dict(cornell_box(res=8, spp=2, max_depth=3), device="cpu")
    lv = {k: v.clone().requires_grad_(True) for k, v in sc.leaves().items()}
    img = mt.render(sc.with_leaves(lv), spp=2, device="cpu",
                    integrator=INTEG)
    g = torch.autograd.grad(img.sum(), list(lv.values()))
    assert float(img.detach().sum()) > 0
    assert all(gk.shape == lv[k].shape and not gk.any()
               for k, gk in zip(lv, g))


def test_mean_near_path_on_the_quad():
    """JAX's tests/test_integrators.py:78-84 at a small size: the particle
    tracer's mean within 5 % of ``path`` at depth 2."""
    sc = mt.load_dict(single_quad_direct(res=16, spp=64), device="cpu")
    img_t = mt.render(sc, spp=256, device="cpu",
                      integrator={"type": "ptracer", "max_depth": 2})
    img_p = mt.render(sc, spp=64, device="cpu",
                      integrator={"type": "path", "max_depth": 2})
    rel = abs(float(img_t.mean() - img_p.mean())) / float(img_p.mean())
    assert rel < 0.05, rel
