"""The port's EPSM backward (``integrators/epsm.py`` ``render_backward``)
against the JAX package's, end to end from an image cotangent: the
logged pass, the first-hit derivative, ``calc_grad``, the injection and
the PRB replay of the colour adjoint, on ``tests/test_epsm.py``'s
``lightblob_scene`` (``manifold``) and on ``cornell_box(16, 4, 4)``
(``manifold_caustic``), each with a seeded 5-channel cotangent.

Tolerance: every gradient within 1e-3 of its largest entry (the stages'
float32 rounding, and sums over hundreds of lanes into each vertex in
another order; the port's replay takes the remaining radiance from the
attached NEE term, within 1e-4 of the reference's, ``ROADMAP.md`` §3).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.integrators import epsm as EJ
from scenes import cornell_box as cornell_box_jax
from test_epsm import lightblob_scene

from epsm_mitsuba3_torch.integrators import epsm as ET

from test_torch_render import port_scene_of
from torch_threads import one_torch_thread  # noqa: F401

NAMES = ("vertices", "normals", "bsdfs.reflectance", "emitters.radiance")


def _case(sj, caustic, max_depth, bwd_spp):
    st = port_scene_of(sj)
    s = sj.sensors[-1]
    g = np.random.default_rng(5).normal(
        size=(s.height, s.width, 5)).astype(np.float32) * 0.05
    ref = jax.jit(EJ.render_backward, static_argnums=(3, 4, 5, 6, 7))(
        sj, jnp.asarray(g), jnp.uint32(3), max_depth, 5, caustic, -1,
        bwd_spp)
    cam = f"sensors.{len(sj.sensors) - 1}.to_world"
    got = ET.render_backward(st, NAMES + (cam,), torch.from_numpy(g), 3,
                             max_depth, 5, caustic, -1, bwd_spp)
    ref = {"vertices": ref.vertices, "normals": ref.normals,
           "bsdfs.reflectance": ref.bsdfs["reflectance"],
           "emitters.radiance": ref.emitters["radiance"],
           cam: ref.sensors[-1].to_world}
    return got, {k: np.asarray(v) for k, v in ref.items()}


@pytest.fixture(scope="module")
def lightblob():
    return _case(lightblob_scene(res=16, spp=4), False, 2, 2)


@pytest.fixture(scope="module")
def box():
    return _case(mi.load_dict(cornell_box_jax(res=16, spp=4, max_depth=4)),
                 True, 4, 2)


@pytest.mark.parametrize("case", ["lightblob", "box"])
def test_render_backward_matches_jax(case, request):
    got, ref = request.getfixturevalue(case)
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k].numpy()
        assert g.shape == r.shape and np.isfinite(g).all(), k
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-3 * max(np.abs(r).max(), 1e-30),
                                   err_msg=k)
    # the manifold solve moved the geometry, and the camera moved
    assert np.abs(ref["vertices"]).max() > 0
    cam = [k for k in ref if k.startswith("sensors.")][0]
    assert np.abs(ref[cam][:3, 3]).max() > 0
