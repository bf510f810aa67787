"""The gradient channels of the port's ``prb_reparam`` one at a time,
against the JAX package's, through the diagnostic knobs both packages
read (JAX ``ad/render.py`` ``_rp_items``): ``_no_cam`` drops the camera
vertex's film term, ``_no_em_det`` detaches the NEE shadow ray's
divergence, ``_no_main_det`` the bounce divergence.  With all three only
the warped incident direction is left (that case is in
``tests/test_torch_reparam.py``, to spread JAX's compiles over the test
workers).  On the Cornell box with face normals at 16^2, 2 spp, depth 2,
4 auxiliary rays.

Tolerance: each gradient within 1e-4 of its largest entry, as in
``tests/test_torch_prb_reparam.py``; the sensor pose's gradient is
exactly 0 without the camera term (the replay's camera rays are
detached).
"""
import numpy as np
import pytest

from test_torch_prb_reparam import (INTEGRATOR, NAMES, _assert_grad_close,
                                    _weights, box_jax, jax_grads, port_grads)
from test_torch_render import port_scene_of
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def scenes():
    sj = box_jax()
    return sj, port_scene_of(sj)


def assert_channel_matches_jax(sj, st, knobs):
    W = _weights(1)
    integrator = dict(INTEGRATOR, **knobs)
    _, g_j = jax_grads(sj, W, integrator)
    _, g_t = port_grads(st, W, integrator)
    for k in NAMES:
        if k == "sensors.0.to_world":
            assert np.abs(g_t[k]).max() == 0
            assert np.abs(np.asarray(g_j[k])).max() == 0
            continue
        _assert_grad_close(g_t[k], g_j[k], k)


@pytest.mark.parametrize("knobs", [
    {"_no_cam": 1}, {"_no_cam": 1, "_no_em_det": 1}],
    ids=["bounces and NEE", "bounce divergence"])
def test_channel_matches_jax(scenes, knobs):
    assert_channel_matches_jax(*scenes, knobs)
