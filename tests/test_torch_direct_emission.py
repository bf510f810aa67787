"""``render(..., integrator={"type": "emission_reparam"})`` of the port
against the JAX package's: the image and the gradients of the vertices,
the emitters' radiance and the sensor pose (the reflectances take none:
only emission is seen), on the Cornell box with face normals; the
backward in lane chunks against one chunk.  Tolerances as in
``tests/test_torch_direct_reparam.py``.
"""
import numpy as np

from epsm_mitsuba3_torch.ad import prb as prb_t

from test_torch_prb_reparam import (NAMES, _assert_grad_close, _weights,
                                    box_jax, jax_grads, port_grads)
from test_torch_render import assert_images_close, port_scene_of
from torch_threads import one_torch_thread  # noqa: F401

SPP = 2
INTEGRATOR = {"type": "emission_reparam", "reparam_rays": 4}
SEEN = tuple(k for k in NAMES if k != "bsdfs.reflectance")


def test_image_and_gradients_match_jax():
    sj = box_jax()
    W = _weights(6)
    img_j, g_j = jax_grads(sj, W, INTEGRATOR, spp=SPP)
    img_t, g_t = port_grads(port_scene_of(sj), W, INTEGRATOR, spp=SPP)
    assert_images_close(img_t, img_j)
    for k in SEEN:
        _assert_grad_close(g_t[k], g_j[k], k)
    assert not np.asarray(g_j["bsdfs.reflectance"]).any()
    assert not g_t["bsdfs.reflectance"].any()


def test_chunked_backward_equals_unchunked(monkeypatch):
    st = port_scene_of(box_jax())
    W = _weights(7)
    _, whole = port_grads(st, W, INTEGRATOR, spp=SPP)
    monkeypatch.setattr(prb_t, "REPARAM_CHUNK", 100)
    _, parts = port_grads(st, W, INTEGRATOR, spp=SPP)
    for k in SEEN:
        _assert_grad_close(parts[k], whole[k], k, rel=1e-5)
