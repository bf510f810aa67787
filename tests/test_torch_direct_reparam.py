"""``render(..., integrator={"type": "direct_reparam"})`` of the port
against the JAX package's: the image and the gradients of the vertices,
the emitters' radiance, the reflectances and the sensor pose, on the
Cornell box with face normals; the backward in lane chunks against one
chunk.  ``emission_reparam`` is in ``tests/test_torch_direct_emission.py``
(the JAX compiles spread over the test workers).

Tolerances, each with its reason:

- the image: ``assert_images_close`` of ``tests/test_torch_render.py``
  (the primal is ``direct``'s);
- gradients against JAX: within 1e-4 of each gradient's largest entry,
  the bar of ``tests/test_torch_prb_reparam.py``: the same estimator on
  the same streams, XLA's and PyTorch's rounding of the harmonic weights
  (``w ~ B^-3``);
- the chunked backward: within 1e-5 of each gradient's largest entry,
  the order in which the chunks' float32 sums are added.
"""
import numpy as np
import pytest

from epsm_mitsuba3_torch.ad import prb as prb_t

from test_torch_prb_reparam import (NAMES, _assert_grad_close, _weights,
                                    box_jax, jax_grads, port_grads)
from test_torch_render import assert_images_close, port_scene_of
from torch_threads import one_torch_thread  # noqa: F401

SPP = 2
INTEGRATOR = {"type": "direct_reparam", "reparam_rays": 4}


def test_image_and_gradients_match_jax():
    sj = box_jax()
    W = _weights(4)
    img_j, g_j = jax_grads(sj, W, INTEGRATOR, spp=SPP)
    img_t, g_t = port_grads(port_scene_of(sj), W, INTEGRATOR, spp=SPP)
    assert_images_close(img_t, img_j)
    for k in NAMES:
        _assert_grad_close(g_t[k], g_j[k], k)
    assert np.abs(g_t["vertices"]).max() > 0
    assert np.abs(g_t["sensors.0.to_world"]).max() > 0


@pytest.mark.parametrize("chunk", [100, 257])
def test_chunked_backward_equals_unchunked(monkeypatch, chunk):
    """Lane chunks that do not divide the 512 lanes against one chunk."""
    st = port_scene_of(box_jax())
    W = _weights(5)
    _, whole = port_grads(st, W, INTEGRATOR, spp=SPP)
    monkeypatch.setattr(prb_t, "REPARAM_CHUNK", chunk)
    _, parts = port_grads(st, W, INTEGRATOR, spp=SPP)
    for k in NAMES:
        _assert_grad_close(parts[k], whole[k], k, rel=1e-5)
