"""``render(..., integrator={"type": "prb_reparam"})`` of the port against
the JAX package's: the image and the gradients of the vertices, the
emitters' radiance, the reflectances and the sensor pose, on the Cornell
box with face normals; ``prb_basic`` against ``prb``; the chunked replay
against the unchunked one.  The blocker scene of the JAX package's
``tests/test_reparam.py`` is in ``tests/test_torch_prb_reparam_blocker.py``,
the channels alone in ``tests/test_torch_prb_reparam_channels.py`` (the
JAX compiles spread over the test workers).

Tolerances, each with its reason:

- images: ``assert_images_close`` of ``test_torch_render.py`` (the
  primal is the path tracer's);
- gradients against JAX: within 1e-4 of each gradient's largest entry,
  the bar of ``tests/test_torch_prb.py``: the same paths from the same
  sampler streams, the port's fused replay taking the remaining radiance
  from the attached NEE term, and XLA's and PyTorch's rounding of the
  harmonic weights (``w ~ B^-3``);
- ``prb_basic`` and ``prb``: bit for bit (the same integrator);
- the chunked replay: within 1e-5 of each gradient's largest entry, the
  order in which the chunks' float32 sums are added.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from scenes import cornell_box as cornell_box_jax

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.ad import prb as prb_t

from test_torch_render import (assert_images_close, jax_leaf_vjp,
                               port_scene_of)
from torch_threads import one_torch_thread  # noqa: F401

RES, SPP, DEPTH, RAYS = 16, 2, 2, 4
WALLS = ("floor", "ceiling", "back", "left", "right")
INTEGRATOR = {"type": "prb_reparam", "max_depth": DEPTH, "reparam_rays": RAYS}
NAMES = ("vertices", "emitters.radiance", "bsdfs.reflectance",
         "sensors.0.to_world")


def _weights(seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (RES, RES, 3)).astype(np.float32)


def _assert_grad_close(got, ref, name, rel=1e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = float(np.abs(ref).max())
    assert scale > 0, name
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale,
                               err_msg=name)


def port_grads(st, W, integrator, names=NAMES, seed=0, spp=SPP):
    """The port's image and its gradients of sum(image * W)."""
    lv = {k: v.clone().requires_grad_(True)
          for k, v in st.leaves().items() if k in names}
    img = mt.render(st.with_leaves(lv), spp=spp, seed=seed, device="cpu",
                    integrator=integrator)
    g = torch.autograd.grad((img * torch.from_numpy(W)).sum(),
                            list(lv.values()))
    return img.detach().numpy(), dict(zip(lv, (x.numpy() for x in g)))


def jax_grads(sj, W, integrator, seed=0, spp=SPP):
    """JAX's image and its gradients of sum(image * W) w.r.t. NAMES, under
    the port's leaf names."""
    img, vjp = jax_leaf_vjp(sj, lambda s: mi.render(
        s, spp=spp, seed=seed, integrator=integrator), NAMES)
    (g,) = vjp(jnp.asarray(W))
    return np.asarray(img), {k: np.asarray(v) for k, v in zip(NAMES, g)}


def box_jax():
    d = cornell_box_jax(res=RES, spp=SPP, max_depth=DEPTH)
    for k in WALLS:
        d[k]["face_normals"] = True
    return mi.load_dict(d)


def assert_render_matches_jax(sj):
    """The image and every gradient of NAMES against JAX's."""
    st = port_scene_of(sj)
    W = _weights()
    img_j, g_j = jax_grads(sj, W, INTEGRATOR)
    img_t, g_t = port_grads(st, W, INTEGRATOR)
    assert_images_close(img_t, img_j)
    for k in NAMES:
        _assert_grad_close(g_t[k], g_j[k], k)
    # the reparameterised gradients reach the geometry and the camera
    assert np.abs(g_t["vertices"]).max() > 0
    assert np.abs(g_t["sensors.0.to_world"]).max() > 0


def test_image_and_gradients_match_jax():
    assert_render_matches_jax(box_jax())


def test_prb_basic_is_prb_bit_for_bit():
    st = port_scene_of(box_jax())
    W = _weights(2)
    img_a, g_a = port_grads(st, W, {"type": "prb", "max_depth": DEPTH})
    img_b, g_b = port_grads(st, W, {"type": "prb_basic", "max_depth": DEPTH})
    assert np.array_equal(img_a, img_b)
    for k in NAMES:
        assert np.array_equal(g_a[k], g_b[k]), k


@pytest.mark.parametrize("chunk", [100, 257])
def test_chunked_replay_equals_unchunked(monkeypatch, chunk):
    """The replay and the camera term in lane chunks (a chunk size that
    does not divide the 512 lanes) against one chunk of all lanes."""
    st = port_scene_of(box_jax())
    W = _weights(3)
    _, whole = port_grads(st, W, INTEGRATOR)
    monkeypatch.setattr(prb_t, "REPARAM_CHUNK", chunk)
    _, parts = port_grads(st, W, INTEGRATOR)
    for k in NAMES:
        _assert_grad_close(parts[k], whole[k], k, rel=1e-5)
