"""Forward mode under ``prb_reparam``: ``render_forward`` of the port
against the JAX package's (a vertex tangent), against the port's own
backward (vertices and the sensor pose, the camera-vertex term), and in
lane chunks against one chunk.

Tolerances, each with its reason:

- the image tangent against JAX: within 1e-4 of its largest entry, the
  bar of ``tests/test_torch_prb_reparam.py`` (the harmonic weights
  ``w ~ B^-3`` rounded by XLA and by PyTorch);
- forward against backward: rtol 2e-3.  The JAX package holds its own at
  2e-2 (``tests/test_render_forward.py:147``); the port's forward and
  backward share one Lo (``ad/prb.py`` ``_bounce_lo``) and one camera
  splat, so they meet the non-reparameterised bar;
- the chunked forward: within 1e-5 of its largest entry, the order of
  the float32 sums.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.ad import prb as prb_j

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.ad import prb as prb_t
from epsm_mitsuba3_torch.scenes import blocker_scene

from test_torch_forward import assert_forward_is_backward
from test_torch_prb_reparam import INTEGRATOR, SPP, box_jax
from test_torch_render import port_scene_of
from torch_threads import one_torch_thread  # noqa: F401


def _tangent(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_render_forward_matches_jax():
    sj = box_jax()
    st = port_scene_of(sj)
    T = _tangent(np.shape(sj.vertices), 7)
    dj = prb_j.zero_tangent(sj).replace(vertices=jnp.asarray(T))
    ref = np.asarray(mi.render_forward(sj, dj, seed=0, spp=SPP,
                                       integrator=INTEGRATOR))
    got = mt.render_forward(st, {"vertices": torch.from_numpy(T)}, seed=0,
                            spp=SPP, device="cpu",
                            integrator=INTEGRATOR).numpy()
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("leaf", ["vertices", "sensors.0.to_world"])
def test_forward_equals_backward(leaf):
    """The blocker scene, whose shadow edge moves with the blocker: the
    vertices reach every warp, the sensor pose the camera-vertex term."""
    st = mt.load_dict(blocker_scene(res=16, spp=SPP), device="cpu")
    t = torch.from_numpy(_tangent(tuple(st.leaves()[leaf].shape), 8))
    dimg = assert_forward_is_backward(st, {leaf: t}, INTEGRATOR)
    assert bool(torch.isfinite(dimg).all())


def test_chunked_forward_equals_unchunked(monkeypatch):
    """The replay's JVP and the camera term's in lane chunks of 100 (not
    dividing the 512 lanes) against one chunk."""
    st = mt.load_dict(blocker_scene(res=16, spp=SPP), device="cpu")
    tangents = {"vertices": torch.from_numpy(
        _tangent(tuple(st.vertices.shape), 9)),
        "sensors.0.to_world": torch.from_numpy(_tangent((4, 4), 10))}

    def run():
        return mt.render_forward(st, tangents, seed=1, spp=SPP, device="cpu",
                                 integrator=INTEGRATOR).numpy()

    whole = run()
    monkeypatch.setattr(prb_t, "REPARAM_CHUNK", 100)
    parts = run()
    np.testing.assert_allclose(parts, whole, rtol=0,
                               atol=1e-5 * float(np.abs(whole).max()))


@pytest.mark.parametrize("knob", ["_no_em_det", "_no_main_det", "_no_cam"])
def test_channel_knobs_act_in_both_directions(knob):
    """The diagnostic knobs that isolate a gradient channel act on the
    forward as on the backward, which share one Lo and one camera term.
    The JAX package's forward ignores ``_no_em_det`` and ``_no_main_det``
    (``ad/prb.py:580-607``): ``ROADMAP.md`` queue 3."""
    st = mt.load_dict(blocker_scene(res=16, spp=SPP), device="cpu")
    t = torch.from_numpy(_tangent(tuple(st.vertices.shape), 11))
    assert_forward_is_backward(st, {"vertices": t}, {**INTEGRATOR, knob: 1})
