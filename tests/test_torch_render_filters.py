"""Renders of the Cornell box through the port's reconstruction filters
and sampler kinds against the JAX package's.

Each case loads ``cornell_box(16, 4)`` with another filter and sampler in
JAX, hands its state to the port (``port_scene_of``) and renders both at
4 spp, depth 3 or 2, through ``render``: the path tracer's film is
``splat_coalesced`` for every filter but the box.  The first case names
no filter, so the hdrfilm's default, the gaussian, applies.  The tent,
Catmull-Rom and box filters, and the multijitter and independent
samplers, render in the sensor cases (``test_torch_render_sensors.py``,
``test_torch_render_probes.py``).  Tolerance: ``assert_images_close`` of
``tests/test_torch_render.py`` (mean |diff| <= 1e-4, >= 99 % of pixels
within 1e-4).
"""
import numpy as np
import pytest

import epsm_mitsuba3_tpu as mi
from scenes import cornell_box as cornell_box_jax

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.scenes import cornell_box

from test_torch_render import assert_images_close, port_scene_of
from torch_threads import one_torch_thread  # noqa: F401

RES, SPP = 16, 4


def camera_dict(make, rfilter, sampler, depth, sensor=None, edit=None):
    """``make``'s Cornell box at RES x SPP with the film's filter (None:
    no rfilter entry), the sampler kind and the sensor's entries
    changed, then ``edit`` applied to the dict."""
    d = make(res=RES, spp=SPP, max_depth=depth)
    s = d["sensor"]
    if rfilter is None:
        del s["film"]["rfilter"]
    else:
        s["film"]["rfilter"] = {"type": rfilter}
    s["sampler"]["type"] = sampler
    s.update(sensor or {})
    if edit is not None:
        edit(d)
    return d


def render_both(rfilter, sampler, depth, sensor=None, seed=1, edit=None):
    """The JAX render and the port's of the same scene (``camera_dict``
    of the JAX package's Cornell box, its state handed over)."""
    sj = mi.load_dict(camera_dict(cornell_box_jax, rfilter, sampler, depth,
                                  sensor, edit))
    ref = np.asarray(mi.render(sj, spp=SPP, seed=seed))
    got = mt.render(port_scene_of(sj), spp=SPP, seed=seed,
                    device="cpu").numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert got.mean() > 0.01
    return got, ref


@pytest.mark.parametrize("rfilter,sampler,depth", [
    (None, "stratified", 3),
    ("lanczos", "ldsampler", 2),
    ("mitchell", "orthogonal", 2),
])
def test_render_matches_jax(rfilter, sampler, depth):
    got, ref = render_both(rfilter, sampler, depth)
    assert_images_close(got, ref)


def test_default_filter_is_gaussian_and_differs_from_box():
    """With no ``rfilter`` the port's loader takes the gaussian, whose
    image is smoother than the box filter's at the same samples."""
    d = camera_dict(cornell_box, None, "stratified", 2)
    sc = mt.load_dict(d, device="cpu")
    assert sc.sensors[0].rfilter == "gaussian"
    img = mt.render(sc, spp=SPP, seed=1, device="cpu").numpy()
    d["sensor"]["film"]["rfilter"] = {"type": "box"}
    box = mt.render(mt.load_dict(d, device="cpu"), spp=SPP, seed=1,
                    device="cpu").numpy()
    assert np.abs(img - box).mean() > 1e-3
    # a wider filter averages more samples a pixel: less pixel noise
    assert np.abs(np.diff(img, axis=1)).mean() < np.abs(
        np.diff(box, axis=1)).mean()
