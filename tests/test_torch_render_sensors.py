"""Renders of the Cornell box through the port's thin lens, batch and
orthographic sensors against the JAX package's, at 16^2 x 4 spp, depth
2, each with another filter and sampler kind (``render_both`` of
``tests/test_torch_render_filters.py``).  The thin lens draws its
aperture sample after the pixel jitter, which shifts every later draw of
the stratified kinds; the batch sensor renders two views side by side.
Tolerance: ``assert_images_close`` of ``tests/test_torch_render.py``.
"""
import numpy as np
import pytest

from epsm_mitsuba3_torch.core.transform import ScalarTransform4f as T

from test_torch_render import assert_images_close
from test_torch_render_filters import render_both
from torch_threads import one_torch_thread  # noqa: F401


def _batch():
    views = {f"view{i}": {
        "type": "perspective", "fov": 35.0 + 10 * i,
        "to_world": T.look_at(origin=[0.4 * i - 0.2, 1, 3.9],
                              target=[0, 1, 0], up=[0, 1, 0]).matrix}
        for i in range(2)}
    return {"type": "batch", **views}


@pytest.mark.parametrize("sensor,rfilter,sampler", [
    ({"type": "thinlens", "aperture_radius": 0.08, "focus_distance": 3.9},
     "tent", "multijitter"),
    ("batch", "catmullrom", "independent"),
    ({"type": "orthographic",
      "to_world": T.look_at(origin=[0, 1, 3.9], target=[0, 1, 0],
                            up=[0, 1, 0]).scale([0.9, 0.9, 1]).matrix},
     "box", "stratified"),
])
def test_render_matches_jax(sensor, rfilter, sampler):
    if sensor == "batch":
        def sensor_of(d):
            s = d["sensor"]
            d["sensor"] = {**_batch(), "film": {**s["film"], "width": 32},
                           "sampler": s["sampler"]}
        got, ref = render_both(rfilter, sampler, 2, edit=sensor_of)
        assert got.shape == (16, 32, 3)
        # the two views differ
        assert np.abs(got[:, :16] - got[:, 16:]).mean() > 1e-3
    else:
        got, ref = render_both(rfilter, sampler, 2, sensor)
    assert_images_close(got, ref)
