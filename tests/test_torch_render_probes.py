"""Renders of the Cornell box through the port's distant sensor,
radiancemeter and irradiancemeter against the JAX package's, at 16^2 x
4 spp, depth 2 (``render_both`` of ``tests/test_torch_render_filters.py``).
The distant sensor's parallel rays start 1,000 units away; the two
meters send every sample from one point, along the sensor's axis or
cosine-distributed about it.  Tolerance: ``assert_images_close`` of
``tests/test_torch_render.py``.
"""
import pytest

from epsm_mitsuba3_torch.core.transform import ScalarTransform4f as T

from test_torch_render import assert_images_close
from test_torch_render_filters import render_both
from torch_threads import one_torch_thread  # noqa: F401

#: a probe inside the box, looking at the back wall and the floor
PROBE = T.look_at(origin=[0.1, 1.2, 1.5], target=[0, 0.6, -1],
                  up=[0, 1, 0]).matrix


@pytest.mark.parametrize("sensor,rfilter,sampler", [
    ({"type": "distant"}, "gaussian", "orthogonal"),
    ({"type": "radiancemeter", "to_world": PROBE}, "box", "independent"),
    ({"type": "irradiancemeter", "to_world": PROBE}, "tent",
     "stratified"),
])
def test_render_matches_jax(sensor, rfilter, sampler):
    got, ref = render_both(rfilter, sampler, 2, sensor)
    assert_images_close(got, ref)
