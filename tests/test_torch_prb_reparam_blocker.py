"""``render(..., integrator={"type": "prb_reparam"})`` of the port against
the JAX package's on the blocker scene of the JAX package's
``tests/test_reparam.py`` (a floor, a square blocker, an area light:
moving shadow edges), at 16^2, 2 spp, depth 2, 4 auxiliary rays; and the
reparameterised integrator's primal, which is the path tracer's.

Tolerances: as in ``tests/test_torch_prb_reparam.py`` (images by
``assert_images_close``, gradients within 1e-4 of their largest entry);
the primals bit for bit.
"""
import torch

import epsm_mitsuba3_torch as mt
from test_reparam import _make

from test_torch_prb_reparam import DEPTH, RES, SPP, assert_render_matches_jax
from test_torch_render import port_scene_of
from torch_threads import one_torch_thread  # noqa: F401


def blocker_jax():
    sj = _make()
    sensors = tuple(s.replace(width=RES, height=RES) for s in sj.sensors)
    return sj.replace(sensors=sensors)


def test_image_and_gradients_match_jax():
    assert_render_matches_jax(blocker_jax())


def test_reparam_primal_is_the_path_tracers():
    """Without a gradient the pass is the path tracer's primal render,
    bit for bit ``path``'s."""
    st = port_scene_of(blocker_jax())
    imgs = [mt.render(st, spp=SPP, seed=4, device="cpu",
                      integrator={"type": k, "max_depth": DEPTH})
            for k in ("path", "prb_reparam")]
    assert torch.equal(imgs[0], imgs[1])
