"""``app/optim_human.pose_gradient(method="prb_reparam")`` of the port
against the JAX package's: the small-size form of its ``@slow`` bridge
check (``tests/test_smpl.py:89-111``: a 72-d pose gradient, finite, its
largest entry above 1e-4) at 16^2, 1 spp, depth 2, the reparameterised
integrator's default 16 auxiliary rays, the image cotangent 1 / (16^2).

Tolerances, each with its reason: the primal image within 1e-5
absolute; the pose gradient within 1e-4 of its largest entry, the bar
of the PRB gradients (``tests/test_torch_prb_reparam.py``): the posed
vertices differ in their last bits between the packages' skinnings, and
the harmonic weights magnify a last-bit difference of the boundary
test.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from epsm_mitsuba3_tpu.app import optim_human as oh_j
from epsm_mitsuba3_tpu.app.exp import human as human_j

from epsm_mitsuba3_torch.app import optim_human as oh_t
from epsm_mitsuba3_torch.app.exp import human as human_t

from torch_threads import one_torch_thread  # noqa: F401

RES, SPP, DEPTH = 16, 1, 2
KW = dict(resolution=RES, spp=SPP, max_depth=DEPTH, match_res=RES)
LEAF_JOINTS = (10, 11, 22, 23)


@pytest.fixture(scope="module")
def gradients():
    ej, et = human_j.make(**KW), human_t.make(device="cpu", **KW)
    g = np.full((RES, RES, 3), 1.0 / (RES * RES), np.float32)
    pg_j, img_j = oh_j.pose_gradient(ej, ej["init_theta"]["pose"],
                                     jnp.asarray(g), SPP, DEPTH, 0, 1,
                                     method="prb_reparam")
    pg_t, img_t = oh_t.pose_gradient(et, et["init_theta"]["pose"],
                                     torch.from_numpy(g), SPP, DEPTH, 0, 1,
                                     method="prb_reparam")
    return (np.asarray(pg_j), np.asarray(img_j), pg_t.numpy(),
            img_t.numpy())


def test_bridge_gives_a_pose_gradient(gradients):
    """JAX's bridge check on the port: shape 72, finite, non-zero."""
    _, _, pg, _ = gradients
    assert pg.shape == (72,)
    assert np.isfinite(pg).all()
    assert np.abs(pg).max() > 1e-4
    by_joint = np.abs(pg).reshape(24, 3).sum(1)
    assert (by_joint[list(LEAF_JOINTS)] == 0).all()


def test_pose_gradient_matches_jax(gradients):
    pg_j, img_j, pg_t, img_t = gradients
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=1e-5)
    scale = np.abs(pg_j).max()
    assert scale > 1e-4
    np.testing.assert_allclose(pg_t, pg_j, rtol=0, atol=1e-4 * scale)
