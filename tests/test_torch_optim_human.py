"""The port's ``app/optim_human.run`` against the JAX package's: three
iterations of the ``human`` experiment at 8^2, spp 1, depth 3, match 8
(ground truth at 4 spp), with ``manifold`` (the 5-channel OT gradient
through the EPSM backward and the skinning's VJP); the MSE branch
(``path``) is in ``tests/test_torch_optim_human_mse.py``.

Tolerances, each with its reason: the pose after each iteration within
1e-3 absolute (entries up to 0.35, Adam steps of ~lr = 0.02).  For
``manifold`` both packages' Sinkhorn matcher is replaced by one that
answers every call with the same OT gradient (the port's, in float64, of
the initial pose), as ``tests/test_torch_optim.py`` does for cornellbox:
the real float32 matchers answer a 1-ulp change of their input with
~1e-3 of their largest entry.  Each iteration's loss within 1e-5
relative (the primal images agree to float32 rounding).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from epsm_mitsuba3_tpu.app import optim_human as oh_j

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.app import optim as optim_t
from epsm_mitsuba3_torch.app import optim_human as oh_t
from epsm_mitsuba3_torch.app.exp import human as human_t
from epsm_mitsuba3_torch.ops import sinkhorn as sinkhorn_t

from torch_threads import one_torch_thread  # noqa: F401

KW = dict(resolution=8, spp=1, max_depth=3, match_res=8)
ITERS = 3


@pytest.fixture(scope="module")
def ot_field():
    """The OT gradient (8^2, 5) of the port's first iteration: its
    matcher, in float64, between the initial render and the ground
    truth."""
    exp = human_t.make(device="cpu", **KW)
    with torch.no_grad():
        gt = mt.render(exp["apply"](exp["scene"], exp["target_theta"]),
                       spp=4, seed=0, sensor=1, device="cpu",
                       integrator={"type": "path", "max_depth": 3})
        img = mt.render(exp["apply"](exp["scene"], exp["init_theta"]),
                        spp=1, seed=1, sensor=1, device="cpu",
                        integrator={"type": "manifold", "max_depth": 3})
        lo = [optim_t._resize(x[..., :3], 8).reshape(-1, 3).double()
              for x in (img, gt)]
        g5 = sinkhorn_t.Matcher(8, device="cpu").match_Sinkhorn(*lo)
    return g5.float().numpy()


def record_poses(monkeypatch, module, to_numpy):
    """Each pose ``module.run``'s Adam holds after a step."""
    poses = []

    class Recording(module.Adam):
        def step(self, grads):
            super().step(grads)
            poses.append(to_numpy(self["pose"]))

    monkeypatch.setattr(module, "Adam", Recording)
    return poses


def test_run_manifold_tracks_jax(monkeypatch, ot_field):
    class FixedJ:
        def __init__(self, res, **_):
            pass

        def match_Sinkhorn(self, render_rgb, gt_rgb):
            return jnp.asarray(ot_field)

    class FixedT(FixedJ):
        def match_Sinkhorn(self, render_rgb, gt_rgb):
            return torch.from_numpy(ot_field.copy())

    monkeypatch.setattr(oh_j, "Matcher", FixedJ)
    monkeypatch.setattr(oh_t, "Matcher", FixedT)
    poses_j = record_poses(monkeypatch, oh_j, lambda x: np.array(x))
    poses_t = record_poses(monkeypatch, oh_t, lambda x: x.numpy().copy())
    pose_j, hist_j = oh_j.run("manifold", iters=ITERS, verbose=False, **KW)
    pose_t, hist_t = oh_t.run("manifold", iters=ITERS, verbose=False,
                              device="cpu", **KW)
    assert len(poses_t) == len(poses_j) == len(hist_t) == ITERS
    np.testing.assert_allclose(hist_t, hist_j, rtol=1e-5, atol=0)
    for p_t, p_j in zip(poses_t, poses_j):
        np.testing.assert_allclose(p_t, p_j, rtol=0, atol=1e-3)
    assert np.array_equal(pose_t.numpy(), poses_t[-1])
    assert np.abs(poses_t[-1] - poses_t[0]).max() > 0.01
    # the leaf joints weight no vertex: no gradient, no step
    leaves = poses_t[-1].reshape(24, 3)[[10, 11, 22, 23]]
    assert np.abs(leaves).max() == 0
