"""``app/optim.run("prb_reparam_hybrid")`` of the port against the JAX
package's, on ``tests/test_torch_optim.py``'s 16^2 Cornell box (the left
wall's reflectance as theta): at ``thres`` 0 every iteration is the
``prb`` MSE step, and theta tracks JAX's within 1e-5 (Adam's first steps
are about lr * sign(gradient)); at ``thres`` > 0 the first iteration
renders ``prb_reparam`` under the 5-channel OT loss, and both packages
fail at ``img * g_full``.
"""
import numpy as np
import pytest

from epsm_mitsuba3_tpu.app import optim as optim_j

from epsm_mitsuba3_torch.app import optim as optim_t

from test_torch_optim import _box_case
from torch_threads import one_torch_thread  # noqa: F401


def test_run_prb_reparam_hybrid_tracks_jax():
    exp_j, exp_t, init = _box_case()
    _, hist_j = optim_j.run("prb_reparam_hybrid", exp_j, verbose=False)
    losses = []
    _, hist_t = optim_t.run("prb_reparam_hybrid", exp_t,
                            log=lambda it, loss, theta: losses.append(loss))
    assert len(hist_t) == len(hist_j) == 3 and len(losses) == 3
    for h_t, h_j in zip(hist_t, hist_j):
        np.testing.assert_allclose(h_t["refl"], np.asarray(h_j["refl"]),
                                   rtol=0, atol=1e-5)
    assert np.abs(hist_t[-1]["refl"] - init).max() > 0.02
    assert np.isfinite(losses).all()


def test_run_prb_reparam_hybrid_before_thres_fails_as_jax():
    """Before ``thres`` the reparameterised render (3 channels) meets the
    5-channel OT gradient: JAX fails to broadcast them, and so does the
    port, at the same product."""
    exp_j, exp_t, _ = _box_case()
    for exp in (exp_j, exp_t):
        exp.update(thres=1, gt_spp=1)
    with pytest.raises(TypeError, match="broadcast"):
        optim_j.run("prb_reparam_hybrid", exp_j, verbose=False, iters=1)
    with pytest.raises(RuntimeError, match="must match the size"):
        optim_t.run("prb_reparam_hybrid", exp_t, iters=1)
