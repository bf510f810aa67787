"""``app/optim.run`` through the camera side: three ``prb_hybrid``
iterations at ``thres`` 0 (``test_run_prb_tracks_jax`` of
``tests/test_torch_optim.py``) on a Cornell box whose film names no
filter, so the hdrfilm's default gaussian applies, and whose sampler is
``stratified``: the ground truth, each PRB render and its film adjoint
run through ``splat_coalesced``.  Tolerance: theta within 1e-5 of JAX's
after each iteration, as in ``test_run_prb_tracks_jax``.
"""
import numpy as np

from epsm_mitsuba3_tpu.app import optim as optim_j
from scenes import cornell_box as cornell_box_jax

from epsm_mitsuba3_torch.app import optim as optim_t

from test_torch_optim import _box_case
from torch_threads import one_torch_thread  # noqa: F401


def test_run_gaussian_stratified_tracks_jax():
    d = cornell_box_jax(res=16, spp=4, max_depth=3)
    del d["sensor"]["film"]["rfilter"]
    d["sensor"]["sampler"]["type"] = "stratified"
    exp_j, exp_t, init = _box_case(d)
    assert exp_t["scene"].sensors[0].rfilter == "gaussian"
    assert exp_t["scene"].static.sampler_kind == "stratified"
    _, hist_j = optim_j.run("prb_hybrid", exp_j, verbose=False)
    losses = []
    _, hist_t = optim_t.run("prb_hybrid", exp_t,
                            log=lambda it, loss, theta: losses.append(loss))
    assert len(hist_t) == len(hist_j) == 3 and len(losses) == 3
    for h_t, h_j in zip(hist_t, hist_j):
        np.testing.assert_allclose(h_t["refl"], np.asarray(h_j["refl"]),
                                   rtol=0, atol=1e-5)
    assert np.abs(hist_t[-1]["refl"] - init).max() > 0.02
    assert np.isfinite(losses).all()
