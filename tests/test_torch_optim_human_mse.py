"""The MSE branch of the port's ``app/optim_human.run`` against the JAX
package's: three ``path`` iterations of the ``human`` experiment at
16^2, spp 1, depth 3 (ground truth at 4 spp, sensor 0).  The cotangent
is 2 (img - ref) / n through PRB, whose detached geometry gives the
body's vertices no gradient in either package (``tests/test_smpl.py``'s
bridge check names ``prb_reparam`` for that): the pose stays at its
initial value exactly, in both.

Tolerances: each iteration's loss within 1e-5 relative (the primal
images agree to float32 rounding); the pose exactly as JAX's.
"""
import numpy as np
import torch

from epsm_mitsuba3_tpu.app import optim_human as oh_j

from epsm_mitsuba3_torch.app import optim_human as oh_t
from epsm_mitsuba3_torch.app.exp import human as human_t

from test_torch_optim_human import record_poses
from torch_threads import one_torch_thread  # noqa: F401

KW = dict(resolution=16, spp=1, max_depth=3, match_res=16)


def test_run_path_mse_tracks_jax(monkeypatch):
    poses_j = record_poses(monkeypatch, oh_j, lambda x: np.array(x))
    poses_t = record_poses(monkeypatch, oh_t, lambda x: x.numpy().copy())
    pose_j, hist_j = oh_j.run("path", iters=3, verbose=False, **KW)
    pose_t, hist_t = oh_t.run("path", iters=3, verbose=False, device="cpu",
                              **KW)
    assert len(poses_t) == len(poses_j) == len(hist_t) == 3
    np.testing.assert_allclose(hist_t, hist_j, rtol=1e-5, atol=0)
    assert len(set(hist_t)) == 3          # a new seed each iteration
    init = human_t.make(device="cpu", **KW)["init_theta"]["pose"].numpy()
    for p_t, p_j in zip(poses_t, poses_j):
        assert np.array_equal(p_j, init)
        assert np.array_equal(p_t, init)
    assert torch.equal(pose_t, torch.from_numpy(init))
