"""The port's optimizers and optimization loop against the JAX
package's: ``Adam`` (with ``mask_updates`` and ``uniform``) and ``SGD``
over 10 steps of seeded gradients, and 3 iterations of ``run("prb")``
on a 16^2 Cornell box.

Tolerances, each with its reason:

- the optimizers: within 1e-6 (float32 arithmetic of the same formula,
  ``lr_scale`` computed in Python doubles by both);
- ``run``: theta within 1e-5 at each iteration.  The JAX ``run``'s
  non-hybrid ``prb`` takes the manifold leg's optimal-transport loss
  (``app/optim.py:117-118``, as for every method below ``thres``); its
  ``loss_prb`` leg, which the port's ``run("prb")`` is, runs from the
  first iteration with ``prb_hybrid`` at ``thres`` 0.  Adam's first steps
  are about lr * sign(gradient), so the gradients' signs, which agree,
  decide theta.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.ad import optimizers as opt_j
from epsm_mitsuba3_tpu.app import optim as optim_j
from scenes import cornell_box as cornell_box_jax

from epsm_mitsuba3_torch.ad import optimizers as opt_t
from epsm_mitsuba3_torch.app import optim as optim_t

from test_torch_render import port_scene_of


def _grads(step, mask_zero):
    r = np.random.default_rng(100 + step)
    g = {"a": r.normal(size=(5, 3)).astype(np.float32),
         "b": r.normal(size=(4,)).astype(np.float32)}
    if mask_zero:
        g["a"][step % 5] = 0.0
        g["b"][::2] = 0.0
    return g


@pytest.mark.parametrize("kind,kw", [
    ("Adam", {}), ("Adam", {"mask_updates": True}),
    ("Adam", {"uniform": True}), ("Adam", {"mask_updates": True,
                                           "uniform": True}),
    ("SGD", {}), ("SGD", {"momentum": 0.9})])
def test_optimizer_matches_jax(kind, kw):
    init = {"a": np.linspace(-1, 1, 15, dtype=np.float32).reshape(5, 3),
            "b": np.arange(4, dtype=np.float32)}
    oj = getattr(opt_j, kind)(lr=0.05, params=dict(init), **kw)
    ot = getattr(opt_t, kind)(lr=0.05, params=dict(init), **kw)
    oj.set_learning_rate(0.02, "b")
    ot.set_learning_rate(0.02, "b")
    for step in range(10):
        g = _grads(step, kw.get("mask_updates", False))
        oj.step({k: jnp.asarray(v) for k, v in g.items()})
        ot.step({k: torch.from_numpy(v) for k, v in g.items()})
        for k in init:
            np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    assert not np.allclose(ot["a"].numpy(), init["a"])


def test_optimizer_reset_and_reshape():
    o = opt_t.Adam(lr=0.1, params={"x": torch.zeros(3)})
    o.step({"x": torch.ones(3)})
    assert o.t["x"] == 1
    o.reset("x")
    assert o.t["x"] == 0 and float(o.state["x"][0].abs().sum()) == 0
    o["x"] = torch.zeros(4)               # a new shape resets the state
    assert o.state["x"][0].shape == (4,)
    o.step({"x": torch.full((4,), float("nan"))})   # NaN -> 0 gradient
    assert torch.isfinite(o["x"]).all()


def test_run_prb_tracks_jax():
    """Three iterations recovering the left wall's reflectance."""
    sj = mi.load_dict(cornell_box_jax(res=16, spp=4, max_depth=3))
    st = port_scene_of(sj)
    row = int(np.asarray(sj.shape_bsdf)[3])          # the left wall
    rows = np.arange(np.asarray(sj.bsdfs["reflectance"]).shape[0]) == row

    def apply_j(sc, theta):
        table = jnp.where(rows[:, None], jnp.asarray(theta["refl"])[None],
                          sc.bsdfs["reflectance"])
        return sc.replace(bsdfs={**sc.bsdfs, "reflectance": table})

    def apply_t(sc, theta):
        table = torch.where(torch.from_numpy(rows)[:, None],
                            theta["refl"][None], sc.bsdfs["reflectance"])
        return sc.with_leaves({"bsdfs.reflectance": table})

    common = dict(gt_spp=8, it=3, spp=4, resolution=16, max_depth=3,
                  match_res=16, output=str, thres=0)
    init = np.asarray([0.5, 0.5, 0.5], np.float32)
    target = np.asarray([0.2, 0.6, 0.3], np.float32)
    _, hist_j = optim_j.run(
        "prb_hybrid", dict(common, scene=sj, apply=apply_j,
                           init_theta={"refl": jnp.asarray(init)},
                           target_theta={"refl": jnp.asarray(target)}),
        verbose=False)
    losses = []
    _, hist_t = optim_t.run(
        "prb", dict(common, scene=st, apply=apply_t,
                    init_theta={"refl": torch.from_numpy(init)},
                    target_theta={"refl": torch.from_numpy(target)}),
        log=lambda it, loss, theta: losses.append(loss))
    assert len(hist_t) == len(hist_j) == 3 and len(losses) == 3
    for h_t, h_j in zip(hist_t, hist_j):
        np.testing.assert_allclose(h_t["refl"], np.asarray(h_j["refl"]),
                                   rtol=0, atol=1e-5)
    assert np.abs(hist_t[-1]["refl"] - init).max() > 0.02
    assert np.isfinite(losses).all()


@pytest.mark.parametrize("method", ["manifold", "manifold_caustic",
                                    "prb_hybrid"])
def test_run_manifold_methods_raise(method):
    with pytest.raises(NotImplementedError, match="EPSM"):
        optim_t.run(method, {})
