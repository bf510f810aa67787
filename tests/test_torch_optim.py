"""The port's optimizers and optimization loop against the JAX
package's: ``Adam`` (with ``mask_updates`` and ``uniform``) and ``SGD``
over 10 steps of seeded gradients; ``run("prb_hybrid")`` at ``thres`` 0 on
a 16^2 Cornell box; ``run("prb")``, which both refuse (``prb_reparam_hybrid``
is in ``tests/test_torch_optim_reparam.py``); and ``run`` on the
``cornellbox`` light-ring experiment at 32^2: ``manifold_caustic`` for 10
iterations (``tests/test_torch_optim_manifold.py`` runs ``manifold`` and
``manifold_caustic_hybrid`` for 3).

Tolerances, each with its reason:

- the optimizers: within 1e-6 (float32 arithmetic of the same formula,
  ``lr_scale`` computed in Python doubles by both);
- ``run("prb_hybrid")``: theta within 1e-5 at each iteration.  Adam's
  first steps are about lr * sign(gradient), so the gradients' signs,
  which agree, decide theta;
- the ``cornellbox`` runs (32^2, depth 4): theta within 1e-3 of its
  largest entry at each iteration, with both packages' Sinkhorn matcher
  replaced by one that answers every call with the same OT gradient (the
  port's, in float64, of the first iteration).  The real matchers answer
  a 1-ulp change of their input with up to 1.6e-3 of their largest entry
  (JAX's own at 32^2: eps = 1e-4 magnifies each rounding by 1e4), and
  the two renders differ in their last bits, so no two runs see the same
  OT gradient; given the same one, the port's theta gradient is JAX's
  within 1e-5 relative.  The matchers are held against each other in
  ``tests/test_torch_sinkhorn.py``, and one run here uses the port's own.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.ad import optimizers as opt_j
from epsm_mitsuba3_tpu.app import optim as optim_j
from epsm_mitsuba3_tpu.app.exp import cornellbox as cornellbox_j
from scenes import cornell_box as cornell_box_jax

from epsm_mitsuba3_torch.ad import optimizers as opt_t
from epsm_mitsuba3_torch.app import optim as optim_t
from epsm_mitsuba3_torch.app.exp import cornellbox as cornellbox_t
from epsm_mitsuba3_torch.ops import sinkhorn as sinkhorn_t
import epsm_mitsuba3_torch as mt

from test_torch_render import port_scene_of
from torch_threads import one_torch_thread  # noqa: F401


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


def _box_case(d=None):
    """``run``'s experiment dicts in both packages: the left wall's
    reflectance of ``d`` (default ``cornell_box(16, 4, 3)``) as theta."""
    sj = mi.load_dict(d or cornell_box_jax(res=16, spp=4, max_depth=3))
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
    exp_j = dict(common, scene=sj, apply=apply_j,
                 init_theta={"refl": jnp.asarray(init)},
                 target_theta={"refl": jnp.asarray(target)})
    exp_t = dict(common, scene=st, apply=apply_t,
                 init_theta={"refl": torch.from_numpy(init)},
                 target_theta={"refl": torch.from_numpy(target)})
    return exp_j, exp_t, init


def test_run_prb_tracks_jax():
    """Three ``prb_hybrid`` iterations at ``thres`` 0, so every iteration
    takes the PRB render's mean squared error, recovering the left wall's
    reflectance."""
    exp_j, exp_t, init = _box_case()
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


@pytest.mark.parametrize("method", ["prb", "path", "prb_reparam"])
def test_run_prb_without_hybrid_refused_as_jax(method):
    """Without ``_hybrid`` the reference's ``run`` takes the 5-channel OT
    loss for every method; for ``prb``, ``prb_reparam`` and ``path``,
    whose image has 3 channels, it fails at ``img * g_full``
    (``app/optim.py:100``).  The port refuses the same methods, before
    rendering anything."""
    exp_j, exp_t, _ = _box_case()
    exp_j["gt_spp"] = 1
    with pytest.raises(TypeError, match="broadcast"):
        optim_j.run(method, exp_j, verbose=False, iters=1)
    with pytest.raises(ValueError, match="OT loss"):
        optim_t.run(method, exp_t, iters=1)


def test_run_unknown_method_refused():
    """A method that names no integrator raises before rendering
    anything."""
    _, exp_t, _ = _box_case()
    with pytest.raises(ValueError, match="unknown method"):
        optim_t.run("reparam", exp_t, iters=1)


CORNELL = dict(resolution=32, spp=4, match_res=32, max_depth=4)


@pytest.fixture(scope="module")
def ot_field():
    """The OT gradient (32^2, 5) of the port's first cornellbox iteration:
    its Sinkhorn matcher, in float64, between the initial render and the
    ground truth."""
    exp = cornellbox_t.make(it=1, thres=10 ** 9, device="cpu", **CORNELL)
    with torch.no_grad():
        gt = mt.render(exp["apply"](exp["scene"], exp["target_theta"]),
                       spp=16, seed=0, sensor=0, device="cpu",
                       integrator={"type": "path", "max_depth": 4})
        img = mt.render(exp["apply"](exp["scene"], exp["init_theta"]),
                        spp=4, seed=0, sensor=1, device="cpu",
                        integrator={"type": "path", "max_depth": 4})
        lo = [optim_t._resize(x[..., :3], 32).reshape(-1, 3).double()
              for x in (img, gt)]
        g5 = sinkhorn_t.Matcher(32, device="cpu").match_Sinkhorn(*lo)
    return g5.float().numpy()


@pytest.fixture
def fixed_matchers(monkeypatch, ot_field):
    """Both packages' Matcher replaced by one that answers every call with
    the fixed OT gradient ``ot_field``."""
    class FixedJ:
        def __init__(self, res, **_):
            pass

        def match_Sinkhorn(self, render_rgb, gt_rgb):
            return jnp.asarray(ot_field)

    class FixedT(FixedJ):
        def match_Sinkhorn(self, render_rgb, gt_rgb):
            return torch.from_numpy(ot_field.copy()).to(render_rgb.device)

    monkeypatch.setattr(optim_j, "Matcher", FixedJ)
    monkeypatch.setattr(optim_t, "Matcher", FixedT)


def _cornellbox_runs(method, iters, thres, max_depth=4):
    """The JAX and the port's ``run(method)`` on ``cornellbox`` at 32^2 x 4
    spp, ground truth at 16 spp, Adam at lr 0.08
    (``tests/test_experiments.py:29``)."""
    kw = dict(CORNELL, max_depth=max_depth)
    exp_j = cornellbox_j.make(it=iters, thres=thres, **kw)
    exp_t = cornellbox_t.make(it=iters, thres=thres, device="cpu", **kw)
    exp_j["gt_spp"] = exp_t["gt_spp"] = 16
    _, hist_j = optim_j.run(method, exp_j, verbose=False, adam_lr=0.08)
    losses = []
    _, hist_t = optim_t.run(method, exp_t, adam_lr=0.08,
                            log=lambda it, loss, theta: losses.append(loss))
    th_j = np.asarray([[float(h[f"rot{i}"]) for i in range(6)]
                       for h in hist_j])
    th_t = np.asarray([[float(h[f"rot{i}"]) for i in range(6)]
                       for h in hist_t])
    return th_j, th_t, losses


def _assert_tracks(th_j, th_t, losses, iters):
    assert th_t.shape == th_j.shape == (iters, 6)
    assert np.isfinite(losses).all() and len(losses) == iters
    for it in range(iters):
        np.testing.assert_allclose(th_t[it], th_j[it], rtol=0,
                                   atol=1e-3 * np.abs(th_j[it]).max(),
                                   err_msg=f"iteration {it}")
    assert np.abs(th_t[-1] - np.pi / 3).max() > 0.05    # theta moved


def test_run_manifold_caustic_cornellbox_tracks_jax(fixed_matchers):
    th_j, th_t, losses = _cornellbox_runs("manifold_caustic", 10, 10 ** 9)
    _assert_tracks(th_j, th_t, losses, 10)


def test_run_manifold_caustic_with_sinkhorn_matcher():
    """The port's loop with its own Sinkhorn matcher, at 16^2 x 2 spp: two
    iterations move theta, finite; the matcher itself is held against
    JAX's in ``tests/test_torch_sinkhorn.py``."""
    exp_t = cornellbox_t.make(it=2, thres=10 ** 9, device="cpu",
                              resolution=16, spp=2, match_res=16,
                              max_depth=4)
    exp_t["gt_spp"] = 4
    losses = []
    _, hist = optim_t.run("manifold_caustic", exp_t, adam_lr=0.08,
                          log=lambda it, loss, theta: losses.append(loss))
    th = np.asarray([[float(h[f"rot{i}"]) for i in range(6)] for h in hist])
    assert np.isfinite(th).all() and np.isfinite(losses).all()
    assert np.abs(th[-1] - np.pi / 3).min() > 0.01    # every angle moved
