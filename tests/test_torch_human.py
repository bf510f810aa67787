"""The port's ``human`` experiment and its pose-gradient bridge against
the JAX package's: ``app/exp/human.make`` and ``apply`` at 24^2, and
``app/optim_human.pose_gradient`` with ``manifold`` at 24^2, spp 2,
depth 3, match 24, stage by stage: the renderer's vertex gradient, then
the pose gradient through the skinning's VJP.  The 3-iteration ``run``
comparisons are in ``tests/test_torch_optim_human.py``.

Tolerances, each with its reason:

- the scene's arrays, the body's vertex range and the initial pose: bit
  for bit (the same OBJ text, parsed by the native parser in both, and
  the same numpy draw);
- ``apply``: within 1e-5 absolute (``lbs``, ``tests/test_torch_smpl.py``);
- the primal image within 1e-5 absolute; the vertex gradient and the pose
  gradient within 1e-3 of their largest entry, as the other EPSM tests
  hold the manifold backward (``tests/test_torch_epsm_backward.py``): the
  posed vertices differ in their last bits, and the solves magnify it.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from epsm_mitsuba3_tpu.app import optim_human as oh_j
from epsm_mitsuba3_tpu.app.exp import human as human_j
from epsm_mitsuba3_tpu.models import smpl as smpl_j

from epsm_mitsuba3_torch.app import optim_human as oh_t
from epsm_mitsuba3_torch.app.exp import human as human_t

from torch_threads import one_torch_thread  # noqa: F401

KW = dict(resolution=24, spp=2, max_depth=3, match_res=24)
LEAF_JOINTS = (10, 11, 22, 23)


@pytest.fixture(scope="module")
def exps():
    return human_j.make(**KW), human_t.make(device="cpu", **KW)


def test_make_matches_jax(exps):
    ej, et = exps
    sj, st = ej["scene"], et["scene"]
    assert st.static.shape_names == sj.static.shape_names
    assert st.static.vertex_ranges == sj.static.vertex_ranges
    assert st.static.vertex_ranges[-1] == (8, 2112)
    assert np.array_equal(st.vertices.numpy(), np.asarray(sj.vertices))
    assert np.array_equal(st.faces.numpy(), np.asarray(sj.faces))
    assert st.faces.shape == (3844, 3) and st.bvh is None   # K1: < 4,096
    assert np.array_equal(st.shape_bsdf.numpy(), np.asarray(sj.shape_bsdf))
    for k in ("reflectance", "kind"):
        assert np.array_equal(st.bsdfs[k].numpy(), np.asarray(sj.bsdfs[k])), k
    assert np.array_equal(st.emitters["radiance"].numpy(),
                          np.asarray(sj.emitters["radiance"]))
    assert len(st.sensors) == 3
    assert [s.width for s in st.sensors] == [24, 24, 24]
    assert np.array_equal(et["init_theta"]["pose"].numpy(),
                          np.asarray(ej["init_theta"]["pose"]))
    pose = et["init_theta"]["pose"].numpy().reshape(24, 3)
    assert np.count_nonzero(np.abs(pose).sum(1)) == 4
    assert np.abs(pose[16:20]).min() > 0
    assert et["target_theta"]["pose"].shape == (72,)
    assert float(et["target_theta"]["pose"].abs().max()) == 0
    for k in ("it", "spp", "resolution", "thres", "max_depth", "match_res"):
        assert et[k] == ej[k], k
    assert set(et) == set(ej)
    assert np.array_equal(et["model"].template.numpy(),
                          np.asarray(ej["model"].template))
    assert et["output"](et["init_theta"]) == ej["output"](ej["init_theta"])


def test_apply_matches_jax(exps):
    ej, et = exps
    vj = np.asarray(ej["apply"](ej["scene"], ej["init_theta"]).vertices)
    vt = et["apply"](et["scene"], et["init_theta"]).vertices.numpy()
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-5)
    assert np.array_equal(vt[:8], np.asarray(ej["scene"].vertices)[:8])
    # set_verts is differentiable in the body's vertices
    v = torch.zeros((2112, 3), requires_grad=True)
    sc = et["set_verts"](et["scene"], v)
    (g,) = torch.autograd.grad(sc.vertices[8:].sum(), v)
    assert float(g.min()) == float(g.max()) == 1.0


def _tap_cotangent(seen):
    """An identity whose VJP keeps the cotangent it is handed in
    ``seen``."""
    @jax.custom_vjp
    def tap(x):
        return x

    def bwd(_, g):
        seen.append(np.asarray(g))
        return (g,)

    tap.defvjp(lambda x: (x, None), bwd)
    return tap


def test_pose_gradient_matches_jax_stage_by_stage(exps, monkeypatch):
    """``manifold``, an all-ones 5-channel cotangent, sensor 1, seed 1.
    Each package's ``pose_gradient`` runs once; the vertex gradient of
    its first stage is read on the way: JAX's as the cotangent that
    reaches ``lbs``'s VJP, the port's from ``vertex_gradient``."""
    ej, et = exps
    g5 = np.ones((24, 24, 5), np.float32)
    seen_j, seen_t = [], []
    tap = _tap_cotangent(seen_j)
    monkeypatch.setattr(oh_j, "smpl", type("Shim", (), {
        "lbs": staticmethod(lambda m, p: tap(smpl_j.lbs(m, p)))}))
    pg_j, img_j = oh_j.pose_gradient(ej, ej["init_theta"]["pose"],
                                     jnp.asarray(g5), 2, 3, 1, 1,
                                     "manifold")
    pg_j = np.asarray(pg_j)
    (gv_j,) = seen_j

    vertex_gradient = oh_t.vertex_gradient

    def keep(*a, **kw):
        out = vertex_gradient(*a, **kw)
        seen_t.append(out)
        return out

    monkeypatch.setattr(oh_t, "vertex_gradient", keep)
    pg_t, img_t = oh_t.pose_gradient(et, et["init_theta"]["pose"],
                                     torch.from_numpy(g5), 2, 3, 1, 1,
                                     "manifold")
    ((gv_t, img_t2),) = seen_t
    assert torch.equal(img_t, img_t2)
    assert img_t.shape == (24, 24, 5) and not img_t.requires_grad
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=0,
                               atol=1e-5)
    gv_t, pg_t = gv_t.numpy(), pg_t.numpy()
    assert gv_t.shape == (2112, 3) and pg_t.shape == (72,)
    assert np.isfinite(gv_t).all() and np.isfinite(pg_t).all()
    np.testing.assert_allclose(gv_t, gv_j, rtol=0,
                               atol=1e-3 * np.abs(gv_j).max())
    np.testing.assert_allclose(pg_t, pg_j, rtol=0,
                               atol=1e-3 * np.abs(pg_j).max())
    # non-zero where JAX's is, exactly zero on the leaf joints, which no
    # vertex weights
    by_joint_t = np.abs(pg_t.reshape(24, 3)).sum(1)
    by_joint_j = np.abs(pg_j.reshape(24, 3)).sum(1)
    assert np.array_equal(by_joint_t > 0, by_joint_j > 0)
    assert np.count_nonzero(by_joint_t) == 20
    assert (by_joint_t[[16, 17, 18, 19]] > 0).all()
    assert (by_joint_t[list(LEAF_JOINTS)] == 0).all()
