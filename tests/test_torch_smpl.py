"""The port's SMPL body model and rotation maps against the JAX
package's: ``models/smpl.py`` (the procedural template, ``load_npz``,
``lbs`` and its pose VJP) and ``utils/rotation.py`` (``hat``, ``so3_exp``,
``se3_exp``), with JAX's own checks of ``tests/test_smpl.py`` run on the
port.

Tolerances, each with its reason:

- the template, faces, blend weights and rest joints: bit for bit (the
  same host numpy code);
- ``hat``: bit for bit (a sign flip and a copy); ``so3_exp`` and
  ``se3_exp``: within 1e-6 absolute (entries of size <= 1 and the
  translation of size |u|; float32 sin, cos and sqrt of both libraries);
  their VJPs within 1e-5 of the largest entry, finite at w = 0 and at
  |w| = 5e-7 (the small-angle branch) and 2e-6 (Rodrigues); JAX's
  ``se3_exp`` gradient of w at w = 0 is NaN, the port's equals that of
  the branch ``I + hat(w)`` exactly;
- ``lbs``: within 1e-5 absolute (vertices of size <= 2 m; the
  three-operand einsum is contracted weights first in the port, in
  XLA's order in JAX, so the sums round differently);
- the pose VJP: within 1e-5 of its largest entry (the same reason,
  through the 24-joint chain).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from epsm_mitsuba3_tpu.models import smpl as smpl_j
from epsm_mitsuba3_tpu.utils import rotation as rot_j

from epsm_mitsuba3_torch.models import smpl as smpl_t
from epsm_mitsuba3_torch.utils import rotation as rot_t

from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def models():
    return smpl_j.procedural_template(), smpl_t.procedural_template("cpu")


def test_template_equals_jax_bit_for_bit(models):
    mj, mt = models
    assert mt.template.shape == (2112, 3) and mt.faces.shape == (3840, 3)
    assert np.array_equal(mt.template.numpy(), np.asarray(mj.template))
    assert np.array_equal(mt.faces, mj.faces)
    assert mt.faces.dtype == mj.faces.dtype == np.int32
    assert np.array_equal(mt.weights.numpy(), np.asarray(mj.weights))
    assert np.array_equal(mt.joints.numpy(), np.asarray(mj.joints))
    assert np.array_equal(smpl_t.rest_joints(), smpl_j.rest_joints())
    assert mt.parents == mj.parents == smpl_t.SMPL_PARENTS
    assert smpl_t.SMPL_JOINT_NAMES == smpl_j.SMPL_JOINT_NAMES
    assert (smpl_t.N_JOINTS, smpl_t.POSE_DIM) == (24, 72)


def test_from_numpy_carries_a_jax_model(models):
    mj, _ = models
    m = smpl_t.from_numpy(np.asarray(mj.template), mj.faces,
                          np.asarray(mj.weights), np.asarray(mj.joints),
                          mj.parents, device="cpu")
    assert m.template.dtype == torch.float32
    assert m.template.device.type == "cpu"
    assert np.array_equal(m.weights.numpy(), np.asarray(mj.weights))
    assert m.parents == mj.parents


def _axis_angles():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(6, 3)).astype(np.float32)
    unit = w[:2] / np.linalg.norm(w[:2], axis=1, keepdims=True)
    return np.concatenate([
        w, np.zeros((1, 3), np.float32),
        (unit * 5e-7).astype(np.float32), (unit * 2e-6).astype(np.float32),
        (w[:1] * 3.0).astype(np.float32)])


def test_hat_equals_jax():
    w = _axis_angles()
    assert np.array_equal(rot_t.hat(torch.from_numpy(w)).numpy(),
                          np.asarray(rot_j.hat(jnp.asarray(w))))


@pytest.mark.parametrize("name,dim", [("so3_exp", 3), ("se3_exp", 6)])
def test_exp_maps_and_vjps_match_jax(name, dim):
    """At random w, w = 0 and |w| = 5e-7 and 2e-6 (both sides of the
    small-angle branch at theta = 1e-6)."""
    w = _axis_angles()
    if dim == 6:
        u = np.random.default_rng(4).normal(size=w.shape).astype(np.float32)
        w = np.concatenate([w, u], 1)
    fj, ft = getattr(rot_j, name), getattr(rot_t, name)
    out_j, vjp = jax.vjp(fj, jnp.asarray(w))
    x = torch.from_numpy(w).requires_grad_(True)
    out_t = ft(x)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=1e-6)
    cot = np.random.default_rng(5).normal(size=out_t.shape).astype(
        np.float32)
    (g_j,) = vjp(jnp.asarray(cot))
    (g_t,) = torch.autograd.grad(out_t, x, torch.from_numpy(cot))
    g_j, g_t = np.array(g_j), g_t.numpy()
    assert np.isfinite(g_t).all()
    zero = np.linalg.norm(w[:, :3], axis=1) == 0
    if dim == 6:
        # JAX's se3_exp gradient of w at w = 0 is NaN: the masked V
        # branch's (th - s) / (th^3 + 1e-20) has a squared denominator of
        # 1e-40 in its derivative, which XLA's CPU flushes to 0, and the
        # zero cotangent times inf is NaN.  The port's is I + hat(w)'s.
        assert not np.isfinite(g_j[zero, :3]).any()
        assert np.isfinite(np.delete(g_j, np.nonzero(zero)[0], 0)).all()
        w0 = torch.zeros(3, requires_grad=True)
        (g0,) = torch.autograd.grad(
            torch.sum((torch.eye(3) + rot_t.hat(w0))
                      * torch.from_numpy(cot[zero][0, :3, :3])), w0)
        np.testing.assert_array_equal(g_t[zero][0, :3], g0.numpy())
        g_j[zero, :3] = g0.numpy()
    assert np.isfinite(g_j).all()
    np.testing.assert_allclose(g_t, g_j, rtol=0,
                               atol=1e-5 * np.abs(g_j).max())
    # the branch: I + hat(w) below theta = 1e-6, Rodrigues above
    small = np.linalg.norm(w[:, :3], axis=1) < 1e-6
    assert small.sum() == 3
    eye_hat = np.eye(3) + np.asarray(rot_j.hat(jnp.asarray(w[:, :3])))
    assert np.array_equal(out_t.detach().numpy()[small, :3, :3],
                          eye_hat[small].astype(np.float32))


def _poses():
    rng = np.random.default_rng(0)
    return {"zero": np.zeros(72, np.float32),
            "random": rng.uniform(-0.5, 0.5, 72).astype(np.float32),
            "large": rng.uniform(-2.0, 2.0, 72).astype(np.float32)}


@pytest.mark.parametrize("case", ["zero", "random", "large", "trans"])
def test_lbs_matches_jax(models, case):
    mj, mt = models
    pose = _poses()["random" if case == "trans" else case]
    trans = np.asarray([0.3, -1.0, 2.0], np.float32) if case == "trans" \
        else None
    vj = np.asarray(smpl_j.lbs(mj, jnp.asarray(pose),
                               None if trans is None else jnp.asarray(trans)))
    vt = smpl_t.lbs(mt, torch.from_numpy(pose),
                    None if trans is None else torch.from_numpy(trans))
    assert vt.shape == (2112, 3) and vt.dtype == torch.float32
    np.testing.assert_allclose(vt.numpy(), vj, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["zero", "random", "large"])
def test_pose_vjp_matches_jax(models, case):
    """At the zero pose every joint's gradient goes through the small-angle
    branch of ``so3_exp``."""
    mj, mt = models
    pose = _poses()[case]
    cot = np.random.default_rng(1).normal(size=(2112, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda p: smpl_j.lbs(mj, p), jnp.asarray(pose))
    (g_j,) = vjp(jnp.asarray(cot))
    g_j = np.asarray(g_j)
    p = torch.from_numpy(pose).requires_grad_(True)
    (g_t,) = torch.autograd.grad(smpl_t.lbs(mt, p), p, torch.from_numpy(cot))
    g_t = g_t.numpy()
    assert np.isfinite(g_t).all() and np.abs(g_t).max() > 0
    np.testing.assert_allclose(g_t, g_j, rtol=0,
                               atol=1e-5 * np.abs(g_j).max())
    # leaf joints (no bone has them as parent) weight no vertex
    leaves = [10, 11, 22, 23]
    assert np.abs(g_t.reshape(24, 3)[leaves]).max() == 0


# -- JAX's own checks (tests/test_smpl.py), on the port ----------------------

def test_rest_pose_identity(models):
    _, mt = models
    v = smpl_t.lbs(mt, torch.zeros(smpl_t.POSE_DIM))
    assert torch.allclose(v, mt.template, atol=1e-5)


def test_topology_sane(models):
    _, mt = models
    v, w = mt.template.numpy(), mt.weights.numpy()
    assert v.shape[0] > 2000
    assert mt.faces.min() >= 0 and mt.faces.max() < len(v)
    assert np.allclose(w.sum(1), 1.0, atol=1e-5)
    assert (np.count_nonzero(w, axis=1) <= 4).all()   # SMPL top-4 cap


def test_elbow_moves_forearm_only(models):
    _, mt = models
    pose = torch.zeros(smpl_t.POSE_DIM)
    j = smpl_t.SMPL_JOINT_NAMES.index("l_elbow")
    pose[3 * j + 2] = 0.8
    v0 = smpl_t.lbs(mt, torch.zeros(smpl_t.POSE_DIM)).numpy()
    v1 = smpl_t.lbs(mt, pose).numpy()
    moved = np.linalg.norm(v1 - v0, axis=1)
    sub = mt.weights.numpy()[:, [18, 20, 22]].sum(1)
    assert moved[sub > 0.9].mean() > 0.02
    assert moved[sub < 1e-6].max() < 1e-5


def test_root_rotation_is_global(models):
    _, mt = models
    pose = torch.zeros(smpl_t.POSE_DIM)
    pose[1] = np.pi / 2
    v1 = smpl_t.lbs(mt, pose).numpy()
    v0, root = mt.template.numpy(), mt.joints[0].numpy()
    r0 = np.linalg.norm((v0 - root)[:, [0, 2]], axis=1)
    r1 = np.linalg.norm((v1 - root)[:, [0, 2]], axis=1)
    assert np.allclose(r0, r1, atol=1e-4)


def test_pose_jacobian_vs_fd(models):
    _, mt = models
    rng = np.random.default_rng(0)
    pose = torch.from_numpy(rng.uniform(-0.3, 0.3, 72).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(2112, 3)).astype(np.float32))

    def loss(p):
        return torch.sum(smpl_t.lbs(mt, p) * cot)

    p = pose.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(p), p)
    eps = 1e-3
    for j in rng.choice(72, 8, replace=False):
        e = torch.zeros(72)
        e[j] = eps
        fd = (float(loss(pose + e)) - float(loss(pose - e))) / (2 * eps)
        assert abs(fd - float(g[j])) < 0.05 * max(abs(fd), abs(float(g[j])),
                                                  1.0)


def test_trans_offset(models):
    _, mt = models
    v = smpl_t.lbs(mt, torch.zeros(72), trans=torch.tensor([1.0, 2.0, 3.0]))
    assert torch.allclose(v - mt.template, torch.tensor([1.0, 2.0, 3.0]),
                          atol=1e-5)


# -- load_npz -----------------------------------------------------------------

@pytest.mark.parametrize("fields", ["J", "J_regressor"])
def test_load_npz_matches_jax(tmp_path, fields):
    """A synthetic release-style file written here: the capsule body with
    joints given as ``J``, or as a ``J_regressor`` (a seeded row-stochastic
    (24, V) matrix) with a ``kintree_table`` whose root entry is not -1
    (both loaders set it to -1)."""
    v, f = smpl_t._capsule(np.zeros(3, np.float32),
                           np.asarray([0, 1, 0], np.float32), 0.2, 12, 10)
    w = smpl_t._blend_weights(v)
    rng = np.random.default_rng(7)
    data = {"v_template": v.astype(np.float64), "f": f.astype(np.uint32),
            "weights": w.astype(np.float64)}
    if fields == "J":
        data["J"] = smpl_t.rest_joints() + 0.01
    else:
        reg = rng.random((24, len(v)))
        data["J_regressor"] = reg / reg.sum(1, keepdims=True)
        data["kintree_table"] = np.stack([
            np.asarray((4294967295,) + smpl_t.SMPL_PARENTS[1:], np.int64),
            np.arange(24)])
    path = str(tmp_path / "model.npz")
    np.savez(path, **data)
    mj = smpl_j.load_npz(path)
    mt = smpl_t.load_npz(path, device="cpu")
    assert np.array_equal(mt.template.numpy(), np.asarray(mj.template))
    assert np.array_equal(mt.faces, mj.faces) and mt.faces.dtype == np.int32
    assert np.array_equal(mt.weights.numpy(), np.asarray(mj.weights))
    assert np.array_equal(mt.joints.numpy(), np.asarray(mj.joints))
    assert mt.parents == mj.parents and mt.parents[0] == -1
    pose = _poses()["random"]
    np.testing.assert_allclose(
        smpl_t.lbs(mt, torch.from_numpy(pose)).numpy(),
        np.asarray(smpl_j.lbs(mj, jnp.asarray(pose))), rtol=0, atol=1e-5)
