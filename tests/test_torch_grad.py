"""The port's gradient rules against the JAX package's: the custom tangent
rules of ``core/math.py``, the vector-Jacobian products of
``compute_surface_interaction`` in its three ``ray_flags`` regimes, and
``film_adjoint``.

Tolerances, each with its reason:

- the tangent rules: primal and gradient within rtol 1e-6 / atol 1e-6
  (one float32 ulp or two: XLA and PyTorch order the same arithmetic
  differently), infinities equal, and exactly 0 where the reference's
  rule detaches.  Where JAX's reverse mode of ``safe_rsqrt`` gives NaN
  (it transposes the masked tangent ``-0.5 out^3 dx`` with ``out^3 =
  inf`` below x ~ 1e-26, so ``0 * inf``), the port gives the rule's 0
  (``ROADMAP.md`` §3);
- the surface interaction: gradients within 1e-4 of the largest
  entry (a sum over hundreds of rays, gathered by index, in another
  order in each framework);
- ``film_adjoint``: equal (a mean over samples, exact in float32 for a
  power-of-two spp).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.ad import prb as prb_j
from epsm_mitsuba3_tpu.core import math as mj
from epsm_mitsuba3_tpu.models.records import (
    PreliminaryIntersection as PIJ, Ray as RayJ, RayFlags as RFJ)
from epsm_mitsuba3_tpu.ops import intersect as IJ
from scenes import cornell_box_mesh as cornell_box_mesh_jax

from epsm_mitsuba3_torch.ad import prb as prb_t
from epsm_mitsuba3_torch.core import math as mt_math
from epsm_mitsuba3_torch.models.records import Ray as RayT, RayFlags as RFT
from epsm_mitsuba3_torch.ops import intersect as IT

from test_torch_render import port_scene_of

RTOL = ATOL = 1e-6


def _vjp_jax(fn, args, cot):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _vjp_torch(fn, args, cot):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(cot),
                                allow_unused=True)
    return out.detach().numpy(), [
        np.zeros_like(a) if g is None else g.numpy()
        for a, g in zip(args, grads)]


def _check_rule(fn_j, fn_t, args, seed=0):
    shape = jax.eval_shape(fn_j, *[jnp.asarray(a) for a in args]).shape
    cot = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    out_j, g_j = _vjp_jax(fn_j, args, cot)
    out_t, g_t = _vjp_torch(fn_t, args, cot)
    np.testing.assert_allclose(out_t, out_j, rtol=RTOL, atol=ATOL)
    for a, b in zip(g_t, g_j):
        assert not np.isnan(a).any()
        nan = np.isnan(b)
        assert (a[nan] == 0).all()
        np.testing.assert_allclose(a[~nan], b[~nan], rtol=RTOL, atol=ATOL)
    return g_t


def _scalars(*special):
    r = np.random.default_rng(1)
    return np.concatenate([r.uniform(-2, 2, 64),
                           np.asarray(special)]).astype(np.float32)


@pytest.mark.parametrize("name,special", [
    ("safe_sqrt", (0.0, -1.0, 1e-30, 1e-12)),
    ("safe_rsqrt", (0.0, -1.0, 1e-30, 1e-25, 1e-24, 1e-23)),
    ("safe_acos", (1.0, -1.0, 1.0 - 1e-7, 1.5, -3.0)),
    ("safe_rcp", (0.0, 1e-20, -1e-20)),
])
def test_unary_rule_matches_jax(name, special):
    x = _scalars(*special)
    g = _check_rule(getattr(mj, name), getattr(mt_math, name), (x,))[0]
    if name in ("safe_sqrt", "safe_rsqrt"):
        # detached at and below the clamp, where the plain formula's
        # derivative is infinite or overflows
        lo = 0.0 if name == "safe_sqrt" else 1e-24
        assert (g[-len(special):][x[-len(special):] <= lo] == 0).all()


def test_safe_div_rule_matches_jax():
    r = np.random.default_rng(2)
    x = r.normal(size=(70, 3)).astype(np.float32)
    y = np.concatenate([r.uniform(0.1, 3, 64),
                        [0.0, -1.0, 1e-19, 1e-21, 2e-18, 1e-17]]
                       ).astype(np.float32)[:, None]
    g_x, g_y = _check_rule(mj.safe_div, mt_math.safe_div, (x, y))
    # the denominator's partial is detached where y <= 1e-18 (the plain
    # form gives -x / y^2 = inf there)
    assert (g_y[64:68] == 0).all() and (g_y[68:] != 0).all()


def test_normalize_rule_matches_jax():
    r = np.random.default_rng(3)
    # |a|^2 = 0, 1e-26 and 2.5e-25 are detached; 1e-22 is not
    a = np.concatenate([r.normal(size=(64, 3)),
                        [[0, 0, 0], [1e-13, 0, 0], [0, 5e-13, 0],
                         [1e-11, 0, 0]]]).astype(np.float32)
    g = _check_rule(mj.normalize, mt_math.normalize, (a,))[0]
    assert (g[64:67] == 0).all() and (g[67] != 0).any()


# -- compute_surface_interaction -------------------------------------------

@pytest.fixture(scope="module")
def mesh_case():
    """A 16^2 cornell_box_mesh whose sphere carries outward vertex normals
    (so the shading normal depends on the barycentrics), and 512 rays
    from inside the box with their hits."""
    d = cornell_box_mesh_jax(res=16, spp=1, subdiv=12)
    d["blob"]["normals"] = d["blob"]["vertices"] - np.float32([0, 0.7, 0])
    sj = mi.load_dict(d)
    st = port_scene_of(sj)
    r = np.random.default_rng(4)
    n = 512
    o = r.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    o[:, 1] += 1.0
    dirs = r.normal(size=(n, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(
        np.float32)
    pi = st.ray_intersect_preliminary(
        RayT.make(torch.from_numpy(o), torch.from_numpy(dirs)))
    assert float(pi.valid.float().mean()) > 0.8   # the box's front is open
    return sj, st, o, dirs, pi


_FIELDS = ("p", "n", "sh_n", "wi", "uv", "t")


def _si_sum(si, cots, where):
    total = 0.0
    for name, c in zip(_FIELDS, cots):
        x = getattr(si, name)
        if name == "t":
            x = where(si.valid, x, 0.0)          # t is +inf on a miss
        total = total + (x * c).sum()
    return total


@pytest.mark.parametrize("flags", ["default", "DetachShape", "FollowShape"])
def test_surface_interaction_vjp_matches_jax(mesh_case, flags):
    """The VJP of the interaction's p, n, sh_n, wi, uv and t w.r.t. the
    vertices, the vertex normals and the ray, in each gradient regime:
    default (t, u, v re-derived by Moeller-Trumbore), DetachShape and
    FollowShape (t recomputed from the moved point)."""
    sj, st, o, d, pi = mesh_case
    fj = RFJ.All | (0 if flags == "default" else getattr(RFJ, flags))
    ft = RFT.All | (0 if flags == "default" else getattr(RFT, flags))
    pij = PIJ(t=jnp.asarray(pi.t.numpy()),
              prim_uv=jnp.asarray(pi.prim_uv.numpy()),
              prim_index=jnp.asarray(pi.prim_index.numpy()),
              valid=jnp.asarray(pi.valid.numpy()))
    r = np.random.default_rng(5)
    shapes = {"p": (512, 3), "n": (512, 3), "sh_n": (512, 3),
              "wi": (512, 3), "uv": (512, 2), "t": (512,)}
    cots = [r.normal(size=shapes[k]).astype(np.float32) for k in _FIELDS]
    args = (np.asarray(sj.vertices), np.asarray(sj.normals), o, d)

    def fn_j(v, nrm, ro, rd):
        si = IJ.compute_surface_interaction(
            sj.replace(vertices=v, normals=nrm), RayJ.make(ro, rd), pij, fj)
        return _si_sum(si, [jnp.asarray(c) for c in cots], jnp.where)

    def fn_t(v, nrm, ro, rd):
        si = IT.compute_surface_interaction(
            st.with_leaves({"vertices": v, "normals": nrm}),
            RayT.make(ro, rd), pi, ft)
        return _si_sum(si, [torch.from_numpy(c) for c in cots], torch.where)

    one = np.ones((), np.float32)
    _, g_j = _vjp_jax(fn_j, args, one)
    _, g_t = _vjp_torch(fn_t, args, one)
    for name, a, b in zip(("vertices", "normals", "ray.o", "ray.d"), g_t,
                          g_j):
        scale = max(float(np.abs(b).max()), 1e-6)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    g_v = g_t[0]
    if flags == "DetachShape":
        assert (g_v == 0).all() and (g_t[1] == 0).all()
    else:
        assert np.abs(g_v).max() > 0


def test_replace_grad():
    p = torch.tensor([1.0, 2.0])
    g = torch.tensor([5.0, -3.0], requires_grad=True)
    out = IT.replace_grad(p, g * g)
    assert torch.equal(out.detach(), p)
    (dg,) = torch.autograd.grad(out.sum(), g)
    assert torch.equal(dg, 2 * g.detach())


def test_film_adjoint_matches_jax():
    sj = mi.load_dict(cornell_box_mesh_jax(res=8, spp=4, subdiv=6))
    sensor_j = sj.sensors[0]
    st = port_scene_of(sj)
    spp, n = 4, 8 * 8 * 4
    g = np.random.default_rng(6).normal(size=(8, 8, 3)).astype(np.float32)
    pos = jnp.zeros((n, 2), jnp.float32)
    ref = prb_j.film_adjoint(jnp.asarray(g), pos, jnp.ones((n, 3)),
                             sensor_j, spp, n)
    got = prb_t.film_adjoint(torch.from_numpy(g), torch.zeros(n, 2),
                             torch.ones(n, 3), st.sensors[0], spp, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
