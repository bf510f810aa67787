"""Forward mode: ``render_forward`` of the port against the JAX package's,
and against the port's own backward; the custom tangent rules of
``core/math.py`` against ``jax.jvp``; the tangent helpers of
``ad/prb.py``.  ``prb_reparam``'s forward mode is in
``tests/test_torch_forward_reparam.py`` (the JAX compiles spread over the
test workers).

Tolerances, each with its reason:

- the jvp rules: 2 ulp of float32 (rtol 2.4e-7), the same formulas in
  XLA and PyTorch;
- the image tangent against JAX: within 1e-4 of its largest entry, the
  bar of ``tests/test_torch_prb.py``'s gradients (the same paths from
  the same sampler streams, the port's fused replay taking the remaining
  radiance from the attached NEE term);
- forward against backward, <dimg, W> against d/dθ <img, W>: rtol 2e-3,
  the bar of the JAX package's ``tests/test_render_forward.py:52-71``
  (both linearise the same Lo; float32 sums in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.ad import prb as prb_j
from epsm_mitsuba3_tpu.core import math as math_j
from scenes import cornell_box as cornell_box_jax

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.ad import prb as prb_t
from epsm_mitsuba3_torch.core import math as math_t
from epsm_mitsuba3_torch.scenes import cornell_box, cornell_box_mesh

from test_torch_render import port_scene_of
from torch_threads import one_torch_thread  # noqa: F401

RES, SPP, DEPTH = 16, 2, 2
PRB = {"type": "prb", "max_depth": DEPTH}

#: lanes on both sides of each rule's clamp
_X = np.array([-2.0, -1.0, -1e-30, 0.0, 1e-30, 1e-25, 1e-24, 1e-23, 1e-6,
               0.3, 0.999999, 0.9999995, 1.0, 1.5, 2.0], np.float32)


def _jvp_t(fn, *xs_and_ts):
    import torch.autograd.forward_ad as fwAD
    n = len(xs_and_ts) // 2
    with fwAD.dual_level():
        duals = [fwAD.make_dual(torch.from_numpy(x), torch.from_numpy(t))
                 for x, t in zip(xs_and_ts[:n], xs_and_ts[n:])]
        out = fn(*duals)
        return (fwAD.unpack_dual(out).primal.numpy(),
                fwAD.unpack_dual(out).tangent.numpy())


_UNARY = {
    "safe_sqrt": (math_t.safe_sqrt, math_j.safe_sqrt),
    "safe_rsqrt": (math_t.safe_rsqrt, math_j.safe_rsqrt),
    "safe_acos": (math_t.safe_acos, math_j.safe_acos),
    "safe_rcp": (math_t.safe_rcp, math_j.safe_rcp),
}


def _assert_same(got, ref):
    np.testing.assert_allclose(got, ref, rtol=2.4e-7, atol=0)


@pytest.mark.parametrize("name", sorted(_UNARY))
def test_unary_jvp_matches_jax(name):
    """The tangent of each guarded function on lanes in and out of its
    clamp, the port's ``safe_rsqrt`` included: 0 below 1e-24 in both
    forward modes (the reverse modes differ there, ``ROADMAP.md``
    queue 3)."""
    fn_t, fn_j = _UNARY[name]
    dx = np.random.default_rng(1).normal(size=_X.shape).astype(np.float32)
    out_t, dout_t = _jvp_t(fn_t, _X, dx)
    out_j, dout_j = jax.jvp(fn_j, (jnp.asarray(_X),), (jnp.asarray(dx),))
    _assert_same(out_t, np.asarray(out_j))
    _assert_same(dout_t, np.asarray(dout_j))
    assert np.isfinite(dout_t[np.abs(_X) > 1e-20]).all()


def test_normalize_jvp_matches_jax():
    """``normalize``'s tangent, degenerate vectors (|a|^2 <= 1e-24)
    included."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(64, 3)).astype(np.float32)
    a[:8] *= np.float32(1e-13)
    a[8] = 0.0
    da = rng.normal(size=a.shape).astype(np.float32)
    out_t, dout_t = _jvp_t(math_t.normalize, a, da)
    out_j, dout_j = jax.jvp(math_j.normalize, (jnp.asarray(a),),
                            (jnp.asarray(da),))
    _assert_same(out_t, np.asarray(out_j))
    np.testing.assert_allclose(dout_t, np.asarray(dout_j), rtol=1e-6,
                               atol=1e-6)
    assert (dout_t[:9] == 0).all()


def test_safe_div_jvp_matches_jax():
    """``safe_div``'s tangent in both arguments, denominators below and
    above its 1e-18 guard and its eps."""
    rng = np.random.default_rng(3)
    y = np.concatenate([_X, rng.uniform(0.1, 3.0, 17).astype(np.float32)])
    x = rng.normal(size=y.shape).astype(np.float32)
    dx, dy = (rng.normal(size=y.shape).astype(np.float32) for _ in range(2))
    out_t, dout_t = _jvp_t(math_t.safe_div, x, y, dx, dy)
    out_j, dout_j = jax.jvp(math_j.safe_div, (jnp.asarray(x), jnp.asarray(y)),
                            (jnp.asarray(dx), jnp.asarray(dy)))
    _assert_same(out_t, np.asarray(out_j))
    _assert_same(dout_t, np.asarray(dout_j))


def test_tangent_helpers():
    """``zero_tangent`` / ``zero_cotangent`` name every float leaf;
    ``scene_tangents`` reshapes and casts a given tangent, zeros the rest,
    and refuses a name that is no float leaf."""
    sc = mt.load_dict(cornell_box(res=8, spp=1), device="cpu")
    leaves = prb_t.split_scene(sc)
    for zero in (prb_t.zero_tangent(sc), prb_t.zero_cotangent(sc)):
        assert list(zero) == list(leaves)
        assert all((z == 0).all() and z.shape == leaves[k].shape
                   for k, z in zero.items())
    flat = np.arange(leaves["vertices"].numel(), dtype=np.float64)
    tan = prb_t.scene_tangents(sc, {"vertices": flat})
    assert tan["vertices"].dtype == torch.float32
    assert torch.equal(tan["vertices"].flatten(),
                       torch.from_numpy(flat).float())
    assert float(tan["emitters.radiance"].abs().sum()) == 0.0
    with pytest.raises(KeyError, match="faces"):
        prb_t.scene_tangents(sc, {"faces": torch.zeros(12, 3)})
    merged = prb_t.merge_scene({"vertices": tan["vertices"]}, sc)
    assert torch.equal(merged.vertices, tan["vertices"])


def test_render_forward_refusals_and_zero_tangent():
    """Another integrator raises with its name; no tangent gives a zero
    image tangent."""
    sc = mt.load_dict(cornell_box(res=8, spp=1, max_depth=2), device="cpu")
    for kind in ("direct", "direct_reparam", "manifold"):
        with pytest.raises(NotImplementedError, match=kind):
            mt.render_forward(sc, None, spp=1, device="cpu",
                              integrator={"type": kind})
    dimg = mt.render_forward(sc, None, spp=1, device="cpu", integrator=PRB)
    assert dimg.shape == (8, 8, 3) and float(dimg.abs().sum()) == 0.0


def _box():
    sj = mi.load_dict(cornell_box_jax(res=RES, spp=SPP, max_depth=DEPTH))
    return sj, port_scene_of(sj)


def test_render_forward_matches_jax():
    """The image tangent of the reflectances and the radiance together,
    against the JAX package's ``render_forward``."""
    sj, st = _box()
    rng = np.random.default_rng(4)
    T = {"bsdfs.reflectance": rng.normal(
             size=np.shape(sj.bsdfs["reflectance"])).astype(np.float32),
         "emitters.radiance": rng.normal(
             size=np.shape(sj.emitters["radiance"])).astype(np.float32)}
    dj = prb_j.zero_tangent(sj)
    dj = dj.replace(
        bsdfs={**dj.bsdfs, "reflectance": jnp.asarray(T["bsdfs.reflectance"])},
        emitters={**dj.emitters,
                  "radiance": jnp.asarray(T["emitters.radiance"])})
    ref = np.asarray(mi.render_forward(sj, dj, seed=0, spp=SPP,
                                       integrator=PRB))
    got = mt.render_forward(st, {k: torch.from_numpy(v) for k, v in T.items()},
                            seed=0, spp=SPP, device="cpu",
                            integrator=PRB).numpy()
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale)


def assert_forward_is_backward(st, tangents, integrator, spp=SPP, seed=0,
                               rtol=2e-3):
    """<dimg, W> of ``render_forward`` against d/dθ <img, W> of the
    port's backward at the same seed, θ moving the leaves along
    ``tangents``; returns dimg."""
    W = torch.from_numpy(np.random.default_rng(5).uniform(
        0.25, 1.0, (st.sensors[0].height, st.sensors[0].width, 3)
    ).astype(np.float32))
    dimg = mt.render_forward(st, tangents, seed=seed, spp=spp, device="cpu",
                             integrator=integrator)
    lv = {k: st.leaves()[k].clone().requires_grad_(True) for k in tangents}
    img = mt.render(st.with_leaves(lv), seed=seed, spp=spp, device="cpu",
                    integrator=integrator)
    g = torch.autograd.grad((img * W).sum(), list(lv.values()))
    g_bwd = float(sum((gk * tangents[k]).sum() for k, gk in zip(lv, g)))
    g_fwd = float((dimg * W).sum())
    assert np.isfinite(g_fwd) and abs(g_bwd) > 1e-4
    assert abs(g_fwd - g_bwd) <= rtol * abs(g_bwd), (g_fwd, g_bwd)
    return dimg


@pytest.mark.parametrize("leaf", ["bsdfs.reflectance", "emitters.radiance",
                                  "vertices"])
def test_forward_equals_backward(leaf):
    """A JVP against a VJP of ``prb`` for each leaf alone (the walls with
    face normals, so that the vertices take a gradient)."""
    d = cornell_box(res=RES, spp=SPP, max_depth=DEPTH)
    for k in ("floor", "ceiling", "back", "left", "right"):
        d[k]["face_normals"] = True
    st = mt.load_dict(d, device="cpu")
    gen = torch.Generator().manual_seed(6)
    t = torch.randn(st.leaves()[leaf].shape, generator=gen)
    assert_forward_is_backward(st, {leaf: t}, PRB)


def test_forward_equals_backward_on_the_mesh():
    """A vertex tangent on ``cornell_box_mesh``'s sphere (5,000 triangles
    through the BVH, outward vertex normals): the hit point's re-derived
    barycentrics carry the tangent into the shading normal, which a
    forward pass without the Möller-Trumbore re-derivation
    (``ops/intersect.py`` ``_carries_derivative``) gives as zero."""
    d = cornell_box_mesh(res=RES, spp=SPP, max_depth=DEPTH, subdiv=50)
    d["blob"]["normals"] = d["blob"]["vertices"] - np.asarray(
        [0.0, 0.7, 0.0], np.float32)
    st = mt.load_dict(d, device="cpu")
    assert st.bvh is not None
    gen = torch.Generator().manual_seed(7)
    t = torch.zeros_like(st.vertices)
    s, c = st.static.vertex_ranges[st.static.shape_names.index("blob")]
    t[s:s + c] = torch.randn((c, 3), generator=gen)
    dimg = assert_forward_is_backward(st, {"vertices": t}, PRB)
    assert float(dimg.abs().max()) > 0
