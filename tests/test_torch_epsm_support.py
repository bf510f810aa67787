"""The EPSM slice's support modules against the JAX package's: the
differentiable transform constructors, ``inv_small``, the smooth
conductor BSDF and its loading, and renders of the FD oracle's mirror
scene (``tests/test_epsm_oracle.py``).

Tolerances, each with its reason:

- transforms and their gradients: rtol 1e-6 / atol 1e-6 (float32, the
  same formulas; XLA and PyTorch order a sum differently);
- ``inv_small``: against JAX's within 1e-5 of the largest entry (the same
  unrolled elimination, rounded alike but for the order of a few
  operations); against ``numpy.linalg.inv`` in float64 within 1e-4
  relative on well-conditioned systems;
- the conductor: rtol 1e-6 / atol 1e-6 (closed-form float32);
- renders: mean |diff| <= 1e-4 and >= 99 % of pixels within 1e-4, as
  ``tests/test_torch_render.py`` (a grazing hit may flip one path).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.core import transform as TJ
from epsm_mitsuba3_tpu.models import bsdf as BJ
from epsm_mitsuba3_tpu.ops.linalg import inv_small as inv_small_j

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.core import transform as TT
from epsm_mitsuba3_torch.models import bsdf as BT
from epsm_mitsuba3_torch.ops.linalg import inv_small as inv_small_t

import test_epsm_oracle as oracle
from test_torch_render import assert_images_close, jax_arrays, port_scene_of
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_transform_constructors_match_jax():
    r = np.random.default_rng(0)
    o, tgt, up = (r.normal(size=3).astype(np.float32) for _ in range(3))
    v3 = r.normal(size=3).astype(np.float32)
    pts = r.normal(size=(7, 3)).astype(np.float32)
    pairs = [
        (TT.translate(torch.from_numpy(v3)), TJ.translate(v3)),
        (TT.scale(torch.from_numpy(v3)), TJ.scale(v3)),
        (TT.scale(0.05), TJ.scale(0.05)),
        (TT.rotate([0.3, -1.0, 0.5], 37.0), TJ.rotate([0.3, -1.0, 0.5], 37.0)),
        (TT.look_at(torch.from_numpy(o), torch.from_numpy(tgt),
                    torch.from_numpy(up)), TJ.look_at(o, tgt, up)),
        (TT.perspective(39.3, 0.01, 100.0), TJ.perspective(39.3, 0.01, 100.0)),
        (TT.identity(), TJ.identity()),
    ]
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=str(i), **TOL)
    t_t = TT.compose(pairs[0][0], pairs[3][0], pairs[1][0])
    t_j = TJ.compose(pairs[0][1], pairs[3][1], pairs[1][1])
    np.testing.assert_allclose(_np(t_t), _np(t_j), **TOL)
    p_t, p_j = torch.from_numpy(pts), jnp.asarray(pts)
    for f in ("apply_point", "apply_vector", "apply_normal"):
        np.testing.assert_allclose(
            _np(getattr(TT, f)(t_t, p_t)), _np(getattr(TJ, f)(t_j, p_j)),
            rtol=1e-5, atol=1e-5, err_msg=f)
    np.testing.assert_allclose(_np(TT.inverse(t_t)), _np(TJ.inverse(t_j)),
                               rtol=1e-5, atol=1e-5)


def test_transform_gradients_match_jax():
    """cornellbox's ring matrix, look_at(...) @ scale(...), differentiated
    w.r.t. the latent angle and applied to points."""
    pts = np.random.default_rng(1).normal(size=(4, 3)).astype(np.float32)

    def ring_j(rot):
        x, y = 0.5 * jnp.sin(rot - 0.4), 0.5 * jnp.cos(rot - 0.4)
        mat = TJ.look_at(jnp.stack([x, 1.0 + y, jnp.asarray(0.1)]),
                         jnp.asarray([0.0, 1.0, -0.3]),
                         jnp.asarray([0.0, 0.0, 1.0])) @ TJ.scale(0.05)
        return jnp.sum(TJ.apply_point(mat, jnp.asarray(pts)) ** 2)

    def ring_t(rot):
        x, y = 0.5 * torch.sin(rot - 0.4), 0.5 * torch.cos(rot - 0.4)
        mat = TT.look_at(torch.stack([x, 1.0 + y, torch.tensor(0.1)]),
                         [0.0, 1.0, -0.3], [0.0, 0.0, 1.0]) @ TT.scale(0.05)
        return torch.sum(TT.apply_point(mat, torch.from_numpy(pts)) ** 2)

    for rot in (0.0, 0.7, -2.1):
        gj = float(jax.grad(ring_j)(jnp.float32(rot)))
        r = torch.tensor(rot, requires_grad=True)
        (gt,) = torch.autograd.grad(ring_t(r), r)
        np.testing.assert_allclose(float(gt), gj, rtol=1e-5, atol=1e-6)
        assert abs(gj) > 1e-3


@pytest.mark.parametrize("n", [2, 4, 10])
def test_inv_small_matches_jax_and_numpy(n):
    r = np.random.default_rng(n)
    M = (r.normal(size=(257, n, n)) + 3.0 * np.eye(n)).astype(np.float32)
    M[::3] = M[::3][:, r.permutation(n)]          # pivoting rows
    got = inv_small_t(torch.from_numpy(M)).numpy()
    ref = np.asarray(inv_small_j(jnp.asarray(M)))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    exact = np.linalg.inv(M.astype(np.float64))
    np.testing.assert_allclose(got, exact, rtol=1e-4,
                               atol=1e-4 * np.abs(exact).max())


def test_inv_small_singular_is_finite_and_matches_jax():
    """Singular systems (a zero row, two equal rows, all zero) give the
    reference's finite result where ``torch.linalg.inv`` would raise for
    the whole batch; the regular system beside them is inverted."""
    n = 6
    r = np.random.default_rng(7)
    good = (r.normal(size=(n, n)) + 3.0 * np.eye(n)).astype(np.float32)
    zero_row = good.copy()
    zero_row[2] = 0.0
    equal_rows = good.copy()
    equal_rows[4] = equal_rows[1]
    M = np.stack([good, zero_row, equal_rows, np.zeros((n, n), np.float32)])
    got = inv_small_t(torch.from_numpy(M)).numpy()
    ref = np.asarray(inv_small_j(jnp.asarray(M)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(got[0] @ good, np.eye(n), atol=1e-5)
    with pytest.raises(RuntimeError):
        torch.linalg.inv(torch.from_numpy(M))


def _conductor_scene_dict(T):
    return {
        "type": "scene",
        "sensor": {"type": "perspective", "fov": 45.0,
                   "film": {"type": "hdrfilm", "width": 8, "height": 8,
                            "rfilter": {"type": "box"}}},
        "a": {"type": "rectangle", "bsdf": {"type": "diffuse"}},
        "b": {"type": "rectangle", "to_world": T.translate([0, 0, 1]),
              "bsdf": {"type": "conductor", "eta": [0.2, 0.9, 1.4],
                       "k": [3.9, 2.4, 1.8],
                       "specular_reflectance": [0.9, 0.8, 0.7]}},
        "c": {"type": "rectangle", "to_world": T.translate([0, 0, 2]),
              "bsdf": {"type": "twosided",
                       "material": {"type": "conductor"}}},
        "light": {"type": "rectangle", "to_world": T.translate([0, 0, 3]),
                  "emitter": {"type": "area", "radiance": 1.0}},
    }


def test_conductor_loads_as_jax():
    sj = mi.load_dict(_conductor_scene_dict(mi.ScalarTransform4f))
    st = mt.load_dict(_conductor_scene_dict(TT.ScalarTransform4f),
                      device="cpu")
    ref = jax_arrays(sj)
    for k, v in st.bsdfs.items():
        np.testing.assert_array_equal(v.numpy(), ref[f"bsdfs.{k}"], k)
    assert st.static.bsdf_kinds == sj.static.bsdf_kinds == (0, 1)
    assert st.static.shape_names == sj.static.shape_names
    assert st.static.vertex_ranges == sj.static.vertex_ranges
    d = _conductor_scene_dict(TT.ScalarTransform4f)
    d["b"]["bsdf"] = {"type": "conductor", "material": "Au"}
    with pytest.raises(NotImplementedError, match="Au"):
        mt.load_dict(d, device="cpu")


def test_conductor_sample_and_eval_match_jax():
    sj = mi.load_dict(_conductor_scene_dict(mi.ScalarTransform4f))
    st = port_scene_of(sj)
    n = 4096
    r = np.random.default_rng(3)
    wi = r.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    wo = r.normal(size=(n, 3)).astype(np.float32)
    s1 = r.random(n).astype(np.float32)
    s2 = r.random((n, 2)).astype(np.float32)
    nb = int(np.asarray(sj.bsdfs["kind"]).shape[0])
    idx = r.integers(-1, nb, n).astype(np.int32)
    active = r.random(n) < 0.9
    kinds = sj.static.bsdf_kinds
    bj, wj, okj = BJ.sample(sj.bsdfs, kinds, jnp.asarray(idx),
                            jnp.asarray(wi), jnp.asarray(s1),
                            jnp.asarray(s2), jnp.asarray(active))
    bt, wt, okt = BT.sample(st.bsdfs, kinds, torch.from_numpy(idx),
                            torch.from_numpy(wi), torch.from_numpy(s1),
                            torch.from_numpy(s2), torch.from_numpy(active))
    for f in ("wo", "pdf", "eta", "hf"):
        np.testing.assert_allclose(_np(getattr(bt, f)), _np(getattr(bj, f)),
                                   err_msg=f, **TOL)
    np.testing.assert_array_equal(_np(bt.sampled_type),
                                  _np(bj.sampled_type).astype(np.int64))
    np.testing.assert_allclose(_np(wt), _np(wj), **TOL)
    np.testing.assert_array_equal(_np(okt), _np(okj))
    is_c = np.asarray(sj.bsdfs["kind"])[np.maximum(idx, 0)] == 1
    assert (is_c & _np(okt)).sum() > 100       # conductor lanes sampled
    vj, pj = BJ.eval_pdf(sj.bsdfs, kinds, jnp.asarray(idx), jnp.asarray(wi),
                         jnp.asarray(wo), jnp.asarray(active))
    vt, pt = BT.eval_pdf(st.bsdfs, kinds, torch.from_numpy(idx),
                         torch.from_numpy(wi), torch.from_numpy(wo),
                         torch.from_numpy(active))
    np.testing.assert_allclose(_np(vt), _np(vj), **TOL)
    np.testing.assert_allclose(_np(pt), _np(pj), **TOL)


@pytest.fixture(scope="module")
def mirror_scenes():
    sj = oracle._framework_scene()
    return sj, port_scene_of(sj)


@pytest.mark.parametrize("kind", ["path", "prb"])
def test_mirror_scene_render_matches_jax(mirror_scenes, kind):
    """The oracle's camera -> conductor mirror -> area light scene."""
    sj, st = mirror_scenes
    integ = {"type": kind, "max_depth": 3}
    ref = np.asarray(mi.render(sj, spp=4, seed=2, integrator=integ))
    img = mt.render(st, spp=4, seed=2, integrator=integ,
                    device="cpu").numpy()
    assert img.shape == (oracle.RES, oracle.RES, 3)
    assert img.max() > 0.1        # the light's reflection is in view
    assert_images_close(img, ref)


def test_mirror_scene_prb_gradient_matches_jax(mirror_scenes):
    """PRB's gradient of the mirror image w.r.t. the light's radiance."""
    sj, st = mirror_scenes

    def loss_j(rad):
        img = mi.render(sj.replace(emitters={**sj.emitters, "radiance": rad}),
                        spp=4, seed=1,
                        integrator={"type": "prb", "max_depth": 3})
        return jnp.sum(img ** 2)

    gj = np.asarray(jax.grad(loss_j)(sj.emitters["radiance"]))
    rad = st.emitters["radiance"].clone().requires_grad_(True)
    img = mt.render(st.with_leaves({"emitters.radiance": rad}), spp=4,
                    seed=1, integrator={"type": "prb", "max_depth": 3},
                    device="cpu")
    (gt,) = torch.autograd.grad(torch.sum(img ** 2), rad)
    assert np.abs(gj).max() > 0
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0,
                               atol=1e-4 * np.abs(gj).max())
