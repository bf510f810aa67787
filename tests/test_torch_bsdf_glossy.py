"""The port's GGX warps, dielectric Fresnel terms, rough conductor and
smooth dielectric BSDFs, tessellated sphere and their loader against the
JAX package's, on the same inputs made from a numpy seed.

Tolerances, each with its reason:

- scalars (pdfs, D, G1, F, weights): rtol 1e-5, atol 1e-6.  Unit vectors
  (m, wo): |diff| <= 1e-5 |v| + 1e-6 componentwise, the same bar taken
  relative to the vector's length, since a small component of a unit
  vector carries the rounding of its large ones.  XLA contracts some
  multiply-adds into FMAs and PyTorch does not (``ROADMAP.md`` §3);
- grazing lanes, |cos theta| < 0.02 for wi or for the sampled wo,
  stated apart: 1e-4 relative.  Near the horizon the stretched
  direction's normalisation, ``1 - p1^2 - p2^2`` and the Smith term's
  tan^2 theta cancel or blow up, and the same rounding moves a sample
  weight by up to ~1e-4 (measured 9.6e-5 on the lanes below);
- the sphere, the loader's columns and the dispatch's integer outputs:
  bit for bit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.core import math as MJ
from epsm_mitsuba3_tpu.core import warp as WJ
from epsm_mitsuba3_tpu.models import bsdf as BJ
from epsm_mitsuba3_tpu.models import shapes as SJ

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.core import math as MT
from epsm_mitsuba3_torch.core import warp as WT
from epsm_mitsuba3_torch.models import bsdf as BT
from epsm_mitsuba3_torch.models import shapes as ST

from test_torch_render import jax_arrays

N = 4096
GRAZING = 0.02
TORCH_COLUMNS = ("kind", "twosided", "reflectance", "specular_reflectance",
                 "specular_transmittance", "alpha", "eta_c", "k_c", "eta")


def _unit(r, n):
    v = r.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v


@pytest.fixture(scope="module")
def lanes():
    r = np.random.default_rng(21)
    wi = _unit(r, N)
    # a few lanes at the horizon and at the pole
    wi[:8] = [[1, 0, 0], [0, 1, 0], [0.6, 0.8, 0], [0, 0, 1], [0, 0, -1],
              [0.01, 0, 0.99995], [0.9999, 0, 0.0141], [-0.7, 0.7, 0.14]]
    wi[:8] /= np.linalg.norm(wi[:8], axis=-1, keepdims=True)
    return dict(wi=wi, wo=_unit(r, N), s1=r.random(N).astype(np.float32),
                s2=r.random((N, 2)).astype(np.float32),
                alpha=r.uniform(0.01, 0.8, N).astype(np.float32),
                alpha_v=r.uniform(0.01, 0.8, N).astype(np.float32),
                idx=r.integers(-1, 6, N).astype(np.int32))


def _grazing(*dirs):
    """Lanes where any of ``dirs`` (N, 3) lies within GRAZING of the
    horizon."""
    return np.any([np.abs(np.asarray(v)[:, 2]) < GRAZING for v in dirs], 0)


def _close(got, ref, wi, name, vector=False, wo=None):
    """``got`` against ``ref`` lane by lane; lanes grazing in ``wi`` (or
    in the sampled ``wo``) at the looser bar."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, name
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref), name)
    ok = np.isfinite(ref)
    got, ref = np.where(ok, got, 0.0), np.where(ok, ref, 0.0)
    g = _grazing(wi) if wo is None else _grazing(wi, wo)
    if vector:
        scale = np.linalg.norm(ref, axis=-1, keepdims=True)
        err = np.abs(got - ref) - 1e-5 * scale - 1e-6
    else:
        err = np.abs(got - ref) - 1e-5 * np.abs(ref) - 1e-6
    far = err.reshape(len(wi), -1).max(-1) > 0
    assert not far[~g].any(), (name, np.flatnonzero(far & ~g)[:8])
    rel = (np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)).reshape(
        len(wi), -1).max(-1)
    assert (rel[g] <= 1e-4).all(), (name, "grazing", rel[g].max())


@pytest.mark.parametrize("aniso", [False, True])
def test_ggx_warps_match_jax(lanes, aniso):
    """Visible-normal sampling (wi above and below the surface), D, G1
    and the visible pdf, per-lane roughness, isotropic and anisotropic."""
    wi, s2, au = lanes["wi"], lanes["s2"], lanes["alpha"]
    av = lanes["alpha_v"] if aniso else au
    mj = WJ.ggx_visible_normal_sample(jnp.asarray(wi), jnp.asarray(s2),
                                      jnp.asarray(au), jnp.asarray(av))
    mt_ = WT.ggx_visible_normal_sample(torch.from_numpy(wi),
                                       torch.from_numpy(s2),
                                       torch.from_numpy(au),
                                       torch.from_numpy(av))
    _close(mt_, mj, wi, "m", vector=True)
    # evaluate at JAX's m so the three functions are held on their own
    m = np.array(mj)
    for name, fj, ft, args in (
            ("D", WJ.ggx_ndf, WT.ggx_ndf, (m,)),
            ("G1(wi)", WJ.ggx_smith_g1, WT.ggx_smith_g1, (wi, m)),
            ("G1(wo)", WJ.ggx_smith_g1, WT.ggx_smith_g1, (lanes["wo"], m)),
            ("pdf", WJ.ggx_pdf_visible, WT.ggx_pdf_visible, (wi, m))):
        ref = fj(*(jnp.asarray(a) for a in args), jnp.asarray(au),
                 jnp.asarray(av))
        got = ft(*(torch.from_numpy(a) for a in args), torch.from_numpy(au),
                 torch.from_numpy(av))
        _close(got, ref, wi, name)
    # a scalar roughness broadcasts as the reference's does
    _close(WT.ggx_ndf(torch.from_numpy(m), 0.3, 0.3),
           WJ.ggx_ndf(jnp.asarray(m), 0.3, 0.3), wi, "D, scalar alpha")


def test_dielectric_fresnel_refract_match_jax(lanes):
    """fresnel on cosines of both signs, at 0, at the pole and past the
    critical angle, at eta 1 (index matched) and two glasses; refract and
    reflect_m on the results."""
    r = np.random.default_rng(4)
    cos_i = r.uniform(-1, 1, N).astype(np.float32)
    cos_i[:6] = [0.0, -0.0, 1.0, -1.0, 0.05, -0.05]
    eta = r.choice(np.float32([1.0, 1.5 / 1.000277, 1.33, 2.419]), N)
    ref = MJ.fresnel(jnp.asarray(cos_i), jnp.asarray(eta))
    got = MT.fresnel(torch.from_numpy(cos_i), torch.from_numpy(eta))
    wi = lanes["wi"]
    for name, g, f in zip(("F", "cos_t", "eta_it", "eta_ti"), got, ref):
        _close(g, f, wi, name)
    tir = np.asarray(ref[1]) == 0.0
    assert (np.asarray(ref[0])[tir] == 1.0).all() and tir.any()
    n = np.tile(np.float32([[0, 0, 1]]), (N, 1))
    m = lanes["wo"] * np.sign(lanes["wo"][:, 2:3])
    for name, a in (("refract, normal", n), ("refract, m", m)):
        rj = MJ.refract(jnp.asarray(wi), jnp.asarray(a), ref[1], ref[3])
        rt = MT.refract(torch.from_numpy(wi), torch.from_numpy(a), got[1],
                        got[3])
        _close(rt, rj, wi, name, vector=True)
    _close(MT.reflect_m(torch.from_numpy(wi), torch.from_numpy(m)),
           MJ.reflect_m(jnp.asarray(wi), jnp.asarray(m)), wi, "reflect_m",
           vector=True)


def _tables():
    """One table of each ported kind: diffuse, conductor, two rough
    conductors, two dielectrics; one of each two-sided."""
    tj = dict(BJ.empty_table(6))
    tj["kind"] = jnp.asarray([0, 1, 2, 2, 3, 3], jnp.int32)
    tj["twosided"] = jnp.asarray([False, False, False, True, False, True])
    tj["alpha"] = jnp.asarray([0.1, 0.1, 0.15, 0.4, 0.1, 0.1], jnp.float32)
    tj["eta_c"] = jnp.asarray([[0.2, 0.92, 1.1]] * 6, jnp.float32)
    tj["k_c"] = jnp.asarray([[3.9, 2.45, 2.14]] * 6, jnp.float32)
    tj["eta"] = jnp.asarray([1.5, 1.5, 1.5, 1.5, 1.5 / 1.000277, 1.33],
                            jnp.float32)
    tj["specular_transmittance"] = jnp.asarray(
        [[1.0, 1.0, 1.0]] * 5 + [[0.9, 0.8, 0.7]], jnp.float32)
    tt = {k: torch.from_numpy(np.array(tj[k])) for k in TORCH_COLUMNS}
    return tj, tt


@pytest.mark.parametrize("kinds", [(2,), (3,), (0, 1, 2, 3)])
def test_bsdf_sample_and_eval_match_jax(lanes, kinds):
    """sample and eval_pdf of the rough conductor, of the dielectric (wi
    from below included: the dispatch does not mask it), and of all four
    kinds in one table, with two-sided slots and idx -1 lanes."""
    tj, tt = _tables()
    wi, wo, s1, s2 = lanes["wi"], lanes["wo"], lanes["s1"], lanes["s2"]
    idx = lanes["idx"]
    if len(kinds) == 1:
        slots = np.flatnonzero(np.asarray(tj["kind"]) == kinds[0])
        idx = slots[np.abs(idx) % len(slots)].astype(np.int32)
    bj, wj, okj = BJ.sample(tj, kinds, jnp.asarray(idx), jnp.asarray(wi),
                            jnp.asarray(s1), jnp.asarray(s2))
    bt, wt, okt = BT.sample(tt, kinds, torch.from_numpy(idx),
                            torch.from_numpy(wi), torch.from_numpy(s1),
                            torch.from_numpy(s2))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(
        bt.sampled_type.numpy(), np.asarray(bj.sampled_type).astype(np.int32))
    assert okt.any()
    for name, g, r, vec in (("wo", bt.wo, bj.wo, True),
                            ("hf", bt.hf, bj.hf, True),
                            ("pdf", bt.pdf, bj.pdf, False),
                            ("eta", bt.eta, bj.eta, False),
                            ("weight", wt, wj, False)):
        _close(g, r, wi, name, vector=vec, wo=bj.wo)
    vj, pj = BJ.eval_pdf(tj, kinds, jnp.asarray(idx), jnp.asarray(wi),
                         jnp.asarray(wo))
    vt, pt = BT.eval_pdf(tt, kinds, torch.from_numpy(idx),
                         torch.from_numpy(wi), torch.from_numpy(wo))
    _close(vt, vj, wi, "eval value")
    _close(pt, pj, wi, "eval pdf")
    if 3 in kinds:
        # the dielectric answers wi from below, refracting into the
        # upper hemisphere or reflecting into the lower one
        kind = np.asarray(tj["kind"])[np.maximum(idx, 0)]
        below = (kind == 3) & (wi[:, 2] < 0) & ~np.asarray(
            tj["twosided"])[np.maximum(idx, 0)]
        assert okt.numpy()[below].all() and below.any()


def test_bsdf_alpha_gradient_reaches_the_table(lanes):
    """The roughness column is differentiable through the rough
    conductor's eval (PRB's path to alpha) and sample weight."""
    _, tt = _tables()
    alpha = tt["alpha"].clone().requires_grad_(True)
    tt = dict(tt, alpha=alpha)
    idx = torch.full((N,), 2, dtype=torch.int32)
    wi, wo = torch.from_numpy(lanes["wi"]), torch.from_numpy(lanes["wo"])
    val, pdf = BT.eval_pdf(tt, (2,), idx, wi, wo)
    (g,) = torch.autograd.grad(val.sum() + pdf.sum(), alpha)
    assert torch.isfinite(g).all() and g[2] != 0 and g[3] == 0


@pytest.mark.parametrize("kw", [dict(), dict(radius=0.4,
                                             center=(0.0, 0.45, 0.0)),
                                dict(radius=0.0225, center=[1.2, 1.2, -0.3],
                                     subdiv=8)])
def test_sphere_bitwise_equal_to_jax(kw):
    a, b = ST.sphere(**kw), SJ.sphere(**kw)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    if not kw:
        assert a["faces"].shape == (3968, 3)
        assert a["vertices"].shape == (2112, 3)


def _ball_scene(bsdf, **shape_kw):
    return {"type": "scene",
            "ball": dict({"type": "sphere", "radius": 0.5, "bsdf": bsdf},
                         **shape_kw),
            "light": {"type": "rectangle",
                      "to_world": [[1, 0, 0, 0], [0, 1, 0, 2], [0, 0, 1, 0],
                                   [0, 0, 0, 1]],
                      "emitter": {"type": "area", "radiance": 5.0}}}


@pytest.mark.parametrize("bsdf", [
    {"type": "dielectric", "int_ior": "water", "ext_ior": "air"},
    {"type": "dielectric", "int_ior": 1.7, "specular_transmittance": 0.5},
    {"type": "twosided", "material": {"type": "roughconductor",
                                      "roughness": 0.3, "eta": 0.2}},
    {"type": "roughconductor", "alpha": 0.05, "distribution": "ggx",
     "specular_reflectance": [0.9, 0.8, 0.7]},
    {"type": "conductor", "eta": 1.2, "k": [2.0, 3.0, 4.0]},
])
def test_loader_columns_equal_jax(bsdf):
    """Every BSDF column of the port's load_dict equals JAX's: the IOR
    names, roughness under both names, a scalar conductor eta, the
    specular tints; and the sphere's geometry."""
    d = _ball_scene(bsdf)
    sj = mi.load_dict(d)
    st = mt.load_dict(d, device="cpu")
    ref = jax_arrays(sj)
    for k, v in st.bsdfs.items():
        r = ref[f"bsdfs.{k}"]
        np.testing.assert_array_equal(v.numpy(), r.astype(v.numpy().dtype),
                                      k)
    for k in ("vertices", "normals", "faces"):
        np.testing.assert_array_equal(getattr(st, k).numpy(), ref[k], k)
    assert st.static.bsdf_kinds == sj.static.bsdf_kinds


@pytest.mark.parametrize("bsdf,shape_kw,match", [
    ({"type": "dielectric"}, {"interior": {"type": "homogeneous"}},
     "homogeneous"),
    ({"type": "roughconductor", "alpha": [0.1, 0.3]}, {}, "roughness"),
    ({"type": "dielectric", "int_ior": "unobtainium"}, {}, "unobtainium"),
    ({"type": "roughconductor", "material": "Au"}, {}, "Au"),
    ({"type": "diffuse", "reflectance": {"type": "volume",
                                         "filename": "albedo.vol"}}, {},
     "volume"),
])
def test_loader_refuses_what_is_not_ported(bsdf, shape_kw, match):
    """No silent stand-in: what the port does not have (a medium inside
    the shape and the ``volume`` texture; every BSDF kind, Beckmann and
    the analytic sphere load), a roughness given as a list, an unknown
    IOR name and a named conductor raise (a textured roughness loads as
    0.1, as in the reference: ``tests/test_torch_textures.py``)."""
    with pytest.raises(NotImplementedError, match=match):
        mt.load_dict(_ball_scene(bsdf, **shape_kw), device="cpu")


def test_scene_from_arrays_refuses_beckmann():
    """Once refused, the Beckmann distribution is ported: the arrays of a
    Beckmann rough conductor load through ``scene_from_arrays`` equal to
    JAX's, the ``beckmann`` column and the kinds' sentinel included."""
    d = _ball_scene({"type": "roughconductor", "distribution": "beckmann"})
    sj = mi.load_dict(d)
    arrays = jax_arrays(sj)
    assert arrays["bsdfs.beckmann"].any()
    st = mt.scene_from_arrays(arrays, device="cpu")
    for k, v in st.bsdfs.items():
        np.testing.assert_array_equal(
            v.numpy(), arrays[f"bsdfs.{k}"].astype(v.numpy().dtype), k)
    assert st.static.bsdf_kinds == sj.static.bsdf_kinds == (
        BT.KIND_DIFFUSE, BT.KIND_ROUGHCONDUCTOR, BT.KIND_SENTINEL_BECKMANN)
