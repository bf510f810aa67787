"""The port's remaining scalar BSDFs -- thin and rough dielectric,
plastic, rough plastic, null, principled, blendbsdf, pplastic,
principledthin -- the mask (a blend of null and its material), a blend
nested in a blend, and the Beckmann distribution on every rough kind,
against the JAX package's ``sample`` and ``eval_pdf`` on the same inputs
made from a numpy seed; and the Beckmann warps.

Tolerances, each with its reason (every number measured on these
lanes, seed 31):

- ``eval_pdf``: the rule of ``test_torch_bsdf_glossy.py`` -- rtol 1e-5,
  atol 1e-6, and 1e-4 relative where wi or wo lies within 0.02 of the
  horizon.  XLA contracts multiply-adds into FMAs and PyTorch does not
  (``ROADMAP.md`` queue 3).  Largest difference: 7.1e-7 relative;
- ``sample``, GGX and smooth lobes: unit vectors (wo, hf) within 1e-5 of
  their length; scalars (pdf, eta, weight) rtol 5e-5.  A sampled wo
  carries the FMA rounding of the sampled normal (~1e-7), and the pdf
  and weight evaluate D at its half vector: at the principled kinds'
  squared roughness (alpha 0.0032 here) D's slope magnifies that by
  1 / alpha.  Largest: 3.0e-5 (principledthin's pdf), 1.4e-5 (weights);
- ``sample``, grazing lanes (wi or the sampled wo within 0.02 of the
  horizon): vectors 1e-4 of their length, scalars 2e-4 relative
  (largest 1.6e-4, principledthin's weight at wo.z = -0.008);
- ``sample``, lanes that drew a Beckmann normal: vectors 1e-4 of their
  length, scalars 2e-3 relative.  The visible-slope sampler inverts its
  CDF with ``erf`` / ``erfinv``, which the port takes from
  ``torch.special`` and XLA approximates in float32 with other
  polynomials (erfinv 5.6e-6 apart, relative, on [-0.9999, 0.9999]).
  Ten Newton steps carry that into m: 4.1e-6 where the sample's
  u1 <= 0.999 and 4.1e-5 in the CDF's tail above.  D = exp(-tan^2 theta
  / alpha^2) / ... turns an angle error d theta into a relative error
  2 tan theta d theta / alpha^2, 1e-3 at alpha 0.05 (largest measured:
  m 5.9e-5, pdf 1.1e-3, weight 1.3e-5);
- the Beckmann warps alone: m 1e-5 of its length, 1e-4 in the tail
  (u1 > 0.999); D, G1 and the pdfs at JAX's m as the ``eval_pdf`` rule;
- the integer outputs (``ok``, ``sampled_type``): equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from epsm_mitsuba3_tpu.core import warp as WJ
from epsm_mitsuba3_tpu.models import bsdf as BJ
from epsm_mitsuba3_tpu.models import textures as TJ

from epsm_mitsuba3_torch.core import warp as WT
from epsm_mitsuba3_torch.models import bsdf as BT
from epsm_mitsuba3_torch.models import textures as TT

from test_torch_bsdf_glossy import _unit
from torch_threads import one_torch_thread  # noqa: F401

N = 4096
GRAZING = 0.02
#: the CDF tail of Beckmann visible-normal sampling (see above)
TAIL_U1 = 0.999
BECK = BJ.KIND_SENTINEL_BECKMANN

#: the table's slots: (name, kind, twosided, beckmann)
SLOTS = (
    ("diffuse", BJ.KIND_DIFFUSE, False, False),
    ("thindielectric", BJ.KIND_THINDIELECTRIC, False, False),
    ("roughdielectric", BJ.KIND_ROUGHDIELECTRIC, False, False),
    ("roughdielectric beckmann", BJ.KIND_ROUGHDIELECTRIC, False, True),
    ("plastic", BJ.KIND_PLASTIC, False, False),
    ("plastic twosided", BJ.KIND_PLASTIC, True, False),
    ("roughplastic", BJ.KIND_ROUGHPLASTIC, False, False),
    ("roughplastic beckmann twosided", BJ.KIND_ROUGHPLASTIC, True, True),
    ("null", BJ.KIND_NULL, False, False),
    ("principled", BJ.KIND_PRINCIPLED, False, False),
    ("principled twosided", BJ.KIND_PRINCIPLED, True, False),
    ("blend", BJ.KIND_BLEND, False, False),
    ("pplastic", BJ.KIND_PPLASTIC, False, False),
    ("principledthin", BJ.KIND_PRINCIPLEDTHIN, False, False),
    ("mask", BJ.KIND_BLEND, False, False),
    ("nested blend", BJ.KIND_BLEND, False, False),
    ("roughconductor beckmann", BJ.KIND_ROUGHCONDUCTOR, False, True),
    ("thindielectric twosided", BJ.KIND_THINDIELECTRIC, True, False),
)
NAMES = [s[0] for s in SLOTS]
#: the blends' children: blend = (plastic, roughdielectric), mask =
#: (null, roughplastic), nested = (blend, roughconductor beckmann)
CHILDREN = {"blend": ("plastic", "roughdielectric beckmann"),
            "mask": ("null", "roughplastic"),
            "nested blend": ("blend", "roughconductor beckmann")}


def _table(seed=3, textured=False):
    """One table of SLOTS with parameters from a seed, in JAX's layout and
    in the port's; with ``textured`` the plastic's and the principled
    slot's reflectance read texture 0 (a checkerboard), the blend's weight
    texture 1 (a bitmap)."""
    r = np.random.default_rng(seed)
    n = len(SLOTS)
    t = {k: np.array(v) for k, v in BJ.empty_table(n).items()}
    t["kind"][:] = [s[1] for s in SLOTS]
    t["twosided"][:] = [s[2] for s in SLOTS]
    t["beckmann"][:] = [s[3] for s in SLOTS]
    t["flags"][:] = [BJ.KIND_FLAGS[s[1]] for s in SLOTS]
    for k in ("reflectance", "diffuse_reflectance"):
        t[k][:] = r.uniform(0.1, 0.9, (n, 3))
    t["specular_reflectance"][:] = r.uniform(0.5, 1.0, (n, 3))
    t["specular_transmittance"][:] = r.uniform(0.5, 1.0, (n, 3))
    t["alpha"][:] = r.uniform(0.05, 0.6, n)
    t["eta"][:] = r.choice([1.33, 1.5046 / 1.000277, 1.7, 2.4], n)
    t["eta_c"][:] = [0.2, 0.92, 1.1]
    t["k_c"][:] = [3.9, 2.45, 2.14]
    for k in ("metallic", "spec_tint", "sheen", "sheen_tint", "clearcoat",
              "clearcoat_gloss", "specular", "spec_trans", "flatness"):
        t[k][:] = r.uniform(0.0, 1.0, n)
    t["diff_trans"][:] = r.uniform(0.0, 2.0, n)
    t["blend_weight"][:] = r.uniform(0.2, 0.8, n)
    for name, (a, b) in CHILDREN.items():
        i = NAMES.index(name)
        t["blend_a"][i], t["blend_b"][i] = NAMES.index(a), NAMES.index(b)
    if textured:
        for name in ("plastic", "roughplastic", "principled"):
            t["reflectance_tex"][NAMES.index(name)] = 0
        t["blend_weight_tex"][NAMES.index("mask")] = 1
    tj = {k: jnp.asarray(v) for k, v in t.items()}
    tt = {k: torch.from_numpy(v.astype(np.int32) if v.dtype == np.uint32
                              else v) for k, v in t.items()}
    return tj, tt


def _textures():
    """A checkerboard and a smooth 8 x 8 bitmap, in both packages."""
    r = np.random.default_rng(9)
    img = r.uniform(0.1, 0.9, (8, 8, 3)).astype(np.float32)
    c0, c1 = [0.8, 0.3, 0.2], [0.1, 0.5, 0.7]
    tj = [TJ.checkerboard(c0, c1, (4.0, 4.0), (0.0, 0.0)),
          TJ.bitmap(img, (1.0, 1.0), (0.0, 0.0))]
    tt = {0: TT.checkerboard(c0, c1, (4.0, 4.0), (0.0, 0.0)),
          1: TT.bitmap(img, (1.0, 1.0), (0.0, 0.0))}
    return tj, tt


@pytest.fixture(scope="module")
def lanes():
    r = np.random.default_rng(31)
    wi = _unit(r, N)
    wi[:6] = [[0, 0, 1], [0, 0, -1], [0.6, 0.8, 0], [0.01, 0, 0.99995],
              [0.9999, 0, 0.0141], [-0.7, 0.7, -0.14]]
    wi[:6] /= np.linalg.norm(wi[:6], axis=-1, keepdims=True)
    return dict(wi=wi, wo=_unit(r, N), s1=r.random(N).astype(np.float32),
                s2=r.random((N, 2)).astype(np.float32),
                uv=r.random((N, 2)).astype(np.float32))


def _close(got, ref, rtol, name, vector=False):
    """``got`` against ``ref`` lane by lane at the per-lane relative bar
    ``rtol`` (N,), with atol 1e-6; unit vectors relative to their
    length."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, name
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref), name)
    ok = np.isfinite(ref)
    got, ref = np.where(ok, got, 0.0), np.where(ok, ref, 0.0)
    scale = (np.linalg.norm(ref, axis=-1, keepdims=True) if vector
             else np.abs(ref))
    rtol = np.asarray(rtol).reshape((-1,) + (1,) * (ref.ndim - 1))
    err = (np.abs(got - ref) - rtol * scale - 1e-6).reshape(len(rtol), -1)
    far = np.flatnonzero(err.max(-1) > 0)
    assert not len(far), (name, far[:8], np.abs(got - ref).reshape(
        len(rtol), -1)[far[:8]].max(-1), ref.reshape(len(rtol), -1)[far[:8]])


def _grazing(*dirs):
    return np.any([np.abs(np.asarray(v)[:, 2]) < GRAZING for v in dirs], 0)


def _beckmann_slots(tj):
    """Per slot: the slot, or a child of it (blends nested), takes
    Beckmann."""
    kind, beck = np.asarray(tj["kind"]), np.asarray(tj["beckmann"])
    out = beck.copy()
    for _ in range(len(kind)):
        a, b = np.asarray(tj["blend_a"]), np.asarray(tj["blend_b"])
        out = out | ((kind == BJ.KIND_BLEND) & (out[a] | out[b]))
    return out


def _sample_rtol(lanes, bs, slot, tj, vector):
    """The bars of ``sample`` (see above): 5e-5 / 1e-5 (vectors), grazing
    2e-4 / 1e-4, Beckmann-drawn 2e-3 / 1e-4."""
    glossy = (np.asarray(bs.sampled_type) & (BJ.BSDFFlags.Glossy)) != 0
    beck = _beckmann_slots(tj)[slot] & glossy
    rtol = np.full(N, 1e-5 if vector else 5e-5)
    rtol[_grazing(lanes["wi"], bs.wo)] = 1e-4 if vector else 2e-4
    rtol[beck] = 1e-4 if vector else 2e-3
    return rtol


def _eval_rtol(lanes):
    """The bars of ``eval_pdf``: 1e-5, grazing 1e-4."""
    return np.where(_grazing(lanes["wi"], lanes["wo"]), 1e-4, 1e-5)


GROUPS = {name: (i,) for i, name in enumerate(NAMES) if i > 0}


def _kinds(slots, tj):
    """The static kind set of the slots and of their children, with the
    sentinel where a slot takes Beckmann (``models/scene.py`` build)."""
    kind, beck = np.asarray(tj["kind"]), np.asarray(tj["beckmann"])
    todo, seen = list(slots), set()
    while todo:
        i = todo.pop()
        if i in seen:
            continue
        seen.add(i)
        if kind[i] == BJ.KIND_BLEND:
            todo += [int(tj["blend_a"][i]), int(tj["blend_b"][i])]
    ks = tuple(sorted({int(kind[i]) for i in seen}))
    return ks + ((BECK,) if beck[list(seen)].any() else ())


def _run(lanes, slots, textured):
    tj, tt = _table(textured=textured)
    kinds = _kinds(slots, tj)
    r = np.random.default_rng(len(slots))
    idx = np.asarray(slots, np.int32)[r.integers(0, len(slots), N)]
    if len(slots) > 1:
        idx[r.random(N) < 0.05] = -1
    kw_j, kw_t = {}, {}
    if textured:
        texj, text = _textures()
        uv = lanes["uv"]
        kw_j = dict(uv=jnp.asarray(uv), textures=texj)
        kw_t = dict(uv=torch.from_numpy(uv), textures=text)
    wi, wo, s1, s2 = lanes["wi"], lanes["wo"], lanes["s1"], lanes["s2"]
    bj, wj, okj = BJ.sample(tj, kinds, jnp.asarray(idx), jnp.asarray(wi),
                            jnp.asarray(s1), jnp.asarray(s2), **kw_j)
    bt, wt, okt = BT.sample(tt, kinds, torch.from_numpy(idx),
                            torch.from_numpy(wi), torch.from_numpy(s1),
                            torch.from_numpy(s2), **kw_t)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(
        bt.sampled_type.numpy(), np.asarray(bj.sampled_type).astype(np.int32))
    slot = np.maximum(idx, 0)
    for name, g, ref, vec in (("wo", bt.wo, bj.wo, True),
                              ("hf", bt.hf, bj.hf, True),
                              ("pdf", bt.pdf, bj.pdf, False),
                              ("eta", bt.eta, bj.eta, False),
                              ("weight", wt, wj, False)):
        _close(g, ref, _sample_rtol(lanes, bj, slot, tj, vec), name,
               vector=vec)
    vj, pj = BJ.eval_pdf(tj, kinds, jnp.asarray(idx), jnp.asarray(wi),
                         jnp.asarray(wo), **kw_j)
    vt, pt = BT.eval_pdf(tt, kinds, torch.from_numpy(idx),
                         torch.from_numpy(wi), torch.from_numpy(wo), **kw_t)
    _close(vt, vj, _eval_rtol(lanes), "eval value")
    _close(pt, pj, _eval_rtol(lanes), "eval pdf")
    return okt, kinds


@pytest.mark.parametrize("name", list(GROUPS))
def test_each_kind_matches_jax(lanes, name):
    """sample (wo, pdf, eta, sampled_type, hf, weight, ok) and eval_pdf of
    one slot kind alone, twosided where the name says so."""
    okt, kinds = _run(lanes, GROUPS[name], textured=False)
    if name == "nested blend":
        # the lanes that pick the inner blend sample nothing
        assert not okt.all() and okt.any()
    elif name != "null":
        assert okt.any()


@pytest.mark.parametrize("textured", [False, True])
def test_all_kinds_in_one_table_match_jax(lanes, textured):
    """Every slot in one table, idx -1 lanes too; textured: the plastics'
    and the principled slot's reflectance (and so ``diffuse_reflectance``)
    through a checkerboard, the mask's opacity through a bitmap."""
    okt, kinds = _run(lanes, tuple(range(len(SLOTS))), textured)
    assert BECK in kinds and okt.any()


def test_blend_gradients_reach_weight_and_children(lanes):
    """The blend's eval is the lerp of its children's: the gradient of its
    value reaches ``blend_weight`` and both children's columns, and is
    finite on every column."""
    _, tt = _table()
    leaves = {k: tt[k].clone().requires_grad_(True) for k in (
        "blend_weight", "diffuse_reflectance", "alpha", "eta",
        "specular_reflectance", "reflectance", "metallic", "clearcoat",
        "spec_trans", "flatness")}
    tt = dict(tt, **leaves)
    kinds = _kinds(tuple(range(len(SLOTS))),
                   {k: v.detach().numpy() for k, v in tt.items()})
    idx = torch.arange(N, dtype=torch.int32) % len(SLOTS)
    wi, wo = torch.from_numpy(lanes["wi"]), torch.from_numpy(lanes["wo"])
    val, pdf = BT.eval_pdf(tt, kinds, idx, wi, wo)
    gs = torch.autograd.grad(val.sum() + pdf.sum(), list(leaves.values()))
    for k, g in zip(leaves, gs):
        assert torch.isfinite(g).all(), k
    g = dict(zip(leaves, gs))
    assert g["blend_weight"][NAMES.index("blend")] != 0
    assert g["diffuse_reflectance"][NAMES.index("plastic")].abs().sum() > 0


@pytest.mark.parametrize("aniso", [False, True])
def test_beckmann_warps_match_jax(lanes, aniso):
    """Beckmann visible-normal sampling (wi above and below), D, G1, the
    visible pdf, the classic pdf, and the classic GGX and Beckmann normal
    sampling, per-lane roughness, isotropic and anisotropic."""
    r = np.random.default_rng(2)
    wi, s2 = lanes["wi"], lanes["s2"]
    au = r.uniform(0.01, 0.8, N).astype(np.float32)
    av = r.uniform(0.01, 0.8, N).astype(np.float32) if aniso else au
    a_j, a_t = (jnp.asarray(au), jnp.asarray(av)), (torch.from_numpy(au),
                                                    torch.from_numpy(av))
    mj = WJ.beckmann_visible_normal_sample(jnp.asarray(wi), jnp.asarray(s2),
                                           *a_j)
    mt_ = WT.beckmann_visible_normal_sample(torch.from_numpy(wi),
                                            torch.from_numpy(s2), *a_t)
    tail = s2[:, 0] > TAIL_U1
    _close(mt_, mj, np.where(tail, 1e-4, 1e-5), "m", vector=True)
    grazing = np.where(_grazing(wi, lanes["wo"]), 1e-4, 1e-5)
    m = np.array(mj)
    for name, fj, ft, args in (
            ("D", WJ.beckmann_ndf, WT.beckmann_ndf, (m,)),
            ("G1(wi)", WJ.beckmann_smith_g1, WT.beckmann_smith_g1, (wi, m)),
            ("G1(wo)", WJ.beckmann_smith_g1, WT.beckmann_smith_g1,
             (lanes["wo"], m)),
            ("pdf", WJ.beckmann_pdf_visible, WT.beckmann_pdf_visible,
             (wi, m)),
            ("classic pdf", WJ.beckmann_pdf, WT.beckmann_pdf, (m,))):
        ref = fj(*(jnp.asarray(a) for a in args), *a_j)
        got = ft(*(torch.from_numpy(a) for a in args), *a_t)
        _close(got, ref, grazing, name)
    # the classic warps: the pole's sin theta = sqrt(1 - cos^2) cancels,
    # so their vectors are held relative to the vector's length
    for name, fj, ft in (("square_to_ggx", WJ.square_to_ggx,
                          WT.square_to_ggx),
                         ("square_to_beckmann", WJ.square_to_beckmann,
                          WT.square_to_beckmann)):
        _close(ft(torch.from_numpy(s2), *a_t), fj(jnp.asarray(s2), *a_j),
               np.full(N, 1e-5), name, vector=True)
    # a scalar roughness broadcasts as the reference's does
    _close(WT.beckmann_ndf(torch.from_numpy(m), 0.3, 0.3),
           WJ.beckmann_ndf(jnp.asarray(m), 0.3, 0.3), grazing,
           "D, scalar alpha")


def test_beckmann_sample_gradient_is_finite_and_matches_jax(lanes):
    """The roughness gradient of Beckmann visible-normal sampling: equal
    to JAX's (1e-4 of max(|g|, 1), the m bar of the CDF's tail) on every
    lane where JAX's is finite, and finite at the pole too, where the
    reference's ``arccos`` of cos theta_i = 1 gives 0 * inf = NaN and the
    port's ``safe_acos`` gives the same primal with a zero derivative
    (``ROADMAP.md`` queue 3)."""
    import jax
    wi, s2 = lanes["wi"], lanes["s2"]
    a = torch.full((N,), 0.3, requires_grad=True)
    mvec = WT.beckmann_visible_normal_sample(torch.from_numpy(wi),
                                             torch.from_numpy(s2), a, a)
    (g,) = torch.autograd.grad(mvec[..., :2].sum(), a)
    gj = np.asarray(jax.grad(lambda al: WJ.beckmann_visible_normal_sample(
        jnp.asarray(wi), jnp.asarray(s2), al, al)[..., :2].sum())(
            jnp.full((N,), 0.3, jnp.float32)))
    g = g.numpy()
    assert np.isfinite(g).all() and np.abs(g).sum() > 0
    pole = np.abs(wi[:, 2]) == 1.0
    assert pole.any() and np.isnan(gj[pole]).all()
    assert np.isfinite(gj[~pole]).all()
    err = np.abs(g - gj)[~pole] / np.maximum(np.abs(gj[~pole]), 1.0)
    assert err.max() <= 1e-4, err.max()
