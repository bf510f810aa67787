"""The measured BSDF (``models/measured.py``, the ``measured`` kind of
``models/bsdf.py``) in the port against the JAX package.  The tensor
file is the JAX test's synthetic Beckmann material
(``tests/test_measured.py`` ``_synth_bsdf``), written at run time: no RGL
file is needed.

Tolerances: the parsed fields, the baked table, its theta_i grid and the
fitted alpha bit for bit (the same numpy float64 arithmetic); the
device-side lookup ``eval_table`` and ``sample`` / ``eval_pdf`` on seeded
lanes within 2e-5 relative and 1e-6 absolute, 1e-4 relative where the
proxy's pdf is taken at grazing angles (|cos| < 0.02), as the glossy
kinds' tests hold GGX (``tests/test_torch_bsdf_glossy.py``); a 16^2
render as ``assert_images_close`` (1e-4); the chi-square test of the
proxy's sampling at the reference's 1 % significance."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.models import bsdf as BJ
from epsm_mitsuba3_tpu.models import measured as MJ
from scenes import cornell_box as cornell_box_jax
from test_measured import ALPHA, _synth_bsdf

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.models import bsdf as BT
from epsm_mitsuba3_torch.models import measured as MT
from epsm_mitsuba3_torch.scenes import cornell_box
from epsm_mitsuba3_torch.utils.chi2 import ChiSquareTest, SphericalDomain

from test_torch_render import assert_images_close, jax_arrays
from torch_threads import one_torch_thread  # noqa: F401

RES, SPP = 16, 4


@pytest.fixture(scope="module")
def bsdf_file(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("measured") / "synth.bsdf")
    _synth_bsdf(p)
    return p


def test_read_bake_fit_equal_jax(bsdf_file, tmp_path):
    fj, ft = MJ.read_tensor_file(bsdf_file), MT.read_tensor_file(bsdf_file)
    assert sorted(fj) == sorted(ft)
    for k in fj:
        np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)
        assert ft[k].dtype == fj[k].dtype
    for kw in ({}, {"n_theta_o": 48, "n_phi_d": 16}):
        tj, nj, aj = MJ.bake(bsdf_file, **kw)
        tt, nt, at = MT.bake(bsdf_file, **kw)
        np.testing.assert_array_equal(tt, tj)
        np.testing.assert_array_equal(nt, nj)
        assert at == aj and 0.1 < at < 0.6
    assert MT.fit_ggx_alpha(fj["ndf"]) == MJ.fit_ggx_alpha(fj["ndf"])
    # the port's writer is read back by both parsers
    q = str(tmp_path / "copy.bsdf")
    MT.write_tensor_file(q, ft)
    for k, v in MJ.read_tensor_file(q).items():
        np.testing.assert_array_equal(v, fj[k], err_msg=k)


def test_anisotropic_file_refused(tmp_path, bsdf_file):
    f = dict(MT.read_tensor_file(bsdf_file))
    f["phi_i"] = np.asarray([0.0, 1.0, 2.0], np.float32)
    q = str(tmp_path / "aniso.bsdf")
    MT.write_tensor_file(q, f)
    with pytest.raises(ValueError, match="anisotropic"):
        MT.bake(q)
    with pytest.raises(ValueError, match="anisotropic"):
        MJ.bake(q)


def _lanes(n, seed):
    r = np.random.default_rng(seed)

    def unit(v):
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
            np.float32)

    wi = unit(r.normal(size=(n, 3)) + [0, 0, 1.2])
    wo = unit(r.normal(size=(n, 3)) + [0, 0, 0.8])
    return wi, wo, r.random((n,)).astype(np.float32), \
        r.random((n, 2)).astype(np.float32)


@pytest.fixture(scope="module")
def scenes(bsdf_file):
    dj = cornell_box_jax(res=RES, spp=SPP, max_depth=3)
    dt = cornell_box(res=RES, spp=SPP, max_depth=3)
    for d in (dj, dt):
        d["back"]["bsdf"] = {"type": "measured", "filename": bsdf_file}
    return mi.load_dict(dj), mt.load_dict(dt, device="cpu")


def test_load_dict_equals_jax(scenes):
    sj, st = scenes
    ref = jax_arrays(sj)
    for k, v in st.bsdfs.items():
        if f"bsdfs.{k}" in ref:
            np.testing.assert_array_equal(
                v.numpy(), ref[f"bsdfs.{k}"].astype(v.numpy().dtype),
                err_msg=k)
    assert BT.KIND_MEASURED in st.static.bsdf_kinds
    i = int(st.bsdfs["reflectance_tex"][int(st.bsdfs["kind"].argmax())])
    assert st.textures[i].kind == sj.textures[i].kind == "measured_brdf"
    np.testing.assert_array_equal(st.textures[i].grid3d.numpy(),
                                  np.asarray(sj.textures[i].grid3d))
    np.testing.assert_array_equal(st.textures[i].nodes.numpy(),
                                  np.asarray(sj.textures[i].nodes))
    assert i in st.static.bsdf_textures


def test_eval_table_sample_and_eval_pdf_match_jax(scenes):
    """The table lookup, ``sample`` and ``eval_pdf`` of the measured slot
    beside a diffuse slot, on 4,096 seeded lanes, against JAX's."""
    sj, st = scenes
    n = 4096
    wi, wo, s1, s2 = _lanes(n, 7)
    slot = int(st.bsdfs["kind"].argmax())
    idx = np.where(np.arange(n) % 3 == 0, 0, slot).astype(np.int32)
    tex_i = int(st.bsdfs["reflectance_tex"][slot])
    ft = MT.eval_table(st.textures[tex_i], torch.from_numpy(wi),
                       torch.from_numpy(wo)).numpy()
    fj = np.asarray(MJ.eval_table(sj.textures[tex_i], jnp.asarray(wi),
                                  jnp.asarray(wo)))
    np.testing.assert_allclose(ft, fj, rtol=2e-5, atol=1e-6)
    assert (ft > 0).any()
    kinds = st.static.bsdf_kinds
    bj, wj, okj = BJ.sample(sj.bsdfs, sj.static.bsdf_kinds, jnp.asarray(idx),
                            jnp.asarray(wi), jnp.asarray(s1),
                            jnp.asarray(s2), textures=sj.textures,
                            uv=jnp.zeros((n, 2)))
    bt, wt, okt = BT.sample(st.bsdfs, kinds, torch.from_numpy(idx),
                            torch.from_numpy(wi), torch.from_numpy(s1),
                            torch.from_numpy(s2),
                            textures=st.bsdf_textures(),
                            uv=torch.zeros((n, 2)))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    ok = okt.numpy()
    np.testing.assert_allclose(bt.wo.numpy()[ok], np.asarray(bj.wo)[ok],
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(bt.pdf.numpy()[ok], np.asarray(bj.pdf)[ok],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-4,
                               atol=1e-6)
    vj, pj = BJ.eval_pdf(sj.bsdfs, sj.static.bsdf_kinds, jnp.asarray(idx),
                         jnp.asarray(wi), jnp.asarray(wo),
                         textures=sj.textures, uv=jnp.zeros((n, 2)))
    vt, pt = BT.eval_pdf(st.bsdfs, kinds, torch.from_numpy(idx),
                         torch.from_numpy(wi), torch.from_numpy(wo),
                         textures=st.bsdf_textures(),
                         uv=torch.zeros((n, 2)))
    grazing = (np.abs(wo[:, 2]) < 0.02) | (np.abs(wi[:, 2]) < 0.02)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pt.numpy()[~grazing],
                               np.asarray(pj)[~grazing], rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pt.numpy()[grazing], np.asarray(pj)[grazing],
                               rtol=1e-4, atol=1e-6)


def test_render_matches_jax(scenes):
    sj, st = scenes
    ref = np.asarray(mi.render(sj, spp=SPP, seed=0))
    img = mt.render(st, spp=SPP, seed=0, device="cpu").numpy()
    assert np.isfinite(img).all()
    assert_images_close(img, ref)


def test_proxy_sampling_chi2(scenes):
    """The GGX proxy's directions against its pdf (``eval_pdf``), as
    JAX's chi-square tests hold its BSDFs; the samples that are not ok
    carry no mass."""
    _, st = scenes
    slot = int(st.bsdfs["kind"].argmax())
    wi0 = torch.tensor([0.3, -0.2, 0.933])
    wi0 = wi0 / wi0.norm()
    tex = st.bsdf_textures()
    gen = torch.Generator().manual_seed(3)

    def lanes(n):
        return (torch.full((n,), slot, dtype=torch.int32),
                wi0.expand(n, 3).contiguous())

    def sample(n):
        idx, wi = lanes(n)
        bs, _, ok = BT.sample(st.bsdfs, st.static.bsdf_kinds, idx, wi,
                              torch.rand(n, generator=gen),
                              torch.rand((n, 2), generator=gen),
                              textures=tex, uv=torch.zeros((n, 2)))
        return bs.wo[ok]

    def pdf(dirs):
        wo = dirs.reshape(-1, 3)
        idx, wi = lanes(wo.shape[0])
        return BT.eval_pdf(st.bsdfs, st.static.bsdf_kinds, idx, wi, wo,
                           textures=tex, uv=torch.zeros((wo.shape[0], 2))
                           )[1].reshape(dirs.shape[:-1])

    test = ChiSquareTest(SphericalDomain(), sample, pdf,
                         sample_count=200_000, res=21, ires=8, device="cpu")
    assert test.run(), test.messages


def test_measured_render_like_its_analytic_counterpart(bsdf_file):
    """JAX's ``test_measured_render`` on the port: a measured plate under
    a constant light against a Beckmann roughconductor of the same NDF,
    within the reference's loose band."""
    T = mt.ScalarTransform4f

    def scene(bsdf):
        return mt.load_dict({
            "type": "scene",
            "integrator": {"type": "path", "max_depth": 3},
            "sensor": {
                "type": "perspective", "fov": 30.0,
                "to_world": T.look_at(origin=[0, 1.5, 2.5], target=[0, 0, 0],
                                      up=[0, 1, 0]),
                "film": {"type": "hdrfilm", "width": 16, "height": 16,
                         "rfilter": {"type": "box"}},
                "sampler": {"type": "independent", "sample_count": 16}},
            "env": {"type": "constant",
                    "radiance": {"type": "rgb", "value": [1, 1, 1]}},
            "plate": {"type": "rectangle",
                      "to_world": T.rotate([1, 0, 0], -90), "bsdf": bsdf},
        }, device="cpu")

    img_m = mt.render(scene({"type": "measured", "filename": bsdf_file}),
                      seed=1, spp=16, device="cpu")
    img_g = mt.render(scene({
        "type": "roughconductor", "alpha": ALPHA, "distribution": "beckmann",
        "eta": [0.01, 0.01, 0.01], "k": [10.0, 10.0, 10.0]}),
        seed=1, spp=16, device="cpu")
    assert bool(torch.isfinite(img_m).all()) and float(img_m.mean()) > 0.01
    ratio = float(img_m.mean() / img_g.mean())
    assert 0.3 < ratio < 1.6, ratio


def test_prb_gradients_finite(bsdf_file):
    """PRB gradients of the vertices and the reflectances through the
    measured slot, with face normals on the walls (so that the shading
    frame moves with the vertices): finite and non-zero, where the plain
    arccos and square root of the table lookup gave NaN (normal
    incidence, coplanar directions).  The reference's are finite too."""
    d = cornell_box(res=32, spp=SPP, max_depth=3)
    d["back"]["bsdf"] = {"type": "measured", "filename": bsdf_file}
    for k in ("floor", "ceiling", "back", "left", "right"):
        d[k]["face_normals"] = True
    st = mt.load_dict(d, device="cpu")
    lv = {k: st.leaves()[k].clone().requires_grad_(True)
          for k in ("vertices", "bsdfs.reflectance")}
    img = mt.render(st.with_leaves(lv), spp=SPP, seed=0, device="cpu",
                    integrator={"type": "prb", "max_depth": 3})
    for g in torch.autograd.grad(torch.mean(img ** 2), list(lv.values())):
        assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0


def test_manifold_backward_finite(bsdf_file):
    """The manifold backward through a measured back wall at 32^2: its
    PRB replay meets subnormal table values, which count as 0 (the
    reference's devices flush them), so every gradient is finite."""
    d = cornell_box(res=32, spp=2, max_depth=3)
    d["back"]["bsdf"] = {"type": "measured", "filename": bsdf_file}
    st = mt.load_dict(d, device="cpu")
    v = st.vertices.clone().requires_grad_(True)
    img = mt.render(st.with_leaves({"vertices": v}), spp=2, seed=0,
                    device="cpu",
                    integrator={"type": "manifold", "max_depth": 3})
    (g,) = torch.autograd.grad(img.sum(), v)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
