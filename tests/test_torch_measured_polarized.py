"""The measured polarized BSDF (``models/measured_polarized.py``, the
``measured_polarized`` kind) of the port against the JAX package's, and
the reference's checks (JAX ``tests/test_measured_polarized.py``) on the
port alone.

Tolerances, each with its reason:

- the baked table: equal (the same numpy code on the same file);
- M00, the Mueller matrices (entries up to ~0.3) and their frames
  (unit vectors): within 1e-5 absolute (the Rusinkiewicz angles go
  through acos and atan2, rounded differently by XLA and PyTorch, then a
  trilinear lookup);
- the scalar BSDF's sample and eval_pdf: within 1e-5, relative 1e-4
  (the GGX visible-normal warp, as ``test_torch_bsdf_glossy.py``);
- the Stokes image: ``assert_images_close`` of ``test_torch_render.py``;
- the reference's checks: the JAX package's own bars.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.models import bsdf as BJ
from epsm_mitsuba3_tpu.models import measured_polarized as MPJ
from epsm_mitsuba3_tpu.models.textures import Texture as TextureJ

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.core import mueller as mu
from epsm_mitsuba3_torch.models import bsdf as B
from epsm_mitsuba3_torch.models import measured_polarized as MP
from epsm_mitsuba3_torch.models.textures import Texture

from test_torch_render import assert_images_close
from torch_threads import one_torch_thread  # noqa: F401

NP, ND, NH = 5, 4, 6
#: an ideal linear polarizer's Mueller matrix
POLARIZER = 0.5 * np.array([[1, 1, 0, 0], [1, 1, 0, 0], [0, 0, 0, 0],
                            [0, 0, 0, 0]], np.float32)


def make_pbsdf_file(path, M_fn, wvls=(450, 500, 550, 600, 650)):
    """A pBSDF tensor file whose Mueller matrix in every (phi_d, theta_d,
    theta_h, wavelength) bin is ``M_fn(pd, td, th)`` (4, 4), as the JAX
    package's tests write theirs."""
    pd = np.linspace(-np.pi, np.pi, NP).astype(np.float32)
    td = np.linspace(0, np.pi / 2, ND).astype(np.float32)
    th = np.linspace(0, np.pi / 2, NH).astype(np.float32)
    M = np.zeros((NP, ND, NH, len(wvls), 4, 4), np.float32)
    for i, p in enumerate(pd):
        for j, t in enumerate(td):
            for k, h in enumerate(th):
                M[i, j, k, :] = M_fn(p, t, h)[None]
    MP.synthesize_tensor_file(str(path), M, pd, td, th, np.asarray(wvls))
    return str(path)


def _fresnel_like(p, t, h):
    """A table that varies over the bins and polarizes (a diattenuator
    whose strength grows with theta_d)."""
    a = 0.2 + 0.1 * np.cos(h)
    b = 0.4 * np.sin(t) + 0.05 * np.cos(p)
    return a * np.array([[1.0, b, 0, 0], [b, 1.0, 0, 0], [0, 0, 0.9, 0.1],
                         [0, 0, -0.1, 0.9]], np.float32)


def _textures(path):
    grid, pd, td, th = MP.bake(path)
    g3, nodes = MP.texture_arrays(grid, pd, td, th)
    gj, pdj, tdj, thj = MPJ.bake(path)
    tj = TextureJ(kind="pbsdf", grid3d=gj.reshape(NP, ND, NH, 48),
                  nodes=jnp.concatenate([pdj, tdj, thj]))
    return (Texture(kind="pbsdf", grid3d=torch.from_numpy(g3),
                    nodes=torch.from_numpy(nodes)), tj, grid, gj)


def _dirs(seed, n=256):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        v = rng.normal(size=(n, 3))
        v[:, 2] = np.abs(v[:, 2]) + 0.05
        out.append((v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
            np.float32))
    return out


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    return make_pbsdf_file(tmp_path_factory.mktemp("pbsdf") / "t.pbsdf",
                           _fresnel_like)


def test_bake_and_eval_match_jax(table):
    """``synthesize_tensor_file`` -> ``bake`` -> ``eval_m00``,
    ``eval_mueller_frames`` and ``eval_mueller_local`` on seeded
    direction pairs (some below the horizon), against JAX's."""
    tex, tj, grid, gj = _textures(table)
    np.testing.assert_array_equal(grid, np.asarray(gj))
    wi, wo = _dirs(1)
    wi[:8, 2] *= -1.0
    t = [torch.from_numpy(x) for x in (wi, wo)]
    j = [jnp.asarray(x) for x in (wi, wo)]
    np.testing.assert_allclose(MP.eval_m00(tex, *t).numpy(),
                               np.asarray(MPJ.eval_m00(tj, *j)), atol=1e-5)
    for a, b in zip(MP.eval_mueller_frames(tex, *t),
                    MPJ.eval_mueller_frames(tj, *j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    for a, b in zip(MP.eval_mueller_local(tex, *t),
                    MPJ.eval_mueller_local(tj, *j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_bsdf_sample_and_eval_pdf_match_jax(table):
    """The scalar pipeline's view: the mixture's sample (direction, pdf,
    the table's weight) and eval_pdf of a pBSDF slot beside a diffuse
    one, against JAX's on the same draws."""
    d = _pbsdf_scene(table, res=4, spp=1)
    sj = mi.load_dict(d(mi.ScalarTransform4f))
    st = mt.load_dict(d(mt.ScalarTransform4f), device="cpu")
    assert st.static.bsdf_kinds == sj.static.bsdf_kinds
    n = 512
    rng = np.random.default_rng(4)
    wi = _dirs(5, n)[0]
    s1 = rng.uniform(size=n).astype(np.float32)
    s2 = rng.uniform(size=(n, 2)).astype(np.float32)
    idx = (np.arange(n) % 2).astype(np.int32)
    bs, w, ok = B.sample(st.bsdfs, st.static.bsdf_kinds, torch.from_numpy(idx),
                         torch.from_numpy(wi), torch.from_numpy(s1),
                         torch.from_numpy(s2), textures=st.bsdf_textures(),
                         uv=torch.zeros(n, 2))
    bsj, wj, okj = BJ.sample(sj.bsdfs, sj.static.bsdf_kinds, jnp.asarray(idx),
                             jnp.asarray(wi), jnp.asarray(s1), jnp.asarray(s2),
                             textures=sj.textures, uv=jnp.zeros((n, 2)))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    okm = ok.numpy()
    np.testing.assert_allclose(bs.wo.numpy()[okm], np.asarray(bsj.wo)[okm],
                               atol=1e-5)
    np.testing.assert_allclose(bs.pdf.numpy()[okm], np.asarray(bsj.pdf)[okm],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=1e-4,
                               atol=1e-5)
    f, pdf = B.eval_pdf(st.bsdfs, st.static.bsdf_kinds, torch.from_numpy(idx),
                        torch.from_numpy(wi), bs.wo, textures=st.bsdf_textures(),
                        uv=torch.zeros(n, 2))
    fj, pdfj = BJ.eval_pdf(sj.bsdfs, sj.static.bsdf_kinds, jnp.asarray(idx),
                           jnp.asarray(wi), bsj.wo, textures=sj.textures,
                           uv=jnp.zeros((n, 2)))
    np.testing.assert_allclose(f.numpy(), np.asarray(fj), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(pdfj), rtol=1e-4,
                               atol=1e-5)


def _pbsdf_scene(path, res=8, spp=4):
    """The JAX package's ``_pbsdf_scene`` (a pBSDF floor under a light),
    with a diffuse back wall; a function of the package's transform."""
    def make(T):
        return {
            "type": "scene",
            "floor": {"type": "rectangle",
                      "to_world": T.scale(3).rotate([1, 0, 0], -90),
                      "bsdf": {"type": "measured_polarized",
                               "filename": path, "alpha_sample": 0.3}},
            "wall": {"type": "rectangle",
                     "to_world": T.translate([0, 0, -2]).scale(3),
                     "bsdf": {"type": "diffuse"}},
            "light": {"type": "rectangle",
                      "to_world": T.look_at(origin=[0, 4, 0],
                                            target=[0, 0, 0],
                                            up=[0, 0, 1]).scale(0.8),
                      "emitter": {"type": "area",
                                  "radiance": {"type": "rgb",
                                               "value": 10.0}}},
            "sensor": {"type": "perspective", "fov": 45,
                       "to_world": T.look_at(origin=[0, 2.5, 4],
                                             target=[0, 0, 0], up=[0, 1, 0]),
                       "film": {"type": "hdrfilm", "width": res,
                                "height": res},
                       "sampler": {"type": "independent",
                                   "sample_count": spp}},
        }
    return make


def test_stokes_render_matches_jax(table):
    """One ``stokes`` render of the pBSDF floor, loaded by each package's
    own loader, against JAX's; the table polarizes (S1 non-zero)."""
    d = _pbsdf_scene(table)
    integ = {"type": "stokes", "max_depth": 3}
    ref = np.asarray(mi.render(mi.load_dict(d(mi.ScalarTransform4f)), spp=4,
                               seed=0, integrator=integ))
    img = mt.render(mt.load_dict(d(mt.ScalarTransform4f), device="cpu"),
                    spp=4, seed=0, device="cpu", integrator=integ).numpy()
    assert np.isfinite(img).all()
    assert_images_close(img, ref)
    assert np.abs(img[..., 6:9]).mean() > 1e-3 * img[..., 3:6].mean()


# -- the reference's checks, on the port alone --------------------------------

def test_tensor_file_round_trip(tmp_path):
    path = make_pbsdf_file(tmp_path / "c.pbsdf", lambda p, t, h: np.eye(4) * 0.25)
    grid, pd, _, _ = MP.bake(path)
    assert grid.shape == (NP, ND, NH, 16, 3)
    g = grid.reshape(NP, ND, NH, 4, 4, 3)
    assert np.allclose(g[..., 0, 0, :], 0.25, atol=1e-5)
    assert np.allclose(g[..., 0, 1, :], 0.0, atol=1e-6)
    assert np.allclose(pd, np.linspace(-np.pi, np.pi, NP), atol=1e-6)
    mono, *_ = MP.bake(path, wavelength=520.0)
    assert np.allclose(mono.reshape(NP, ND, NH, 4, 4, 3)[..., 0, 0, :], 0.25,
                       atol=1e-6)


def _texture(path):
    g3, nodes = MP.texture_arrays(*MP.bake(path))
    return Texture(kind="pbsdf", grid3d=torch.from_numpy(g3),
                   nodes=torch.from_numpy(nodes))


def test_sample_eval_pdf_consistency(tmp_path):
    """A constant f_r = c: E[f cos / pdf] over the mixture is c pi, and
    eval_pdf's f cos / pdf is the sampled weight."""
    c = 0.2
    path = make_pbsdf_file(tmp_path / "d.pbsdf",
                           lambda p, t, h: np.diag([c, 0, 0, 0]))
    T = mt.ScalarTransform4f
    sc = mt.load_dict(_pbsdf_scene(path)(T), device="cpu")
    n = 8192
    gen = torch.Generator().manual_seed(1)
    wi = torch.tensor([[0.3, 0.1, 0.946]]).expand(n, 3)
    wi = wi / wi.norm(dim=-1, keepdim=True)
    idx = torch.zeros(n, dtype=torch.int32)
    tex = sc.bsdf_textures()
    bs, w, ok = B.sample(sc.bsdfs, sc.static.bsdf_kinds, idx, wi,
                         torch.rand(n, generator=gen),
                         torch.rand((n, 2), generator=gen),
                         torch.ones(n, dtype=torch.bool), textures=tex,
                         uv=torch.zeros(n, 2))
    est = float(torch.where(ok[..., None], w, 0.0).mean())
    assert abs(est - c * np.pi) / (c * np.pi) < 0.05, est
    f, pdf = B.eval_pdf(sc.bsdfs, sc.static.bsdf_kinds, idx, wi, bs.wo, ok,
                        textures=tex, uv=torch.zeros(n, 2))
    w2 = (f / torch.clamp(pdf, min=1e-12)[..., None]).numpy()
    okm = ok.numpy()
    assert np.allclose(w2[okm], w.numpy()[okm], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("matrix,name", [
    (np.diag([0.4, 0, 0, 0]).astype(np.float32), "depolarizer"),
    (POLARIZER, "polarizer")])
def test_mueller_frames_invariants(tmp_path, matrix, name):
    """A depolarizer table is invariant under the frame rotations
    (exactly depolarizer(M00)); a polarizer table gives unpolarized light
    a degree of polarization of 1 (the rotations only mix S1 and S2)."""
    tex = _texture(make_pbsdf_file(tmp_path / f"{name}.pbsdf",
                                   lambda p, t, h: matrix))
    wi, wo = _dirs(3, 32)
    M, ok = MP.eval_mueller_local(tex, torch.from_numpy(wi),
                                  torch.from_numpy(wo))
    assert bool(ok.all())
    M = M.numpy()
    if name == "depolarizer":
        assert np.allclose(M[:, 0, 0, :], 0.4, atol=1e-4)
        off = M.copy()
        off[:, 0, 0, :] = 0.0
        assert np.abs(off).max() < 1e-4
    else:
        s_in = torch.zeros((32, 4, 3))
        s_in[:, 0, :] = 1.0
        s_out = mu.matvec(torch.from_numpy(M), s_in).numpy()
        s0 = s_out[:, 0, :]
        assert np.allclose(s0, 0.5, atol=1e-3)
        assert np.allclose(np.linalg.norm(s_out[:, 1:, :], axis=1), s0,
                           rtol=1e-3, atol=1e-4)


def test_stokes_render_polarizing_table(tmp_path):
    """The Stokes integrator picks up the table's polarization: a
    diattenuator table gives S1 off normal, a depolarizer (numerically)
    none."""
    D = np.diag([0.3, 0, 0, 0]).astype(np.float32)
    F = 0.3 * np.array([[1.0, 0.4, 0, 0], [0.4, 1.0, 0, 0],
                        [0, 0, 0.9, 0], [0, 0, 0, 0.9]], np.float32)
    s1 = {}
    for name, mat in (("depol", D), ("fresnel", F)):
        path = make_pbsdf_file(tmp_path / f"{name}.pbsdf",
                               lambda p, t, h, mat=mat: mat)
        img = mt.render(mt.load_dict(_pbsdf_scene(path, res=16, spp=8)(
            mt.ScalarTransform4f), device="cpu"), spp=8, seed=0,
            device="cpu", integrator={"type": "stokes", "max_depth": 3}
        ).numpy()
        assert np.isfinite(img).all()
        s1[name] = np.abs(img[..., 6:9]).mean() / max(img[..., 3:6].mean(),
                                                      1e-6)
    assert s1["fresnel"] > 5 * max(s1["depol"], 1e-5), s1
