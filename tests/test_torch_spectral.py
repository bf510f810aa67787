"""The spectral half of ``core/spectral.py`` and the ``spectral`` family
of ``integrators/spectral.py`` against the JAX package's.

Tolerances, each with its reason:

- wavelengths and pdfs: 1e-4 nm / 5e-6 relative (XLA's and PyTorch's
  ``atanh`` a few ulp apart, and ``cosh``^2 of the wavelength; 1.2e-6
  seen);
- ``fit_reflectance``: the coefficients within 1e-3 (1 + |c|) and the
  spectra within 1e-3 on at least 99 % of 2,000 seeded RGB lanes, and on
  black, white and values above 1 every lane.  The fit is 20 damped
  Gauss-Newton steps in float32; on colours the sigmoid model cannot
  reach (saturated ones: the reference's own fit misses some by 0.96)
  the steps amplify last-bit differences of the two solves (XLA's LU,
  the port's closed-form Cholesky), so a few lanes there part;
- the developments: 1e-5 of the largest entry (sums in another order);
- the render: ``assert_images_close`` of ``test_torch_render.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.core import spectral as sp_j
from epsm_mitsuba3_tpu.integrators import spectral as spi_j
from scenes import cornell_box as cornell_box_jax

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.core import spectral as sp_t
from epsm_mitsuba3_torch.integrators import common as common_t
from epsm_mitsuba3_torch.integrators import spectral as spi_t
from epsm_mitsuba3_torch.models import films as films_t
from epsm_mitsuba3_torch.models import samplers as smp_t
from epsm_mitsuba3_torch.scenes import cornell_box

from test_torch_render import assert_images_close, port_scene_of
from torch_threads import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(18)
U = RNG.random(2000).astype(np.float32)
RGB = RNG.random((2000, 3)).astype(np.float32)
EDGES = np.array([[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1.5, 0.7, 0.2],
                  [3.0, 3.0, 3.0], [2.0, 0.4, 1.2]], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _wavelengths(k=4):
    lam_j, pdf_j = sp_j.sample_wavelengths(jnp.asarray(U), k)
    lam_t, pdf_t = sp_t.sample_wavelengths(_t(U), k)
    return np.asarray(lam_j), np.asarray(pdf_j), lam_t, pdf_t


def test_sample_wavelengths_and_pdf():
    lam_j, pdf_j, lam_t, pdf_t = _wavelengths()
    assert lam_t.shape == (2000, 4)
    np.testing.assert_allclose(lam_t.numpy(), lam_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(pdf_t.numpy(), pdf_j, rtol=5e-6, atol=0)
    lam = np.linspace(300, 900, 61).astype(np.float32)
    np.testing.assert_allclose(sp_t.pdf_visible(_t(lam)).numpy(),
                               np.asarray(sp_j.pdf_visible(lam)),
                               rtol=5e-6, atol=0)


def test_eval_sigmoid():
    c = RNG.normal(0, 3, (500, 3)).astype(np.float32)
    lam = RNG.uniform(360, 830, (500, 7)).astype(np.float32)
    np.testing.assert_allclose(sp_t.eval_sigmoid(_t(c), _t(lam)).numpy(),
                               np.asarray(sp_j.eval_sigmoid(c, lam)),
                               rtol=0, atol=2e-7)


def test_fit_reflectance_matches_jax():
    lam_j = _wavelengths()[0]
    rgb = np.concatenate([RGB, EDGES])
    c_j = np.asarray(sp_j.fit_reflectance(jnp.asarray(rgb)))
    c_t = sp_t.fit_reflectance(_t(rgb)).numpy()
    lam = np.concatenate([lam_j, lam_j[:len(EDGES)]])
    s_j = np.asarray(sp_j.reflectance_to_spectrum(jnp.asarray(rgb), lam))
    s_t = sp_t.reflectance_to_spectrum(_t(rgb), _t(lam)).numpy()
    e_j = np.asarray(sp_j.emission_to_spectrum(jnp.asarray(rgb), lam))
    e_t = sp_t.emission_to_spectrum(_t(rgb), _t(lam)).numpy()
    assert np.isfinite(c_t).all() and np.isfinite(s_t).all()
    c_ok = (np.abs(c_t - c_j) <= 1e-3 * (1 + np.abs(c_j))).all(-1)
    s_ok = (np.abs(s_t - s_j) <= 1e-3 * np.maximum(1, rgb.max(-1))[:, None]
            ).all(-1)
    e_ok = (np.abs(e_t - e_j) <= 1e-3 * np.abs(e_j).max()).all(-1)
    n = len(RGB)
    for ok in (c_ok, s_ok, e_ok):
        assert ok[:n].mean() >= 0.99, ok[:n].mean()
        assert ok[n:].all()          # black, white, grey, above 1


def test_developments_match_jax():
    lam_j, pdf_j, lam_t, pdf_t = _wavelengths()
    S = RNG.uniform(0, 3, lam_j.shape).astype(np.float32)
    for fn_j, fn_t in ((sp_j.spectrum_to_rgb, sp_t.spectrum_to_rgb),
                       (sp_j.spectrum_to_mono, sp_t.spectrum_to_mono)):
        ref = np.asarray(fn_j(jnp.asarray(S), lam_j, pdf_j))
        got = fn_t(_t(S), _t(lam_j), _t(pdf_j)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    for n_bins in (8, 16):
        ref = np.asarray(spi_j._bin_spectrum(jnp.asarray(S), lam_j, pdf_j,
                                             n_bins))
        got = spi_t._bin_spectrum(_t(S), _t(lam_j), _t(pdf_j),
                                  n_bins).numpy()
        assert got.shape == (2000, n_bins)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    assert sp_t._radiance_norm() == sp_j._radiance_norm()


def test_develop_round_trip():
    """JAX's tests/test_spectral.py:21-37 on the port: develop(lift(rgb))
    == rgb within 0.02 for the emission lift, and a reflectance under the
    white emission scales linearly."""
    u = torch.from_numpy(np.random.default_rng(0).random(100_000)
                         .astype(np.float32))
    lam, pdf = sp_t.sample_wavelengths(u, 4)
    for rgb in ([1.0, 1.0, 1.0], [0.3, 0.6, 0.9], [0.7, 0.1, 0.05]):
        S = sp_t.emission_to_spectrum(torch.tensor(rgb), lam)
        back = sp_t.spectrum_to_rgb(S, lam, pdf).mean(0).numpy()
        assert np.abs(back - np.asarray(rgb)).max() < 0.02, (rgb, back)
    se = sp_t.emission_to_spectrum(torch.tensor([1.0, 1.0, 1.0]), lam)
    sr = sp_t.reflectance_to_spectrum(torch.tensor([0.25, 0.5, 0.75]), lam)
    back = sp_t.spectrum_to_rgb(se * sr, lam, pdf).mean(0).numpy()
    assert np.abs(back - np.asarray([0.25, 0.5, 0.75])).max() < 0.02


def _gray_box(fn, res, spp):
    d = fn(res=res, spp=spp, max_depth=3)
    for v in d.values():
        if isinstance(v, dict) and "bsdf" in v:
            v["bsdf"]["reflectance"]["value"] = [0.5, 0.5, 0.5]
    return d


def test_spectral_render_matches_jax():
    """``render(..., {"type": "spectral"})`` of the gray box at 8^2 x 2
    spp, depth 3, against the JAX package's."""
    sj = mi.load_dict(_gray_box(cornell_box_jax, 8, 2))
    integ = {"type": "spectral", "max_depth": 3}
    ref = np.asarray(mi.render(sj, spp=2, seed=4, integrator=integ))
    img = mt.render(port_scene_of(sj), spp=2, seed=4, device="cpu",
                    integrator=integ).numpy()
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert float(np.abs(ref).mean()) > 0
    assert_images_close(img, ref)


@pytest.mark.parametrize("kind,channels", [("spectral_mono", 1),
                                           ("spectral_spec", 8)])
def test_mono_and_spec_develop_the_port_samples(kind, channels):
    """``spectral_mono`` / ``spectral_spec`` equal the development (held
    against JAX above) of the port's own ``sample_spectral`` on the same
    draws, filmed per pixel; the box filter and the gaussian."""
    for rfilter in ("box", "gaussian"):
        d = cornell_box(res=8, spp=2, max_depth=3)
        d["sensor"]["film"]["rfilter"] = {"type": rfilter}
        sc = mt.load_dict(d, device="cpu")
        img = mt.render(sc, spp=2, seed=5, device="cpu",
                        integrator={"type": kind, "max_depth": 3,
                                    "n_bins": channels})
        sensor, _, sampler, ray, weight, pos = common_t.camera(sc, 5, 0, 2)
        sampler, u = smp_t.next_1d(sampler)
        lam, pdf = sp_t.sample_wavelengths(u, 4)
        S, _ = spi_t.sample_spectral(sc, sampler, ray, lam, 3)
        value = (sp_t.spectrum_to_mono(S, lam, pdf) if channels == 1
                 else spi_t._bin_spectrum(S, lam, pdf, channels))
        value = value * weight[..., :1]
        if rfilter == "box":
            ref = films_t.accumulate_coalesced(value, 8, 8, 2)
        else:
            ref = films_t.develop(*films_t.splat_coalesced(
                pos - torch.floor(pos), value, 8, 8, 2, rfilter))
        assert img.shape == (8, 8, channels)
        assert torch.equal(img, ref) and float(img.sum()) > 0


def test_spectral_gradients_are_zero():
    sc = mt.load_dict(cornell_box(res=8, spp=1, max_depth=2), device="cpu")
    lv = {k: v.clone().requires_grad_(True) for k, v in sc.leaves().items()}
    for kind in spi_t.MODES:
        img = mt.render(sc.with_leaves(lv), spp=1, device="cpu",
                        integrator={"type": kind, "max_depth": 2})
        g = torch.autograd.grad(img.sum(), list(lv.values()))
        assert float(img.detach().sum()) > 0
        assert all(not x.any() for x in g), kind
