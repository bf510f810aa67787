"""The utilities that consume the new outputs (``utils/image.py``,
``utils/tonemap.py``, ``utils/denoiser.py``) against the JAX package's on
seeded arrays; ``register_integrator``; the loader's new integrator
types from a dict and from XML; the types ``render`` still refuses.

Tolerances, each with its reason:

- ``z_test``: p-values within 1e-12 relative (scipy's normal tail and
  PyTorch's float64 ``erfc``), the verdict and fail fraction equal;
- ``render_z_test``: the mean and variance within 1e-5 of their largest
  entry (``moment``'s image against JAX's, as ``test_torch_aov.py``);
- ``tonemap``, ``convert_to_bitmap``: float32 equal within 1 ulp-scale
  (2e-7), bytes equal but where the float32 value sits on a rounding
  edge (at most 1 level, on under 1 % of the entries);
- ``denoise``: 1e-5 of the largest entry (exp and sums in other orders).
"""
import numpy as np
import pytest
import torch

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.utils import denoiser as den_j
from epsm_mitsuba3_tpu.utils import image as img_j
from epsm_mitsuba3_tpu.utils import tonemap as tm_j
from scenes import cornell_box as cornell_box_jax

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.ad import render as render_t
from epsm_mitsuba3_torch.scenes import cornell_box
from epsm_mitsuba3_torch.utils import denoiser as den_t
from epsm_mitsuba3_torch.utils import image as img_t
from epsm_mitsuba3_torch.utils import tonemap as tm_t
from epsm_mitsuba3_torch.utils.xmlwrite import dict_to_xml

from test_torch_render import port_scene_of
from torch_threads import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(180)
HDR = (RNG.gamma(1.0, 0.6, (16, 16, 3)) * (RNG.random((16, 16, 1)) < 0.9)
       ).astype(np.float32)


def test_z_test_matches_jax():
    mean = RNG.uniform(0, 1, (12, 12, 3))
    var = RNG.uniform(0.01, 0.2, (12, 12, 3))
    for shift in (0.0, 0.02, 0.3):
        ref_img = mean + RNG.normal(0, 1, mean.shape) * np.sqrt(var / 64)
        ref_img[:3] += shift
        got = img_t.z_test(mean, var, ref_img, 64)
        want = img_j.z_test(mean, var, ref_img, 64)
        assert got[0] == want[0] and got[2] == want[2]
        np.testing.assert_allclose(got[1], want[1], rtol=1e-12, atol=1e-300)
    assert not got[0] and got[2] > 0


def test_render_z_test_matches_jax():
    sj = mi.load_dict(cornell_box_jax(res=8, spp=4, max_depth=3))
    st = port_scene_of(sj)
    m_j, v_j = img_j.render_z_test(sj, spp=4, seed=1, max_depth=3)
    m_t, v_t = img_t.render_z_test(st, spp=4, seed=1, max_depth=3,
                                   device="cpu")
    for a, b in ((m_t, m_j), (v_t, v_j)):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * float(np.abs(b).max()))
    ref = mt.render(st, spp=4, seed=9, device="cpu",
                    integrator={"type": "path", "max_depth": 3}).numpy()
    got = img_t.render_z_test(st, spp=4, seed=1, max_depth=3, reference=ref,
                              device="cpu")
    want = img_j.z_test(m_j, v_j, ref, 2)
    assert got[0] == want[0] and abs(got[2] - want[2]) < 1e-12


@pytest.mark.parametrize("method", ["gamma", "reinhard", "filmic"])
def test_tonemap_matches_jax(method):
    for exposure in (0.0, 1.5):
        got = tm_t.tonemap(torch.from_numpy(HDR), method, exposure)
        want = tm_j.tonemap(HDR, method, exposure)
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    with pytest.raises(ValueError, match="unknown tonemap"):
        tm_t.tonemap(HDR, "bogus")


def test_convert_to_bitmap_matches_jax(tmp_path):
    got = img_t.convert_to_bitmap(torch.from_numpy(HDR))
    want = np.asarray(img_j.convert_to_bitmap(HDR))
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    assert np.array_equal(img_t.convert_to_bitmap(HDR, False), HDR)
    img_t.write_bitmap(str(tmp_path / "a.npy"), torch.from_numpy(HDR))
    assert np.array_equal(np.load(tmp_path / "a.npy"), HDR)


@pytest.mark.parametrize("guides,variance", [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_denoise_matches_jax(guides, variance):
    nrm = RNG.normal(0, 1, (16, 16, 3)).astype(np.float32)
    alb = RNG.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    var = RNG.uniform(0, 0.05, (16, 16, 3)).astype(np.float32)
    args_j = (HDR, nrm if guides else None, alb if guides else None,
              var if variance else None)
    want = np.asarray(den_j.denoise(*args_j, iterations=3))
    args_t = [None if a is None else torch.from_numpy(a) for a in args_j]
    got = den_t.Denoiser(iterations=3)(*args_t)
    assert isinstance(got, torch.Tensor) and got.shape == (16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_register_integrator_dispatch():
    """A registered type is looked up before the built-in ones and gets
    the scene, the seed, the spp, the sensor and the integrator dict."""
    calls = []

    def fn(scene, seed, spp, sensor_idx, cfg):
        calls.append((seed, spp, sensor_idx, cfg["type"], cfg["gain"]))
        return torch.full((4, 4, 2), float(cfg["gain"]))

    sc = mt.load_dict(cornell_box(res=4, spp=3), device="cpu")
    try:
        mt.register_integrator("my_ao", fn)
        img = mt.render(sc, seed=5, device="cpu", spp_chunk=1,
                        integrator={"type": "my_ao", "gain": 2.0})
        assert torch.equal(img, torch.full((4, 4, 2), 2.0))
        assert calls == [(5, 3, 0, "my_ao", 2.0)]
        mt.register_integrator("depth", fn)
        mt.render(sc, device="cpu", integrator={"type": "depth", "gain": 1})
        assert calls[-1][3] == "depth"
    finally:
        render_t._CUSTOM_INTEGRATORS.clear()
    assert mt.render(sc, device="cpu",
                     integrator={"type": "depth"}).shape == (4, 4, 3)


@pytest.mark.parametrize("kind", ["depth", "aov", "moment", "ptracer"])
def test_integrator_types_load_and_render(tmp_path, kind):
    """A scene naming ``kind`` loads from a dict and from XML, as the JAX
    package's loader does, and renders on the CPU with it."""
    d = cornell_box(res=8, spp=2, max_depth=2)
    d["integrator"] = {"type": kind, "max_depth": 2}
    dict_to_xml(d, str(tmp_path / "box.xml"))
    channels = {"aov": 13, "moment": 6}.get(kind, 3)
    for sc in (mt.load_dict(d, device="cpu"),
               mt.load_file(str(tmp_path / "box.xml"), device="cpu")):
        assert dict(sc.static.integrator)["type"] == kind
        img = mt.render(sc, spp=2, device="cpu")
        assert img.shape == (8, 8, channels)
        assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0


@pytest.mark.parametrize("kind", ["spectral", "spectral_mono",
                                  "spectral_spec"])
def test_spectral_types_are_no_scene_element(kind):
    """The JAX package's loader does not list the spectral types (they are
    ``render`` arguments): a scene naming one raises ValueError in both."""
    dj = cornell_box_jax(res=4, spp=1)
    dj["integrator"] = {"type": kind}
    with pytest.raises(ValueError, match="unsupported scene element"):
        mi.load_dict(dj)
    d = cornell_box(res=4, spp=1)
    d["integrator"] = {"type": kind}
    with pytest.raises(ValueError, match="unsupported scene element"):
        mt.load_dict(d, device="cpu")


def test_unported_types_are_refused_by_name():
    sc = mt.load_dict(cornell_box(res=4, spp=1), device="cpu")
    for kind in ("volpath", "prbvolpath", "volpathmis"):
        assert kind not in render_t.TYPES
        with pytest.raises(NotImplementedError,
                           match=f"integrator '{kind}' is not ported"):
            mt.render(sc, device="cpu", integrator={"type": kind})
