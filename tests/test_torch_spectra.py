"""Tabulated spectra: the port's ``core/spectral.py`` (the CIE 1931
fits, the 6504 K illuminant, the white-balanced sRGB projection) and the
loader's ``_rgb`` on ``regular`` and ``irregular`` spectra, the Mitsuba
string form ``"lam:v, ..."`` and the 360-830 nm default range, against
the JAX package's on the same inputs; and each place ``_rgb`` reads a
colour (a reflectance, an emitter's radiance, intensity and irradiance,
a conductor's ``eta`` and ``k``) in ``load_dict`` against JAX's table.

Tolerance: none.  Both packages compute these in numpy float64 on the
host and round to float32 at the same step, so every value is equal bit
for bit.
"""
import numpy as np
import pytest

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.core import spectral as SJ
from epsm_mitsuba3_tpu.models.scene import _rgb as rgb_j
from scenes import cornell_box as cornell_box_jax

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.core import spectral as ST
from epsm_mitsuba3_torch.models.scene import _rgb as rgb_t

from test_torch_render_emitters import plain

RNG = np.random.default_rng(13)

#: JAX's own cases (``tests/test_spectral.py:106-122``), then seeded ones
SPECTRA = [
    {"type": "regular", "wavelength_min": 360, "wavelength_max": 830,
     "values": [1.0] * 20},
    {"type": "irregular", "value": "400:0, 580:0, 610:1, 700:1"},
    {"type": "regular", "wavelength_min": 500, "wavelength_max": 560,
     "values": [1.0, 1.0]},
    {"type": "regular", "values": RNG.random(7).tolist()},
    {"type": "regular", "lambda_min": 420.5, "lambda_max": 690.0,
     "values": RNG.random(33).tolist(), "scale": 2.5},
    {"type": "irregular", "wavelengths": [380.0, 455.5, 530.0, 700.0, 790.0],
     "values": RNG.random(5).tolist()},
    {"type": "irregular", "value": "350:0.3,  450:1.2 , 520:0.1, 900:4"},
    {"type": "irregular", "value": "550:1"},
    {"type": "irregular", "wavelengths": [400.0, 600.0],
     "values": [0.5, 0.25], "scale": 0.1},
]


def test_cie_and_illuminant_equal_jax():
    w = np.linspace(300.0, 900.0, 257)
    np.testing.assert_array_equal(ST.cie1931_xyz(w),
                                  SJ.cie1931_xyz(w, xp=np))
    np.testing.assert_array_equal(ST.illuminant_spd(w),
                                  SJ.illuminant_spd(w, xp=np))
    np.testing.assert_array_equal(ST.XYZ_TO_SRGB,
                                  np.asarray(SJ._XYZ_TO_SRGB))


def test_projection_equals_jax():
    for a, b in zip(ST._projection(), SJ._projection()):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    fn = lambda lam: np.sin(np.asarray(lam, np.float64) / 37.0) ** 2
    np.testing.assert_array_equal(ST.project_to_rgb(fn),
                                  SJ.project_to_rgb(fn))


@pytest.mark.parametrize("i", range(len(SPECTRA)))
def test_rgb_of_spectrum_equals_jax(i):
    got, ref = rgb_t(dict(SPECTRA[i])), rgb_j(dict(SPECTRA[i]))
    assert got.dtype == ref.dtype == np.float32 and got.shape == (3,)
    np.testing.assert_array_equal(got, ref)


def test_jax_spectral_cases_hold_in_the_port():
    """``tests/test_spectral.py::test_tabulated_spectra_to_rgb``'s
    assertions on the port's ``_rgb``."""
    flat, red, green = (rgb_t(s) for s in SPECTRA[:3])
    np.testing.assert_allclose(flat, [1.0, 1.0, 1.0], atol=1e-3)
    assert red[0] > 3 * max(abs(red[1]), abs(red[2]))
    assert green[1] > green[0] and green[1] > green[2]


def test_every_colour_slot_takes_a_spectrum():
    """Reflectances, an area light's radiance, a point light's intensity,
    a directional light's irradiance and a conductor's eta and k, each
    a tabulated spectrum: the port's tables equal JAX's."""
    d = cornell_box_jax(res=8, spp=1, max_depth=2)
    d["left"]["bsdf"]["reflectance"] = SPECTRA[3]
    d["right"]["bsdf"]["reflectance"] = SPECTRA[6]
    d["light"]["emitter"]["radiance"] = dict(SPECTRA[4])
    d["back"]["bsdf"] = {"type": "conductor", "eta": SPECTRA[5],
                         "k": SPECTRA[8]}
    d["bulb"] = {"type": "point", "position": [0, 1.5, 0],
                 "intensity": SPECTRA[1]}
    d["sun"] = {"type": "directional", "direction": [0, -1, 0.2],
                "irradiance": SPECTRA[7]}
    st = mt.load_dict(plain(d), device="cpu")
    sj = mi.load_dict(d)
    for k in ("reflectance", "eta_c", "k_c"):
        np.testing.assert_array_equal(st.bsdfs[k].numpy(),
                                      np.asarray(sj.bsdfs[k]), k)
    for k in ("radiance", "intensity", "irradiance"):
        np.testing.assert_array_equal(st.emitters[k].numpy(),
                                      np.asarray(sj.emitters[k]), k)
    assert np.abs(st.emitters["radiance"].numpy()[0]).max() > 0
