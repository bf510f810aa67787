"""The polarized pipeline (``integrators/polarized.py``, the ``stokes``
integrator, the ``polarizer``, ``retarder`` and ``circular`` kinds) of
the port against the JAX package's, and the reference's integrator
checks (JAX ``tests/test_polarized.py:82-215``) on the port alone.

Tolerances, each with its reason:

- the Stokes image: ``assert_images_close`` of ``test_torch_render.py``
  (the same draws; XLA and PyTorch round a few operations differently);
- the loaded table columns: equal (the same degrees-to-radians in
  float64, cast to float32);
- S0 of a diffuse box against ``path``'s estimate at the same seed: 1e-5,
  the JAX package's bar (:190);
- the physics checks: the JAX package's own bars.
"""
import numpy as np
import pytest
import torch

import epsm_mitsuba3_tpu as mi
from scenes import cornell_box as cornell_box_jax

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.ad import render as render_t
from epsm_mitsuba3_torch.integrators import common
from epsm_mitsuba3_torch.integrators import path as P
from epsm_mitsuba3_torch.integrators import polarized
from epsm_mitsuba3_torch.models import films
from epsm_mitsuba3_torch.scenes import cornell_box

from test_torch_render import assert_images_close, jax_arrays, port_scene_of
from torch_threads import one_torch_thread  # noqa: F401

RES, SPP = 8, 4
STOKES = {"type": "stokes", "max_depth": 4}


def element_box(box, T):
    """The Cornell box ``box`` with a linear polarizer (30 degrees), a
    retarder and a circular polarizer in front of the back wall, a thin
    glass pane and a conductor right wall: every branch of
    ``physical_mueller``.  ``T``: the package's ScalarTransform4f."""
    def plate(x, y, bsdf):
        return {"type": "rectangle",
                "to_world": T.translate([x, y, 0.2]).scale(0.35),
                "bsdf": bsdf}
    box["polarizer"] = plate(-0.45, 1.3, {"type": "polarizer", "theta": 30.0})
    box["retarder"] = plate(0.45, 1.3, {"type": "retarder", "theta": 20.0,
                                        "delta": 60.0})
    box["circular"] = plate(-0.45, 0.55, {"type": "circular",
                                          "transmittance": 0.8})
    box["pane"] = plate(0.45, 0.55, {"type": "thindielectric"})
    box["right"]["bsdf"] = {
        "type": "conductor",
        "eta": {"type": "rgb", "value": [0.2, 0.9, 1.1]},
        "k": {"type": "rgb", "value": [3.0, 2.5, 2.2]}}
    return box


@pytest.fixture(scope="module")
def scenes():
    sj = mi.load_dict(element_box(
        cornell_box_jax(res=RES, spp=SPP, max_depth=4), mi.ScalarTransform4f))
    return sj, port_scene_of(sj)


def test_render_stokes_matches_jax(scenes):
    """``render(scene, integrator={"type": "stokes"})`` on the box with
    the three elements, the pane and the conductor: (H, W, 15) equal to
    JAX's; the elements polarize (S1, S2 non-zero), the circular one
    gives S3."""
    sj, st = scenes
    ref = np.asarray(mi.render(sj, spp=SPP, seed=3, integrator=STOKES))
    img = mt.render(st, spp=SPP, seed=3, device="cpu", integrator=STOKES)
    assert img.shape == (RES, RES, 15) and bool(torch.isfinite(img).all())
    assert_images_close(img.numpy(), ref)
    for k in (6, 9, 12):
        assert float(img[..., k:k + 3].abs().max()) > 1e-3, k


def test_load_dict_equals_jax():
    """The port's own loader on the port's dict: every table column
    (``pol_theta``, ``pol_delta`` in radians, the transmittances) and the
    kinds equal to JAX's load of the JAX dict, and the render equal to
    the one from JAX's arrays."""
    dj = element_box(cornell_box_jax(res=4, spp=2, max_depth=3),
                     mi.ScalarTransform4f)
    sj = mi.load_dict(dj)
    st = mt.load_dict(element_box(cornell_box(res=4, spp=2, max_depth=3),
                                  mt.ScalarTransform4f), device="cpu")
    ref = jax_arrays(sj)
    for k, v in st.bsdfs.items():
        np.testing.assert_array_equal(v.numpy(),
                                      ref[f"bsdfs.{k}"].astype(v.numpy().dtype),
                                      k)
    assert st.static.bsdf_kinds == sj.static.bsdf_kinds
    np.testing.assert_array_equal(
        mt.render(st, spp=2, seed=1, device="cpu", integrator=STOKES).numpy(),
        mt.render(port_scene_of(sj), spp=2, seed=1, device="cpu",
                  integrator=STOKES).numpy())


def test_stokes_dispatch_and_zero_gradient():
    """``stokes`` is on ``render``'s dispatch, its depth the config's (6
    where the scene sets none, as the reference reads it after its
    default); every scene leaf that requires grad gets a zero gradient,
    as the reference stops the scene's."""
    assert "stokes" in render_t.TYPES
    sc = mt.load_dict(cornell_box(res=4, spp=2, max_depth=3), device="cpu")
    refl = sc.bsdfs["reflectance"].clone().requires_grad_(True)
    sc = sc.with_leaves({"bsdfs.reflectance": refl})
    img = mt.render(sc, spp=2, seed=0, device="cpu",
                    integrator={"type": "stokes"})
    (g,) = torch.autograd.grad(img.sum(), refl)
    assert float(g.abs().max()) == 0.0
    direct = polarized.render_stokes(sc, seed=0, spp=2, max_depth=3)
    np.testing.assert_array_equal(img.detach().numpy(),
                                  direct.detach().numpy())


# -- the reference's integrator checks, on the port alone ---------------------

def _plate_scene(theta_deg, res=16):
    """A constant white environment seen through a polarizer plate (JAX
    tests/test_polarized.py:82-100)."""
    T = mt.ScalarTransform4f
    return {
        "type": "scene",
        "light": {"type": "constant",
                  "radiance": {"type": "rgb", "value": [1.0, 1.0, 1.0]}},
        "plate": {"type": "rectangle",
                  "to_world": T.translate([0, 0, 2.0]).scale(8.0),
                  "bsdf": {"type": "polarizer", "theta": theta_deg}},
        "sensor": {"type": "perspective", "fov": 40,
                   "to_world": T.look_at(origin=[0, 0, 0], target=[0, 0, 1],
                                         up=[0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": res,
                            "height": res}},
    }


def _stokes(d, spp=8, max_depth=4):
    sc = mt.load_dict(d, device="cpu")
    return polarized.render_stokes(sc, seed=3, spp=spp,
                                   max_depth=max_depth).numpy()


def test_polarizer_plate_dop_and_angle():
    """Unpolarized light through an ideal polarizer: S0 halves, the degree
    of polarization is 1, and the angle follows the element's by the
    double-angle law (mod 180 degrees, unsigned)."""
    img0 = _stokes(_plate_scene(0.0))
    c = img0.shape[0] // 2
    s0, q, u = (img0[c, c, k:k + 3].mean() for k in (3, 6, 9))
    assert abs(s0 - 0.5) < 0.02
    assert np.hypot(q, u) / s0 > 0.98
    img45 = _stokes(_plate_scene(45.0))
    q45, u45 = img45[c, c, 6:9].mean(), img45[c, c, 9:12].mean()
    delta = abs(np.rad2deg(0.5 * np.arctan2(u45, q45)
                           - 0.5 * np.arctan2(u, q))) % 180.0
    assert abs(min(delta, 180.0 - delta) - 45.0) < 3.0


def test_crossed_polarizers_extinguish():
    """Two plates at 90 degrees pass (almost) nothing, parallel ones
    half; between the two, Malus's law at 60 degrees (cos^2 = 1/4)."""
    d = _plate_scene(0.0)
    d["plate2"] = {"type": "rectangle",
                   "to_world": mt.ScalarTransform4f.translate(
                       [0, 0, 1.0]).scale(8.0),
                   "bsdf": {"type": "polarizer", "theta": 90.0}}
    c = 8
    assert _stokes(d, max_depth=5)[c, c, 3:6].mean() < 1e-3
    d["plate2"]["bsdf"]["theta"] = 0.0
    assert _stokes(d, max_depth=5)[c, c, 3:6].mean() > 0.4
    d["plate2"]["bsdf"]["theta"] = 60.0
    assert abs(_stokes(d, max_depth=5)[c, c, 3:6].mean() - 0.125) < 0.01


def test_conductor_reflection_polarizes():
    """Oblique reflection off a metal partially polarizes the unpolarized
    environment (conductor.cpp's polarized branch); S0 stays near the
    scalar pipeline's image (the JAX package's bars)."""
    T = mt.ScalarTransform4f
    d = {
        "type": "scene",
        "light": {"type": "constant",
                  "radiance": {"type": "rgb", "value": [1.0, 1.0, 1.0]}},
        "mirror": {"type": "rectangle", "to_world": T.scale(4.0),
                   "bsdf": {"type": "conductor",
                            "eta": {"type": "rgb", "value": [0.2] * 3},
                            "k": {"type": "rgb", "value": [3.0] * 3}}},
        "sensor": {"type": "perspective", "fov": 10,
                   "to_world": T.look_at(origin=[0, 3.0, 2.1],
                                         target=[0, 0, 0], up=[0, 0, 1]),
                   "film": {"type": "hdrfilm", "width": 16, "height": 16}},
    }
    img = _stokes(d, max_depth=3)
    c = img.shape[0] // 2
    s0 = img[c, c, 3:6].mean()
    assert s0 > 0.5
    assert np.hypot(img[c, c, 6:9].mean(), img[c, c, 9:12].mean()) / s0 > 0.02
    ref = mt.render(mt.load_dict(d, device="cpu"), spp=8, seed=3,
                    device="cpu",
                    integrator={"type": "path", "max_depth": 3}).numpy()
    rel = abs(img[c, c, 0:3].mean() - ref[c, c].mean()) / max(
        ref[c, c].mean(), 1e-6)
    assert rel < 0.35


def test_stokes_s0_matches_path_diffuse():
    """A diffuse box: S0 is ``path``'s estimate on the same sampler
    streams, and S1..S3 are 0 (every lobe depolarizes)."""
    sc = mt.load_dict(cornell_box(res=16, spp=4, max_depth=4), device="cpu")
    img = polarized.render_stokes(sc, seed=0, spp=4, max_depth=4).numpy()
    sensor, _, sampler, ray, w, _ = common.camera(sc, 0, 0, 4)
    L, _ = P.sample_primal(sc, sampler, ray, 4, 5)
    ref = films.accumulate_coalesced(L * w, sensor.width, sensor.height,
                                     4).numpy()
    np.testing.assert_allclose(img[..., 0:3], ref, rtol=0, atol=1e-5)
    assert np.abs(img[..., 6:]).max() < 1e-5
