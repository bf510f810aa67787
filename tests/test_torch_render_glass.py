"""The port's path tracer and PRB replay through a delta transmission (the
smooth dielectric) and a glossy lobe (the GGX rough conductor) against
the JAX package's: the caustic scene of ``tests/test_epsm2.py`` by the
golden Z-test of ``tests/test_golden.py`` (spp 64, seed 11, depth 4, as
it runs there), and pixel for pixel at 16^2 x 4 spp; glossyball and
highlight pixel for pixel; and PRB gradients of the caustic (with
Russian roulette from depth 2, so that the roulette's eta^2 has work) and
of glossyball against ``jax.grad``.

Tolerances: images as ``test_torch_render.py``'s ``assert_images_close``
(mean |diff| <= 1e-4, >= 99 % of pixels within 1e-4); gradients within
1e-4 of their largest entry, as ``test_torch_prb.py``'s.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.app.exp import glossyball as glossyball_j
from epsm_mitsuba3_tpu.app.exp import highlight as highlight_j
from epsm_mitsuba3_tpu.utils.image import z_test
from test_epsm2 import caustic_scene

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.integrators import common as common_t
from epsm_mitsuba3_torch.integrators import path as path_t
from epsm_mitsuba3_torch.models import films as films_t
from epsm_mitsuba3_torch.models import samplers as smp_t
from epsm_mitsuba3_torch.ops import accel

from test_torch_render import assert_images_close, port_scene_of
from test_torch_prb import _assert_grad_close
from torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
RES, SPP = 16, 4


def _jax_scene(name):
    if name == "caustic":
        return caustic_scene(res=RES, spp=SPP), 4
    mod = {"glossyball": glossyball_j, "highlight": highlight_j}[name]
    return mod.make(resolution=RES, spp=SPP, match_res=8)["scene"], 2


@pytest.mark.parametrize("name", ["caustic", "glossyball", "highlight"])
def test_render_matches_jax(name):
    sj, depth = _jax_scene(name)
    integ = {"type": "path", "max_depth": depth}
    ref = np.asarray(mi.render(sj, spp=SPP, seed=0, integrator=integ))
    img = mt.render(port_scene_of(sj), spp=SPP, seed=0, integrator=integ,
                    device="cpu").numpy()
    assert np.isfinite(img).all() and img.mean() > 0
    assert_images_close(img, ref)


def test_golden_caustic_z_test(monkeypatch):
    """The golden Z-test of tests/test_golden.py on the caustic scene,
    the port's path tracer giving mean and per-sample variance at 64 spp,
    seed 11, depth 4.  The scene's 3,972 triangles go through a BVH here
    (the brute-force threshold lowered for this test): the brute force's
    plain version takes ~45 s a query at 65,536 rays on one CPU thread,
    the BVH's ~0.7 s, and the two are held equal in
    ``tests/test_torch_bvh.py``."""
    monkeypatch.setattr(accel, "BRUTE_FORCE_MAX_TRIS", 1024)
    ref = np.load(os.path.join(DATA, "golden_caustic.npz"))
    scene = port_scene_of(caustic_scene(res=32, spp=8))
    assert scene.bvh is not None and not accel.use_brute_force(scene)
    spp = 64
    sampler = smp_t.seed(11, 32 * 32 * spp, device="cpu")
    sampler, ray, weight, _ = common_t.sample_rays(scene.sensors[0], sampler,
                                                   spp)
    L, _ = path_t.sample_primal(scene, sampler, ray, 4, 5)
    v = L * weight
    img6 = films_t.accumulate_coalesced(torch.cat([v, v * v], -1), 32, 32,
                                        spp).numpy()
    mean = img6[..., :3]
    var = np.maximum(img6[..., 3:] - mean ** 2, 0.0) * spp / (spp - 1)
    ok, pmin, fails = z_test(mean, np.maximum(var, ref["var"]), ref["mean"],
                             spp, significance=0.01)
    assert fails < 0.02, (pmin, fails)


def _weights():
    return np.random.default_rng(3).uniform(0, 1, (RES, RES, 3)).astype(
        np.float32)


@pytest.mark.parametrize("name,names,integ", [
    ("caustic", ("normals", "bsdfs.reflectance", "emitters.radiance"),
     {"type": "prb", "max_depth": 6, "rr_depth": 2}),
    ("glossyball", ("vertices", "bsdfs.alpha", "bsdfs.eta_c",
                    "bsdfs.reflectance"),
     {"type": "prb", "max_depth": 3}),
])
def test_prb_gradients_match_jax(name, names, integ):
    """The fused replay's gradients through the glass (the roulette from
    depth 2 weighs by eta^2; a delta lobe's eval is 0, so in both packages
    no gradient reaches the glass's own columns) and through the glossy
    lobe (alpha, eta)."""
    sj, _ = _jax_scene(name)
    W = _weights()
    g = jax.grad(lambda s: jnp.sum(mi.render(s, spp=SPP, seed=0,
                                             integrator=integ) * W),
                 allow_int=True)(sj)
    st = port_scene_of(sj)
    lv = {k: v.clone().requires_grad_(True)
          for k, v in st.leaves().items() if k in names}
    img = mt.render(st.with_leaves(lv), spp=SPP, seed=0, integrator=integ,
                    device="cpu")
    got = dict(zip(lv, (x.numpy() for x in torch.autograd.grad(
        (img * torch.from_numpy(W)).sum(), list(lv.values())))))
    for k in names:
        ref = getattr(g, k) if "." not in k else getattr(
            g, k.split(".")[0])[k.split(".")[1]]
        _assert_grad_close(got[k], ref, k)


def test_prb_alpha_gradient_sign_matches_fd():
    """glossyball's PRB roughness gradient agrees in sign and within 5 %
    with central finite differences of the port's own render (the
    reference's FD bar, ``tests/test_ad.py``)."""
    sj, _ = _jax_scene("glossyball")
    st = port_scene_of(sj)
    W = torch.from_numpy(_weights())
    slot = int(st.shape_bsdf[list(st.static.shape_names).index("ball")])
    integ = {"type": "prb", "max_depth": 2}
    base = st.bsdfs["alpha"]
    alpha = base.clone().requires_grad_(True)
    img = mt.render(st.with_leaves({"bsdfs.alpha": alpha}), spp=16, seed=0,
                    integrator=integ, device="cpu")
    (grad,) = torch.autograd.grad((img * W).sum(), alpha)
    eps = 1e-2

    def loss(a):
        alpha = base.clone()
        alpha[slot] = a
        img = mt.render(st.with_leaves({"bsdfs.alpha": alpha}), spp=16,
                        seed=0, integrator=integ, device="cpu")
        return float((img * W).sum())

    a0 = float(base[slot])
    fd = (loss(a0 + eps) - loss(a0 - eps)) / (2 * eps)
    g = float(grad[slot])
    assert np.sign(g) == np.sign(fd) and abs(g - fd) <= 0.05 * abs(fd), (
        g, fd)
