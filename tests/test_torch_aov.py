"""``depth``, ``aov`` and ``moment`` (``integrators/aov.py``) of the port
against the JAX package's, their gradients, and ``depth`` through the
BVH.

Tolerances, each with its reason:

- images: ``assert_images_close`` of ``test_torch_render.py`` (the same
  draws; XLA and PyTorch round a few operations differently);
- gradients: each within 1e-4 of its largest entry, as
  ``test_torch_prb.py`` holds PRB's (sums and gathers in another order);
- ``depth`` through the plain K2 against the plain brute force: equal
  (both find the same closest hit, to the bit).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from scenes import cornell_box as cornell_box_jax

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.ad import render as render_t
from epsm_mitsuba3_torch.integrators import aov as aov_t
from epsm_mitsuba3_torch.scenes import cornell_box, cornell_box_mesh

from test_torch_render import (assert_images_close, jax_leaf_grads,
                               port_scene_of)
from torch_threads import one_torch_thread  # noqa: F401

RES, SPP = 8, 2
#: every channel, under labels as the reference's ``aovs`` string names
#: them
ALL_AOVS = ("dd:depth, n:sh_normal,g:ng_normal, p:position,t:uv,a:albedo,"
            "m:alpha")


@pytest.fixture(scope="module")
def scenes():
    d = cornell_box_jax(res=RES, spp=SPP, max_depth=3)
    for k in ("floor", "ceiling", "back", "left", "right"):
        d[k]["face_normals"] = True
    sj = mi.load_dict(d)
    return sj, port_scene_of(sj)


@pytest.mark.parametrize("integ,channels", [
    ({"type": "depth"}, 3),
    ({"type": "aov", "aovs": ALL_AOVS, "max_depth": 2}, 3 + 16),
    ({"type": "moment", "max_depth": 3}, 6)])
def test_image_matches_jax(scenes, integ, channels):
    sj, st = scenes
    ref = np.asarray(mi.render(sj, spp=SPP, seed=3, integrator=integ))
    img = mt.render(st, spp=SPP, seed=3, device="cpu", integrator=integ)
    assert img.shape == (RES, RES, channels)
    assert bool(torch.isfinite(img).all()) and float(img.abs().mean()) > 0
    assert_images_close(img.numpy(), ref)


def test_aovs_string_parse():
    """The reference's parse (ad/render.py:199-203): the names after each
    ``:``; without a ``:`` anywhere, the four default channels."""
    assert render_t._aov_names({"aovs": ALL_AOVS}) == aov_t.AOV_CHANNELS
    assert render_t._aov_names({"aovs": "x:albedo"}) == ("albedo",)
    for cfg in ({}, {"aovs": "depth,albedo"}, {"aovs": ("uv",)}):
        assert render_t._aov_names(cfg) == aov_t.DEFAULT_AOVS
    sc = mt.load_dict(cornell_box(res=4, spp=1), device="cpu")
    img = mt.render(sc, spp=1, device="cpu", integrator={"type": "aov"})
    assert img.shape == (4, 4, 13)
    with pytest.raises(ValueError, match="unknown AOV 'bogus'"):
        mt.render(sc, spp=1, device="cpu",
                  integrator={"type": "aov", "aovs": "x:bogus"})


def test_depth_and_albedo_gradients_match_jax(scenes):
    """The depth channel's gradient w.r.t. the vertices and the albedo
    channel's w.r.t. the reflectances (through the surface interaction),
    against ``jax.grad``; the radiance channel carries none."""
    sj, st = scenes
    integ = {"type": "aov", "aovs": "d:depth,a:albedo", "max_depth": 2}
    W = np.random.default_rng(1).uniform(0, 1, (RES, RES, 7)).astype(
        np.float32)
    names = ("vertices", "bsdfs.reflectance")
    _, g = jax_leaf_grads(sj, lambda s: jnp.sum(mi.render(
        s, spp=SPP, seed=2, integrator=integ) * W), names)
    lv = {k: v.clone().requires_grad_(True) for k, v in st.leaves().items()
          if k in names}
    img = mt.render(st.with_leaves(lv), spp=SPP, seed=2, device="cpu",
                    integrator=integ)
    got = torch.autograd.grad((img * torch.from_numpy(W)).sum(),
                              list(lv.values()))
    for name, a in zip(lv, got):
        b = g[name]
        assert float(np.abs(b).max()) > 0, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * float(np.abs(b).max()),
                                   err_msg=name)


def test_moment_gradients_are_zero():
    """The reference stops the scene's gradient in the primal
    (integrators/path.py:245): every leaf's is zero, and the call does not
    raise; its mean channels equal ``path``'s image at the same seed."""
    sc = mt.load_dict(cornell_box(res=RES, spp=SPP, max_depth=3),
                      device="cpu")
    lv = {k: v.clone().requires_grad_(True) for k, v in sc.leaves().items()}
    img = mt.render(sc.with_leaves(lv), spp=SPP, device="cpu",
                    integrator={"type": "moment", "max_depth": 3})
    g = torch.autograd.grad(img.sum(), list(lv.values()))
    assert img.requires_grad and all(not x.any() for x in g)
    path = mt.render(sc, spp=SPP, device="cpu",
                     integrator={"type": "path", "max_depth": 3})
    assert torch.equal(img.detach()[..., :3], path)
    var = img.detach()[..., 3:] - path ** 2
    assert float(var.min()) > -1e-4


def test_stokes_stub_is_the_moment_layout():
    """``render_stokes`` (not on the dispatch): the radiance twice, then
    zeros; the radiance is ``moment``'s mean on the same draws."""
    sc = mt.load_dict(cornell_box(res=4, spp=2, max_depth=2), device="cpu")
    s = aov_t.render_stokes(sc, seed=1, spp=2, max_depth=2)
    m = aov_t.render_moment(sc, seed=1, spp=2, max_depth=2)
    assert s.shape == (4, 4, 15)
    assert torch.equal(s[..., :3], m[..., :3])
    assert torch.equal(s[..., 3:6], m[..., :3]) and not s[..., 6:].any()


def test_normals_are_the_aov_shading_normals():
    """``render_normals`` (not on the dispatch) seeds the independent
    sampler, as ``aov`` does on a scene of that kind: its image is the
    ``sh_normal`` channel."""
    sc = mt.load_dict(cornell_box(res=4, spp=2), device="cpu")
    n = aov_t.render_normals(sc, seed=3, spp=2)
    a = aov_t.render_aov(sc, seed=3, spp=2, aovs=("sh_normal",))
    assert n.shape == (4, 4, 3) and float(n.abs().sum()) > 0
    assert torch.equal(n, a[..., 3:])


def test_depth_on_the_mesh_through_k2_equals_brute_force():
    """``cornell_box_mesh`` (64,812 triangles) at 16^2 x 1 spp: the depth
    through the BVH's plain K2 equals the plain brute force's."""
    sc = mt.load_dict(cornell_box_mesh(res=16, spp=1), device="cpu")
    assert sc.bvh is not None
    img = mt.render(sc, spp=1, device="cpu", integrator={"type": "depth"})
    ref = mt.render(dataclasses.replace(sc, bvh=None), spp=1, device="cpu",
                    integrator={"type": "depth"})
    assert float(img.mean()) > 0 and torch.equal(img, ref)
