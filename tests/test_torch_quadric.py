"""The analytic sphere (``ops/quadric.py``) in the port against the JAX
package: the loader's table, the hit record, occlusion, a 16^2 render,
the centre and radius gradients against ``jax.grad``, ``traverse``, a
scene of spheres alone, a forward-mode tangent, and one ``manifold``
backward with a sphere in the box; then JAX's own
``tests/test_quadric.py`` checks on the port.

Tolerances: images as ``assert_images_close`` (1e-4); gradients within
1e-4 of each one's largest entry (the PRB replay, as
``tests/test_torch_prb.py``), the manifold backward within 1e-3 (as
``tests/test_torch_epsm_backward.py``); the hit point and normal 1e-5;
the forward tangent within 2e-3 relative of the backward's directional
derivative (``tests/test_torch_forward.py``'s bar)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.integrators import epsm as EJ
from epsm_mitsuba3_tpu.models.records import Ray as RayJ
from scenes import cornell_box as cornell_box_jax

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.integrators import epsm as ET
from epsm_mitsuba3_torch.models.records import Ray
from epsm_mitsuba3_torch.scenes import cornell_box

from test_torch_render import assert_images_close, jax_arrays
from torch_threads import one_torch_thread  # noqa: F401

RES, SPP, DEPTH = 16, 4, 3
BALL = {"type": "sphere", "analytic": True, "radius": 0.35,
        "center": [0.2, 0.35, 0.2],
        "bsdf": {"type": "diffuse",
                 "reflectance": {"type": "rgb", "value": [0.2, 0.4, 0.8]}}}


def _boxes(res=RES, spp=SPP, depth=DEPTH, ball=BALL):
    """(JAX scene, port scene) of the Cornell box with ``ball``."""
    dj = cornell_box_jax(res=res, spp=spp, max_depth=depth)
    dt = cornell_box(res=res, spp=spp, max_depth=depth)
    dj["ball"] = dict(ball)
    dt["ball"] = dict(ball)
    return mi.load_dict(dj), mt.load_dict(dt, device="cpu")


@pytest.fixture(scope="module")
def boxes():
    return _boxes()


def test_load_dict_equals_jax(boxes):
    sj, st = boxes
    np.testing.assert_array_equal(st.sph_data.numpy(),
                                  np.asarray(sj.sph_data))
    np.testing.assert_array_equal(st.sph_shape.numpy(),
                                  np.asarray(sj.sph_shape))
    ref = jax_arrays(sj)
    for k in ("vertices", "faces", "face_shape", "shape_bsdf",
              "shape_emitter", "bsdfs.reflectance"):
        np.testing.assert_array_equal(getattr(st, k).numpy()
                                      if "." not in k else
                                      st.bsdfs["reflectance"].numpy(),
                                      ref[k], err_msg=k)
    assert st.static.shape_names == sj.static.shape_names
    # under a uniform scale the centre and radius move with to_world
    T = mt.ScalarTransform4f
    d = cornell_box(res=8, spp=1)
    d["ball"] = {**BALL, "to_world": T.translate([0.1, 0.2, 0.0]).scale(2.0)}
    sc = mt.load_dict(d, device="cpu")
    np.testing.assert_allclose(sc.sph_data[0].numpy(),
                               [0.5, 0.9, 0.4, 0.7], rtol=1e-6)


def test_loader_refusals():
    T = mt.ScalarTransform4f
    d = cornell_box(res=8, spp=1)
    d["ball"] = {**BALL, "to_world": T.scale([1.0, 2.0, 1.0])}
    with pytest.raises(ValueError, match="uniform-scale"):
        mt.load_dict(d, device="cpu")
    d["ball"] = {**BALL, "emitter": {"type": "area", "radiance": 1.0}}
    with pytest.raises(ValueError, match="emitter"):
        mt.load_dict(d, device="cpu")


def test_hit_record_and_occlusion_match_jax(boxes):
    """Seeded rays from the camera's side of the box: the merged hit
    (sphere lanes F + slot), the surface fields, ismesh 0 on the sphere,
    and ray_test."""
    sj, st = boxes
    r = np.random.default_rng(5)
    n = 4096
    o = np.tile([0.0, 1.0, 3.5], (n, 1)).astype(np.float32)
    tgt = r.uniform([-0.6, -0.2, -0.6], [0.9, 1.2, 0.9], (n, 3))
    dv = (tgt - o).astype(np.float32)
    dv /= np.linalg.norm(dv, axis=-1, keepdims=True)
    maxt = r.uniform(1.0, 6.0, n).astype(np.float32)
    rj = RayJ.make(jnp.asarray(o), jnp.asarray(dv))
    rt = Ray.make(torch.from_numpy(o), torch.from_numpy(dv))
    sij = sj.ray_intersect(rj)
    sit = st.ray_intersect(rt)
    nf = st.faces.shape[0]
    on_sph = sit.prim_index.numpy() >= nf
    assert on_sph.sum() > 200
    np.testing.assert_array_equal(sit.prim_index.numpy(),
                                  np.asarray(sij.prim_index))
    np.testing.assert_array_equal(sit.valid.numpy(), np.asarray(sij.valid))
    for f in ("p", "n", "sh_n", "uv", "wi"):
        np.testing.assert_allclose(getattr(sit, f).numpy(),
                                   np.asarray(getattr(sij, f)), atol=1e-5,
                                   err_msg=f)
    for f in ("shape_index", "bsdf_index", "emitter_index", "ismesh"):
        np.testing.assert_array_equal(getattr(sit, f).numpy(),
                                      np.asarray(getattr(sij, f)),
                                      err_msg=f)
    assert (sit.ismesh.numpy()[on_sph] == 0).all()
    occ_j = sj.ray_test(RayJ.make(jnp.asarray(o), jnp.asarray(dv),
                                  maxt=jnp.asarray(maxt)))
    occ_t = st.ray_test(Ray.make(torch.from_numpy(o), torch.from_numpy(dv),
                                 maxt=torch.from_numpy(maxt)))
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))


def test_render_matches_jax(boxes):
    sj, st = boxes
    ref = np.asarray(mi.render(sj, spp=SPP, seed=0))
    img = mt.render(st, spp=SPP, seed=0, device="cpu").numpy()
    plain = mt.render(mt.load_dict(cornell_box(res=RES, spp=SPP,
                                               max_depth=DEPTH),
                                   device="cpu"),
                      spp=SPP, seed=0, device="cpu").numpy()
    assert_images_close(img, ref)
    assert np.abs(img - plain).mean() > 1e-3       # the sphere is seen


def _prb_loss_j(sj, sph):
    return jnp.mean(mi.render(sj.replace(sph_data=sph), spp=SPP, seed=3,
                              integrator={"type": "prb", "max_depth": 2})
                    ** 2)


def test_center_and_radius_gradients_match_jax(boxes):
    sj, st = boxes
    gj = np.asarray(jax.grad(lambda s: _prb_loss_j(sj, s))(sj.sph_data))
    sph = st.sph_data.clone().requires_grad_(True)
    img = mt.render(st.with_leaves({"sph_data": sph}), spp=SPP, seed=3,
                    device="cpu", integrator={"type": "prb", "max_depth": 2})
    gt = torch.autograd.grad(torch.mean(img ** 2), sph)[0].numpy()
    scale = float(np.abs(gj).max())
    assert scale > 0 and np.isfinite(gt).all()
    assert (np.abs(gt) > 0).all()          # centre x, y, z and the radius
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-4 * scale)


def test_forward_tangent_matches_jax(boxes):
    """render_forward of a centre tangent: <dimg, W> against JAX's
    gradient of <img, W> along the same tangent."""
    sj, st = boxes
    w = np.random.default_rng(2).normal(size=(RES, RES, 3)).astype(
        np.float32)
    tan = np.zeros((1, 4), np.float32)
    tan[0, :3] = [0.6, -0.3, 0.8]
    integ = {"type": "prb", "max_depth": 2}

    def lin(s):
        return jnp.sum(mi.render(sj.replace(sph_data=s), spp=SPP, seed=3,
                                 integrator=integ) * w)

    ref = float(jnp.sum(jax.grad(lin)(sj.sph_data) * tan))
    dimg = mt.render_forward(st, {"sph_data": torch.from_numpy(tan)},
                             spp=SPP, seed=3, device="cpu", integrator=integ)
    got = float((dimg * torch.from_numpy(w)).sum())
    assert abs(ref) > 0
    assert abs(got - ref) <= 2e-3 * abs(ref), (got, ref)


def test_traverse_center_radius(boxes):
    _, st = boxes
    params = mt.traverse(st)
    assert "ball.center" in params and "ball.radius" in params
    assert "ball.vertex_positions" not in params.keys()
    np.testing.assert_array_equal(params["ball.center"].numpy(),
                                  np.float32([0.2, 0.35, 0.2]))
    img0 = mt.render(st, spp=SPP, seed=1, device="cpu")
    params["ball.center"] = torch.tensor([0.2, 0.35, -0.3])
    params["ball.radius"] = 0.2
    sc2 = params.update()
    np.testing.assert_allclose(sc2.sph_data[0].numpy(),
                               [0.2, 0.35, -0.3, 0.2], atol=1e-6)
    img1 = mt.render(sc2, spp=SPP, seed=1, device="cpu")
    assert not torch.allclose(img0, img1)


def _sphere_only(T, res=16):
    return {
        "type": "scene",
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": T.look_at(origin=[0, 0, 3], target=[0, 0, 0],
                                         up=[0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": res,
                            "height": res}},
        "light": {"type": "constant", "radiance": 1.0},
        "ball": {"type": "sphere", "radius": 1.0, "analytic": True},
    }


def test_sphere_only_scene_matches_jax():
    """No triangle: the triangle query misses without a kernel (or its
    plain version) running, and the image is JAX's."""
    sj = mi.load_dict(_sphere_only(mi.ScalarTransform4f))
    st = mt.load_dict(_sphere_only(mt.ScalarTransform4f), device="cpu")
    assert st.faces.shape[0] == 0
    ref = np.asarray(mi.render(sj, spp=SPP, seed=0))
    img = mt.render(st, spp=SPP, seed=0, device="cpu").numpy()
    assert np.isfinite(img).all() and img[8, 8].mean() != img[0, 0].mean()
    assert_images_close(img, ref)


def test_manifold_backward_matches_jax(boxes):
    """One manifold backward from a seeded 5-channel cotangent: the
    chains stop at the sphere's vertices (ismesh 0) in both packages."""
    sj, st = boxes
    depth = 3
    g = np.random.default_rng(13).normal(size=(RES, RES, 5)).astype(
        np.float32) * 0.05
    rj = jax.jit(EJ.render_backward, static_argnums=(3, 4, 5, 6, 7))(
        sj, jnp.asarray(g), jnp.uint32(3), depth, 5, False, -1, 2)
    got = ET.render_backward(st, ("vertices", "bsdfs.reflectance"),
                             torch.from_numpy(g), 3, depth, 5, False, -1, 2)
    for k, r in (("vertices", rj.vertices),
                 ("bsdfs.reflectance", rj.bsdfs["reflectance"])):
        r, gk = np.asarray(r), got[k].numpy()
        assert np.isfinite(gk).all() and np.isfinite(r).all(), k
        scale = float(np.abs(r).max())
        assert scale > 0, k
        np.testing.assert_allclose(gk, r, rtol=0, atol=1e-3 * scale,
                                   err_msg=k)


# -- JAX's tests/test_quadric.py checks, on the port --------------------------

def test_exact_normals_and_hit(boxes):
    _, st = boxes
    o = torch.tensor([[0.2, 1.5, 0.2]])
    d = torch.tensor([[0.0, -1.0, 0.0]])
    si = st.ray_intersect(Ray.make(o, d))
    assert bool(si.valid[0]) and float(si.ismesh[0]) == 0.0
    np.testing.assert_allclose(si.p[0].numpy(), [0.2, 0.7, 0.2], atol=1e-5)
    np.testing.assert_allclose(si.n[0].numpy(), [0.0, 1.0, 0.0], atol=1e-5)
    assert bool(st.ray_test(Ray.make(o, d, maxt=torch.tensor([2.0])))[0])


def test_render_parity_vs_tessellated():
    """The analytic sphere against one tessellated at subdiv 96, on the
    same sampler stream: only silhouettes and the normal interpolation
    differ (JAX's bar, 2e-3 mean)."""
    d = cornell_box(res=32, spp=8, max_depth=3)
    d["ball"] = dict(BALL)
    img_a = mt.render(mt.load_dict(d, device="cpu"), spp=8, device="cpu")
    d["ball"] = {k: v for k, v in BALL.items() if k != "analytic"}
    d["ball"]["subdiv"] = 96
    img_t = mt.render(mt.load_dict(d, device="cpu"), spp=8, device="cpu")
    assert float((img_a - img_t).abs().mean()) < 2e-3


def test_center_gradient_sign_vs_fd(boxes):
    _, st = boxes
    integ = {"type": "prb", "max_depth": 2}

    def loss(sph):
        return mt.render(st.with_leaves({"sph_data": sph}), spp=16, seed=3,
                         device="cpu", integrator=integ).mean()

    sph = st.sph_data.clone().requires_grad_(True)
    g = torch.autograd.grad(loss(sph), sph)[0]
    eps = 1e-2
    with torch.no_grad():
        for k in (0, 3):                   # the centre's x, the radius
            e = torch.zeros_like(sph)
            e[0, k] = eps
            fd = float(loss(st.sph_data + e) - loss(st.sph_data - e)) \
                / (2 * eps)
            assert np.isfinite(float(g[0, k]))
            assert np.sign(float(g[0, k])) == np.sign(fd), (k, g, fd)
