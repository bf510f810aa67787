"""The port's ray reparameterisation (``ad/reparam.py``) against the JAX
package's, function by function, on the JAX package's blocker scene
(``tests/test_reparam.py`` ``_make``) with rays and samples drawn from a
numpy seed; and JAX's own checks of it run on the port.

Tolerances, each with its reason:

- the vMF warp: 1e-5 absolute (float32 values in [0, 1]; XLA and
  PyTorch round the log one ulp apart, and ``r = sqrt(1 - z^2)``
  magnifies that by ~1 / r near the axis);
- the boundary test: 5e-5 absolute.  Its edge term is 3 x a barycentric
  of the hit, and the hit searches' barycentrics differ by up to 1.3e-5
  (XLA's FMAs, ``ROADMAP.md`` §3 "Rounding differences");
- ``_sample_warp_field`` and ``reparameterize_ray``'s primal: relative
  1e-4 of each output's largest entry.  The harmonic weights ``w ~
  B^-3`` and the divergence multiply a last-bit difference of B;
- the VJPs w.r.t. the vertices and the ray origins under random
  cotangents: relative L2 1e-4;
- the warped-direction channel of ``render``'s gradient: as in
  ``tests/test_torch_prb_reparam_channels.py``;
- ``test_vmf_sampling_density`` and ``test_warp_det_edge_flux_analytic``
  keep the JAX tests' own bars (2e-3 on the mean cosine, 25 % of the
  analytic flux).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from epsm_mitsuba3_tpu.ad import reparam as rp_j
from epsm_mitsuba3_tpu.core import math as m_j
from epsm_mitsuba3_tpu.models import samplers as smp_j
from epsm_mitsuba3_tpu.models.records import Ray as RayJ
from epsm_mitsuba3_tpu.models.records import RayFlags as FlagsJ
from epsm_mitsuba3_tpu.ops import intersect as I_j
from test_reparam import _make

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.ad import reparam as rp_t
from epsm_mitsuba3_torch.core import math as m_t
from epsm_mitsuba3_torch.core.transform import ScalarTransform4f as T
from epsm_mitsuba3_torch.models import samplers as smp_t
from epsm_mitsuba3_torch.models.records import Ray, RayFlags
from epsm_mitsuba3_torch.ops import intersect as I_t

from test_torch_prb_reparam import box_jax
from test_torch_prb_reparam_channels import assert_channel_matches_jax
from test_torch_render import port_scene_of
from torch_threads import one_torch_thread  # noqa: F401

N = 512
KAPPA = 1e3


@pytest.fixture(scope="module")
def scenes():
    sj = _make()
    return sj, port_scene_of(sj)


@pytest.fixture(scope="module")
def rays():
    """Rays from near the camera toward the blocker's edges, the floor
    and past them (seeded)."""
    rng = np.random.default_rng(11)
    o = (np.float32([0, 3, 3])
         + rng.uniform(-0.05, 0.05, (N, 3))).astype(np.float32)
    edge = rng.choice([-0.4, 0.4], N) + rng.normal(0, 0.02, N)
    along = rng.uniform(-0.5, 0.5, N)
    swap = rng.uniform(size=N) < 0.5
    tx = np.where(swap, edge, along)
    tz = np.where(swap, along, edge)
    ty = np.where(rng.uniform(size=N) < 0.8, 1.0, 0.0)
    target = np.stack([tx, ty, tz], -1).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _close(got, ref, rel, name):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale,
                               err_msg=name)


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _si_pair(scenes, o, d):
    sj, st = scenes
    rj = RayJ.make(jnp.asarray(o), jnp.asarray(d))
    si_j = I_j.compute_surface_interaction(
        sj, rj, sj.ray_intersect_preliminary(rj),
        FlagsJ.All | FlagsJ.FollowShape)
    rt = Ray.make(torch.from_numpy(o), torch.from_numpy(d))
    si_t = I_t.compute_surface_interaction(
        st, rt, st.ray_intersect_preliminary(rt),
        RayFlags.All | RayFlags.FollowShape)
    return si_j, si_t


@pytest.mark.parametrize("open_edges", [True, False],
                         ids=["face_open", "grazing only"])
def test_boundary_test_matches_jax(scenes, rays, open_edges):
    sj, st = scenes
    if not open_edges:
        sj = sj.replace(face_open=None)
        st = dataclasses.replace(st, face_open=None)
    o, d = rays
    si_j, si_t = _si_pair((sj, st), o, d)
    assert np.array_equal(np.asarray(si_j.valid), si_t.valid.numpy())
    b_j = np.asarray(rp_j.boundary_test(sj, si_j, jnp.asarray(d)))
    b_t = rp_t.boundary_test(st, si_t, torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(b_t, b_j, rtol=0, atol=5e-5)
    assert (b_t == 1.0).any()
    # near an open edge B falls toward 0; without the edges only the
    # grazing term of the scene's flat quads is left
    assert (b_t < 0.1).any() == open_edges


@pytest.mark.parametrize("kappa", [10.0, KAPPA, 1e5])
def test_von_mises_fisher_matches_jax(kappa):
    s = np.random.default_rng(3).random((4096, 2), np.float32)
    w_j = np.asarray(rp_j.square_to_von_mises_fisher(jnp.asarray(s), kappa))
    w_t = rp_t.square_to_von_mises_fisher(torch.from_numpy(s), kappa)
    np.testing.assert_allclose(w_t.numpy(), w_j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("flip", [False, True])
def test_sample_warp_field_matches_jax(scenes, rays, flip):
    sj, st = scenes
    o, d = rays
    s = np.random.default_rng(4).random((N, 2), np.float32)
    frame_j = m_j.coordinate_system(jnp.asarray(d))
    out_j = rp_j._sample_warp_field(
        sj, jnp.asarray(s), RayJ.make(jnp.asarray(o), jnp.asarray(d)),
        frame_j, KAPPA, 3.0, flip=flip)
    frame_t = m_t.coordinate_system(torch.from_numpy(d))
    out_t = rp_t._sample_warp_field(
        st, torch.from_numpy(s),
        Ray.make(torch.from_numpy(o), torch.from_numpy(d)), frame_t, KAPPA,
        3.0, flip=flip)
    for name, a, b in zip(("Z", "dZ", "V", "div_lhs"), out_t, out_j):
        _close(a.numpy(), b, 1e-4, name)


def _reparam_jax(sj, o, d, active, num_rays, antithetic, g_d, g_det):
    n = o.shape[0]

    def f(v, oo):
        _, dr, det = rp_j.reparameterize_ray(
            sj.replace(vertices=v), smp_j.seed(7, n),
            RayJ.make(oo, jnp.asarray(d)), jnp.asarray(active),
            num_rays=num_rays, kappa=KAPPA, antithetic=antithetic)
        return dr, det

    (dr, det), vjp = jax.vjp(f, sj.vertices, jnp.asarray(o))
    g_v, g_o = vjp((jnp.asarray(g_d), jnp.asarray(g_det)))
    return [np.asarray(x) for x in (dr, det, g_v, g_o)]


def _reparam_port(st, o, d, active, num_rays, antithetic, g_d, g_det):
    v = st.vertices.clone().requires_grad_(True)
    oo = torch.from_numpy(o).requires_grad_(True)
    _, dr, det = rp_t.reparameterize_ray(
        dataclasses.replace(st, vertices=v), smp_t.seed(7, o.shape[0]),
        Ray.make(oo, torch.from_numpy(d)), torch.from_numpy(active),
        num_rays=num_rays, kappa=KAPPA, antithetic=antithetic)
    g_v, g_o = torch.autograd.grad(
        (dr, det), (v, oo), (torch.from_numpy(g_d), torch.from_numpy(g_det)))
    return [x.detach().numpy() for x in (dr, det, g_v, g_o)]


@pytest.mark.parametrize("antithetic,num_rays", [(True, 4), (False, 3)])
def test_reparameterize_ray_primal_and_vjp_match_jax(scenes, rays,
                                                    antithetic, num_rays):
    """The primal is (d, 1) exactly where active; the VJP w.r.t. the
    vertices and the ray origins under seeded cotangents equals JAX's."""
    sj, st = scenes
    o, d = rays
    rng = np.random.default_rng(5)
    active = rng.uniform(size=N) < 0.9
    g_d = rng.normal(size=(N, 3)).astype(np.float32)
    g_det = rng.normal(size=N).astype(np.float32)
    dr_j, det_j, gv_j, go_j = _reparam_jax(sj, o, d, active, num_rays,
                                           antithetic, g_d, g_det)
    dr_t, det_t, gv_t, go_t = _reparam_port(st, o, d, active, num_rays,
                                            antithetic, g_d, g_det)
    np.testing.assert_array_equal(dr_t, d)
    np.testing.assert_array_equal(det_t, np.ones(N, np.float32))
    np.testing.assert_array_equal(dr_j, d)
    assert np.abs(gv_j).max() > 0 and np.abs(go_j).max() > 0
    assert _rel_l2(gv_t, gv_j) < 1e-4, _rel_l2(gv_t, gv_j)
    assert _rel_l2(go_t, go_j) < 1e-4, _rel_l2(go_t, go_j)
    # inactive lanes take no gradient
    assert np.abs(go_t[~active]).max() == 0


def test_odd_num_rays_refused_under_antithetic(scenes, rays):
    _, st = scenes
    o, d = rays
    ray = Ray.make(torch.from_numpy(o), torch.from_numpy(d))
    with pytest.raises(ValueError, match="even num_rays"):
        rp_t.reparameterize_ray(st, smp_t.seed(7, N), ray,
                                torch.ones(N, dtype=torch.bool), num_rays=3)
    with pytest.raises(ValueError, match="even num_rays"):
        mt.render(st, spp=1, device="cpu",
                  integrator={"type": "prb_reparam", "reparam_rays": 5})


def test_vmf_sampling_density():
    """JAX's ``test_vmf_sampling_density`` on the port: unit vectors whose
    mean z is the vMF's coth(kappa) - 1 / kappa ~ 1 - 1 / kappa."""
    s = torch.from_numpy(np.random.default_rng(0).random((100_000, 2),
                                                         np.float32))
    kappa = 100.0
    d = rp_t.square_to_von_mises_fisher(s, kappa).numpy()
    assert np.allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)
    assert abs(d[:, 2].mean() - (1.0 - 1.0 / kappa)) < 2e-3


def test_warp_det_edge_flux_analytic():
    """JAX's ``test_warp_det_edge_flux_analytic`` on the port: a square
    blocker at z = 1 translating in x; the divergence of the warp must
    give the analytic flux of its edge, -mean_y g(0.5, y) / 0.2, for
    I(dx) = mean over fixed rays of [visible * g]."""
    scene0 = mt.load_dict({
        "type": "scene",
        "sensor": {"type": "perspective", "fov": 90.0,
                   "to_world": T.look_at(origin=[0, 0, 0], target=[0, 0, 1],
                                         up=[0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": 4, "height": 4},
                   "sampler": {"type": "independent", "sample_count": 1}},
        "blocker": {"type": "rectangle",
                    "to_world": T.translate([0, 0, 1.0]).scale(0.5),
                    "bsdf": {"type": "diffuse"}},
    }, device="cpu")
    s, c = scene0.static.vertex_ranges[
        scene0.static.shape_names.index("blocker")]
    n = 60_000
    rng = np.random.default_rng(3)
    x = rng.uniform(0.4, 0.6, n).astype(np.float32)
    y = rng.uniform(-0.4, 0.4, n).astype(np.float32)
    target = torch.from_numpy(np.stack([x, y, np.ones(n, np.float32)], -1))
    o = torch.zeros((n, 3))
    d = target / torch.linalg.norm(target, dim=-1, keepdim=True)
    g = torch.from_numpy(np.exp(-(x ** 2 + y ** 2)))
    yy = np.linspace(-0.4, 0.4, 2001)
    ana = -float(np.mean(np.exp(-(0.25 + yy ** 2)))) / 0.2

    dx = torch.zeros((), requires_grad=True)
    mask = torch.zeros_like(scene0.vertices)
    mask[s:s + c, 0] = 1.0
    sc = scene0.with_leaves({"vertices": scene0.vertices + dx * mask})
    occ = sc.ray_test(Ray.make(o, d))
    _, _, det = rp_t.reparameterize_ray(sc, smp_t.seed(7, n), Ray.make(o, d),
                                        torch.ones(n, dtype=torch.bool),
                                        num_rays=16, kappa=1e5)
    (grad,) = torch.autograd.grad(torch.mean(torch.where(occ, 0.0, g) * det),
                                  dx)
    assert abs(float(grad) - ana) < 0.25 * abs(ana), (float(grad), ana)


def test_warped_direction_channel_matches_jax():
    """``render``'s ``prb_reparam`` gradient with every divergence left
    out (``_no_cam``, ``_no_em_det``, ``_no_main_det``): the warped
    incident direction alone, against JAX's."""
    sj = box_jax()
    assert_channel_matches_jax(sj, port_scene_of(sj), {
        "_no_cam": 1, "_no_em_det": 1, "_no_main_det": 1})
