"""The port's PRB gradients against ``jax.grad`` through the JAX package's
``render`` (its default two-step replay), against finite differences,
and on the BVH path through ``Scene.set_vertices``.

Tolerances, each with its reason:

- against JAX: each gradient within 1e-4 of its largest entry.  Both
  replay the same paths from the same sampler streams; the port's fused
  replay takes the remaining radiance from the attached NEE term, whose
  direction is normalised rather than divided by its length (the
  reference's fused form does the same), and XLA and PyTorch round sums
  and gathers in other orders;
- finite differences: 5 % relative, the reference's bar
  (``tests/test_ad.py``);
- images: ``assert_images_close`` of ``test_torch_render.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from scenes import cornell_box as cornell_box_jax
from scenes import cornell_box_mesh as cornell_box_mesh_jax

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.ad import prb as prb_t
from epsm_mitsuba3_torch.integrators import common as common_t
from epsm_mitsuba3_torch.integrators import path as path_t
from epsm_mitsuba3_torch.models import samplers as smp_t
from epsm_mitsuba3_torch.ops import accel
from epsm_mitsuba3_torch.scenes import cornell_box

from test_torch_render import assert_images_close, port_scene_of
from torch_threads import one_torch_thread  # noqa: F401

RES, SPP, DEPTH = 16, 4, 4
WALLS = ("floor", "ceiling", "back", "left", "right")


def _weights(seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (RES, RES, 3)).astype(np.float32)


def _assert_grad_close(got, ref, name):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = float(np.abs(ref).max())
    assert scale > 0, name
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale,
                               err_msg=name)


def _port_grads(st, names, W, seed=0, spp=SPP):
    lv = {k: v.clone().requires_grad_(True)
          for k, v in st.leaves().items() if k in names}
    img = mt.render(st.with_leaves(lv), spp=spp, seed=seed, device="cpu")
    g = torch.autograd.grad((img * torch.from_numpy(W)).sum(),
                            list(lv.values()))
    return dict(zip(lv, (x.numpy() for x in g)))


def test_box_gradients_match_jax():
    """Reflectance, radiance and vertex gradients of the Cornell box with
    face normals on the walls (so the shading frame depends on the
    vertices)."""
    d = cornell_box_jax(res=RES, spp=SPP, max_depth=DEPTH)
    for k in WALLS:
        d[k]["face_normals"] = True
    sj = mi.load_dict(d)
    W = _weights()
    g = jax.grad(lambda s: jnp.sum(mi.render(s, spp=SPP, seed=0) * W),
                 allow_int=True)(sj)
    got = _port_grads(port_scene_of(sj), ("vertices", "bsdfs.reflectance",
                                          "emitters.radiance"), W)
    _assert_grad_close(got["vertices"], g.vertices, "vertices")
    _assert_grad_close(got["bsdfs.reflectance"], g.bsdfs["reflectance"],
                       "reflectance")
    _assert_grad_close(got["emitters.radiance"], g.emitters["radiance"],
                       "radiance")


@pytest.mark.parametrize("leaf,row,eps", [("bsdfs.reflectance", None, 1e-2),
                                          ("emitters.radiance", 0, 0.1)])
def test_gradient_matches_finite_differences(leaf, row, eps):
    """In the style of ``tests/test_ad.py``: d sum(image) / d the red
    channel of the left wall's reflectance, or of the light's radiance,
    against a central difference at the same seed."""
    st = mt.load_dict(cornell_box(res=16, spp=16, max_depth=3),
                      device="cpu")
    if row is None:          # the left wall's BSDF slot
        left = 3
        row = int(st.shape_bsdf[left])
    ones = np.ones((16, 16, 3), np.float32)
    ad = _port_grads(st, (leaf,), ones, seed=3, spp=16)[leaf][row, 0]
    base = st.leaves()[leaf]

    def loss(delta):
        x = base.clone()
        x[row, 0] += delta
        img = mt.render(st.with_leaves({leaf: x}), spp=16, seed=3,
                        device="cpu")
        return float(img.sum())

    fd = (loss(eps) - loss(-eps)) / (2 * eps)
    assert abs(ad - fd) / max(abs(fd), 1e-6) < 0.05, (ad, fd)


def _blob_normals(d):
    d["blob"]["normals"] = d["blob"]["vertices"] - np.float32([0, 0.7, 0])
    return d


@pytest.fixture(scope="module")
def mesh_scenes():
    sj = mi.load_dict(_blob_normals(cornell_box_mesh_jax(
        res=RES, spp=SPP, max_depth=DEPTH, subdiv=46)))
    assert sj.bvh is not None
    return sj, port_scene_of(sj)


def _blob_mask(face_shape, faces, n_vertices):
    blob = face_shape == face_shape.max()
    mask = np.zeros(n_vertices, bool)
    mask[np.asarray(faces)[np.asarray(blob)].ravel()] = True
    return mask


def test_mesh_gradients_match_jax_through_set_vertices(mesh_scenes):
    """The BVH path: a translation of the sphere's vertices applied
    through ``set_vertices`` (refit, and in the port re-pack), and the
    gradient of a weighted image w.r.t. it, the reflectance and the
    radiance.  The sphere carries vertex normals, so its shading depends
    on the hit's barycentrics and the translation has a gradient."""
    sj, st = mesh_scenes
    W = _weights(1)
    mask = _blob_mask(st.face_shape.numpy(), st.faces.numpy(),
                      st.vertices.shape[0])
    t0 = np.asarray([0.05, 0.02, -0.03], np.float32)

    def loss_j(t, refl, rad):
        s = sj.set_vertices(sj.vertices + jnp.where(mask[:, None], t, 0.0))
        s = s.replace(bsdfs={**s.bsdfs, "reflectance": refl},
                      emitters={**s.emitters, "radiance": rad})
        return jnp.sum(mi.render(s, spp=SPP, seed=0) * W)

    g_j = jax.grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(t0), sj.bsdfs["reflectance"], sj.emitters["radiance"])

    t = torch.tensor(t0, requires_grad=True)
    refl = st.bsdfs["reflectance"].clone().requires_grad_(True)
    rad = st.emitters["radiance"].clone().requires_grad_(True)
    s = st.set_vertices(st.vertices + torch.where(
        torch.from_numpy(mask)[:, None], t, 0.0))
    s = s.with_leaves({"bsdfs.reflectance": refl, "emitters.radiance": rad})
    img = mt.render(s, spp=SPP, seed=0, device="cpu")
    g_t = torch.autograd.grad((img * torch.from_numpy(W)).sum(),
                              [t, refl, rad])
    for name, a, b in zip(("translation", "reflectance", "radiance"), g_t,
                          g_j):
        _assert_grad_close(a.numpy(), b, name)
    assert float(g_t[0].abs().max()) > 0


def test_set_vertices_repacks_the_bvh(mesh_scenes):
    """A moved sphere renders as the JAX package renders it; without the
    re-pack the kernels' records would still bound the old geometry."""
    sj, st = mesh_scenes
    mask = _blob_mask(st.face_shape.numpy(), st.faces.numpy(),
                      st.vertices.shape[0])
    shift = np.where(mask[:, None], np.float32([0.2, -0.1, 0.15]), 0.0)
    moved = st.set_vertices(st.vertices + torch.from_numpy(shift).float())
    assert not torch.equal(moved.bvh_nodes, st.bvh_nodes)
    assert not torch.equal(moved.bvh_tris, st.bvh_tris)
    ref = np.asarray(mi.render(sj.set_vertices(
        sj.vertices + jnp.asarray(shift, jnp.float32)), spp=SPP, seed=0))
    img = mt.render(moved, spp=SPP, seed=0, device="cpu").numpy()
    assert_images_close(img, ref)
    stale = mt.render(st.with_leaves({"vertices": moved.vertices}),
                      spp=SPP, seed=0, device="cpu").numpy()
    assert np.abs(stale - ref).mean() > 1e-3


def test_replay_traverses_nothing(monkeypatch):
    """The recording forward queries the scene once a bounce for hits and
    once for shadows; the replay reads the recorded trace."""
    calls = {"intersect": 0, "test": 0}
    hit, test = accel.ray_intersect, accel.ray_test

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(accel, "ray_intersect", count("intersect", hit))
    monkeypatch.setattr(accel, "ray_test", count("test", test))
    st = mt.load_dict(cornell_box(res=8, spp=2, max_depth=DEPTH),
                      device="cpu")
    refl = st.bsdfs["reflectance"].clone().requires_grad_(True)
    img = mt.render(st.with_leaves({"bsdfs.reflectance": refl}), spp=2,
                    device="cpu")
    assert calls == {"intersect": DEPTH, "test": DEPTH}
    (g,) = torch.autograd.grad(img.sum(), refl)
    assert calls == {"intersect": DEPTH, "test": DEPTH}
    assert float(g.abs().sum()) > 0


def test_cached_bounce_replays_the_recorded_pass(monkeypatch):
    """The recorded trace holds each bounce's record, and ``hit_stage``
    fed it (as the replay feeds it) gives the primal bounce's interaction,
    emission and masks bit for bit, without a ray query."""
    st = mt.load_dict(cornell_box(res=8, spp=2, max_depth=DEPTH),
                      device="cpu")
    sampler = smp_t.seed(4, 8 * 8 * 2, device="cpu")
    sampler, ray, _, _ = common_t.sample_rays(st.sensors[0], sampler, 2)
    L, valid, trace = path_t.sample_primal_recorded(st, sampler, ray, DEPTH)
    assert trace["occl"].shape == (DEPTH, 128)
    assert trace["pi"].prim_uv.shape == (DEPTH, 128, 2)
    L_p, valid_p = path_t.sample_primal(st, sampler, ray, DEPTH)
    assert torch.equal(L, L_p) and torch.equal(valid, valid_p)

    # the primal's states and hit stages, bounce by bounce
    states, stages = [path_t.init_state(sampler, ray, 128)], []
    for i in range(DEPTH):
        stages.append(path_t.hit_stage(st, states[-1], DEPTH))
        states.append(path_t.bounce(st, states[-1], DEPTH, 5)[0])
    assert torch.equal(states[-1].L, L)

    def no_query(*a, **kw):
        raise AssertionError("the replay traversed the scene")

    monkeypatch.setattr(accel, "ray_intersect", no_query)
    monkeypatch.setattr(accel, "ray_test", no_query)
    for i in range(DEPTH):
        pi, si, le, act_next, act_em = path_t.hit_stage(
            st, states[i], DEPTH, cached=path_t.trace_at(trace, i))
        pi_p, si_p, le_p, act_next_p, act_em_p = stages[i]
        assert torch.equal(pi.prim_index, pi_p.prim_index)
        assert torch.equal(si.p, si_p.p) and torch.equal(si.n, si_p.n)
        assert torch.equal(le, le_p)
        assert torch.equal(act_next, act_next_p)
        assert torch.equal(act_em, act_em_p)


def test_leaves_are_leaf_tensors():
    """scene_from_arrays gives leaf tensors, each of which can be made to
    require grad; with_leaves puts them back by name.  Every float column
    of the BSDF and emitter tables is a leaf, and the vertex colours (a
    scene with a texture adds its tensors,
    ``tests/test_torch_prb_emitters.py``)."""
    st = mt.load_dict(cornell_box(res=8, spp=1), device="cpu")
    leaves = st.leaves()
    assert set(leaves) == {"vertices", "normals", "uvs", "vertex_colors",
                           "bsdfs.reflectance",
                           "bsdfs.specular_reflectance",
                           "bsdfs.specular_transmittance", "bsdfs.alpha",
                           "bsdfs.eta_c", "bsdfs.k_c", "bsdfs.eta",
                           "bsdfs.diffuse_reflectance", "bsdfs.metallic",
                           "bsdfs.spec_tint", "bsdfs.sheen",
                           "bsdfs.sheen_tint", "bsdfs.clearcoat",
                           "bsdfs.clearcoat_gloss", "bsdfs.specular",
                           "bsdfs.spec_trans", "bsdfs.diff_trans",
                           "bsdfs.flatness", "bsdfs.blend_weight",
                           "emitters.radiance", "emitters.intensity",
                           "emitters.irradiance", "emitters.position",
                           "emitters.direction", "emitters.cutoff_cos",
                           "emitters.beam_cos", "emitters.frame_x",
                           "emitters.frame_y", "emitters.tan_fov",
                           "sensors.0.to_world"}
    for k, v in leaves.items():
        assert v.is_leaf and not v.requires_grad, k
    new = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    back = st.with_leaves(new).leaves()
    assert all(back[k] is new[k] for k in new)


@pytest.mark.parametrize("kw", [{"execution": "wavefront"},
                                {"compact_chunks": 8}])
def test_render_prb_options_not_ported_raise(kw):
    st = mt.load_dict(cornell_box(res=8, spp=1), device="cpu")
    with pytest.raises(NotImplementedError):
        prb_t.render_prb(st, spp=1, **kw)
