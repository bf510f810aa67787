"""What the reparameterised integrators read beside ``ad/reparam.py``,
against the JAX package: ``Scene.face_open`` (the open-edge mask of the
boundary test) from ``load_dict`` and ``load_file``, kept through every
vertex edit; ``point_to_film`` and ``project_to_film`` with their
gradients; and ``splat``'s ``extra_weight``.

Tolerances, each with its reason:

- ``face_open``: equal (integer topology from the same arrays);
- film positions: 2e-4 pixels absolute, their VJPs 1e-5 of the largest
  entry (a division by the camera-space z; XLA's FMAs);
- ``splat``: 1e-6 of the largest entry (float32 sums of the same
  weights in another order), its VJP alike.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.core import xmlparse as XJ
from epsm_mitsuba3_tpu.models import films as films_j
from epsm_mitsuba3_tpu.models import sensors as sensors_j
from scenes import cornell_box as cornell_box_jax
from scenes import cornell_box_mesh as cornell_box_mesh_jax
from test_reparam import _make

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.core import xmlparse as XT
from epsm_mitsuba3_torch.models import films as films_t
from epsm_mitsuba3_torch.models import sensors as sensors_t
from epsm_mitsuba3_torch.models.scene import _open_edge_mask
from epsm_mitsuba3_torch.scenes import cornell_box
from epsm_mitsuba3_torch.utils.xmlwrite import dict_to_xml

from test_torch_render import SENSOR_STATIC, port_scene_of
from torch_threads import one_torch_thread  # noqa: F401

#: a unit cube with a vertex per face corner (split normals: every
#: position four times) and an open quad beside it
CUBE_AND_QUAD_OBJ = "\n".join(
    [f"v {x} {y} {z}" for face in (
        [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0)],
        [(0, 0, 1), (0, 1, 1), (1, 1, 1), (1, 0, 1)],
        [(0, 0, 0), (0, 1, 0), (0, 1, 1), (0, 0, 1)],
        [(1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0)],
        [(0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 0, 0)],
        [(0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1)],
        [(2, 0, 0), (3, 0, 0), (3, 1, 0), (2, 1, 0)]) for x, y, z in face]
    + [f"f {4 * k + 1} {4 * k + 2} {4 * k + 3} {4 * k + 4}"
       for k in range(7)]) + "\n"


def _scene_dicts_jax():
    d_box = cornell_box_jax(res=8, spp=1)
    d_mesh = cornell_box_mesh_jax(res=8, spp=1, subdiv=46)
    return {"blocker": _make(), "box": mi.load_dict(d_box),
            "mesh (BVH)": mi.load_dict(d_mesh)}


@pytest.fixture(scope="module")
def jax_scenes():
    return _scene_dicts_jax()


@pytest.mark.parametrize("name", ["blocker", "box", "mesh (BVH)"])
def test_face_open_of_load_dict_equals_jax(jax_scenes, name):
    sj = jax_scenes[name]
    st = port_scene_of(sj)          # the port's own mask from the arrays
    assert st.face_open.dtype == torch.int8
    assert np.array_equal(st.face_open.numpy(), np.asarray(sj.face_open))
    if name == "box":
        d = cornell_box(res=8, spp=1)
        assert torch.equal(mt.load_dict(d, device="cpu").face_open,
                           st.face_open)


def test_face_open_of_load_file_equals_jax(tmp_path):
    """An XML scene with an OBJ of split-normal cube faces (shared edges
    keyed by position: closed) and an open quad."""
    (tmp_path / "m.obj").write_text(CUBE_AND_QUAD_OBJ)
    d = cornell_box(res=8, spp=1)
    d["ball"] = {"type": "obj", "filename": "m.obj",
                 "to_world": mt.ScalarTransform4f.translate([0.2, 0.5, 0.1])
                 .scale(0.2),
                 "bsdf": {"type": "diffuse"}}
    path = str(tmp_path / "scene.xml")
    dict_to_xml(d, path)
    st, sj = XT.load_file(path, device="cpu"), XJ.load_file(path)
    fo = st.face_open.numpy()
    assert np.array_equal(fo, np.asarray(sj.face_open))
    s, c = st.static.vertex_ranges[-1]          # the OBJ, the last shape
    ball = np.isin(st.faces.numpy(), np.arange(s, s + c)).all(1)
    assert fo[ball].sum() == 4          # the quad's border alone
    assert np.array_equal(
        _open_edge_mask(st.vertices.numpy(), st.faces.numpy()), fo)


def test_face_open_kept_by_vertex_edits(jax_scenes):
    """The topology is fixed: ``set_vertices`` (a BVH refit too),
    ``with_leaves`` and ``traverse(...).update()`` keep the mask of the
    loaded geometry."""
    for name in ("box", "mesh (BVH)"):
        st = port_scene_of(jax_scenes[name])
        moved = st.vertices * 1.5 + 0.25
        assert st.set_vertices(moved).face_open is st.face_open
        assert st.with_leaves({"vertices": moved}).face_open is st.face_open
        p = mt.traverse(st)
        key = f"{st.static.shape_names[0]}.vertex_positions"
        p[key] = p[key] * 2.0
        assert p.update().face_open is st.face_open


def _sensor_pair(kind):
    d = cornell_box_jax(res=12, spp=1)
    d["sensor"]["film"]["height"] = 8
    if kind != "perspective":
        d["sensor"]["type"] = kind
    if kind == "thinlens":
        d["sensor"].update(aperture_radius=0.05, focus_distance=3.9)
    sj = mi.load_dict(d)
    s = sj.sensors[0]
    st = sensors_t.Sensor(to_world=torch.from_numpy(np.asarray(s.to_world)),
                          **{f: getattr(s, f) for f in SENSOR_STATIC
                             if f != "sub_fov_x"})
    return s, st


def _film_points(n=256):
    rng = np.random.default_rng(9)
    p = np.stack([rng.uniform(-1, 1, n), rng.uniform(0, 2, n),
                  rng.uniform(-1, 1, n)], -1).astype(np.float32)
    return p


@pytest.mark.parametrize("kind", ["perspective", "thinlens"])
@pytest.mark.parametrize("fn", ["point_to_film", "project_to_film"])
def test_film_projection_and_vjp_match_jax(kind, fn):
    """Film positions of world points (or directions) and the VJP
    w.r.t. them and ``to_world`` under a seeded cotangent."""
    s_j, s_t = _sensor_pair(kind)
    x = _film_points()
    if fn == "project_to_film":
        x = x - np.asarray(s_j.to_world)[:3, 3]
    g = np.random.default_rng(10).normal(size=(x.shape[0], 2)).astype(
        np.float32)

    def f_j(xx, tw):
        return getattr(sensors_j, fn)(s_j.replace(to_world=tw), xx)

    pos_j, vjp = jax.vjp(f_j, jnp.asarray(x), s_j.to_world)
    gx_j, gw_j = vjp(jnp.asarray(g))
    xx = torch.from_numpy(x).requires_grad_(True)
    tw = s_t.to_world.clone().requires_grad_(True)
    pos_t = getattr(sensors_t, fn)(replace(s_t, to_world=tw), xx)
    gx_t, gw_t = torch.autograd.grad(pos_t, (xx, tw), torch.from_numpy(g))
    np.testing.assert_allclose(pos_t.detach().numpy(), np.asarray(pos_j),
                               rtol=0, atol=2e-4)
    for a, b, name in ((gx_t, gx_j, "point"), (gw_t, gw_j, "to_world")):
        b = np.asarray(b)
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max(), err_msg=name)


def test_film_projection_round_trips_camera_rays():
    """``point_to_film`` of a camera ray's ``o + d`` is the film position
    the ray was sampled at, in pixels."""
    _, s_t = _sensor_pair("perspective")
    rng = np.random.default_rng(12)
    pos01 = torch.from_numpy(rng.uniform(0.05, 0.95, (64, 2)).astype(
        np.float32))
    ray, _ = sensors_t.sample_ray_differential(s_t, pos01)
    pos = sensors_t.point_to_film(s_t, ray.o + ray.d)
    want = pos01 * torch.tensor([float(s_t.width), float(s_t.height)])
    np.testing.assert_allclose(pos.numpy(), want.numpy(), rtol=0, atol=2e-4)


@pytest.mark.parametrize("kind", ["orthographic", "radiancemeter"])
def test_film_projection_none_for_other_kinds(kind):
    s_j, s_t = _sensor_pair(kind)
    x = torch.from_numpy(_film_points(4))
    assert sensors_j.point_to_film(s_j, jnp.asarray(x.numpy())) is None
    assert sensors_t.point_to_film(s_t, x) is None
    assert sensors_t.project_to_film(s_t, x) is None


@pytest.mark.parametrize("rfilter", ["gaussian", "box", "tent"])
def test_splat_extra_weight_matches_jax(rfilter):
    """``splat(..., extra_weight=w)`` and its VJP w.r.t. the positions,
    the values and the weights against JAX's; without the weight it is
    the plain splat bit for bit."""
    rng = np.random.default_rng(13)
    n, W, H = 300, 9, 7
    pos = np.stack([rng.uniform(-1, W + 1, n), rng.uniform(-1, H + 1, n)],
                   -1).astype(np.float32)
    val = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    ew = rng.uniform(0.5, 1.5, n).astype(np.float32)
    g_data = rng.normal(size=(H, W, 3)).astype(np.float32)
    g_w = rng.normal(size=(H, W)).astype(np.float32)

    def f_j(p, v, e):
        return films_j.splat(p, v, W, H, rfilter, extra_weight=e)

    (data_j, w_j), vjp = jax.vjp(f_j, jnp.asarray(pos), jnp.asarray(val),
                                 jnp.asarray(ew))
    grads_j = vjp((jnp.asarray(g_data), jnp.asarray(g_w)))
    p, v, e = (torch.from_numpy(x).requires_grad_(True)
               for x in (pos, val, ew))
    data_t, w_t = films_t.splat(p, v, W, H, rfilter, extra_weight=e)
    grads_t = torch.autograd.grad((data_t, w_t), (p, v, e),
                                  (torch.from_numpy(g_data),
                                   torch.from_numpy(g_w)),
                                  materialize_grads=True)
    for a, b, name in ((data_t, data_j, "data"), (w_t, w_j, "weight"),
                       *zip(grads_t, grads_j, ("d pos", "d value",
                                                "d extra_weight"))):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0,
                                   atol=1e-6 * max(np.abs(b).max(), 1e-30),
                                   err_msg=name)
    plain = films_t.splat(torch.from_numpy(pos), torch.from_numpy(val), W, H,
                          rfilter)
    ones = films_t.splat(torch.from_numpy(pos), torch.from_numpy(val), W, H,
                         rfilter, extra_weight=torch.ones(n))
    assert all(torch.equal(a, b) for a, b in zip(plain, ones))
