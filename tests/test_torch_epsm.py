"""The port's EPSM layer (``integrators/epsm.py``) against the JAX
package's on the same inputs: the logged paths of ``cornell_box(16, 4,
4)`` and of ``mirror_box`` (the same box with two conductor walls, one a
mesh with bent vertex normals, so that specular chains, the caustic
substitution and the normal gradients have work), the residual
Jacobians, ``calc_grad`` in its plain and caustic modes and the gradient
injection, each fed JAX's own logs so that every stage is held on its
own.

Tolerances, each with its reason:

- ``PathLog``: integer and boolean fields equal and float fields within
  1e-4 (+ 2e-5 relative), but for two kinds of lanes, where the NEE
  fields are not compared: NEE from a hit on the emitter itself (its
  direction lies in the emitter's plane, so the last bit of the hit's
  height decides the sign of the origin's offset and whether the pdf is
  0), and, for the NEE ray's hit barycentrics, a NEE ray that grazes the
  face it hits (|cos| < 0.05, as ``test_torch_intersect``'s
  ``_grazing``).  The same arithmetic in float32, where XLA contracts some
  multiply-adds into FMAs (``ROADMAP.md`` §3): barycentrics of a face hit
  from afar move by up to ~5e-5;
- the Jacobians, on the lanes alive at their bounce (calc_grad masks the
  others): finite in both alike, and within 1e-4 of each block's largest
  entry (chains of float32 derivatives in another order);
- ``calc_grad`` and the injection: within 1e-3 of each output's largest
  entry (the block inverses of up to 8 x 8 systems magnify rounding by
  their condition number; the injection sums hundreds of lanes into each
  vertex in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.integrators import common as CJ
from epsm_mitsuba3_tpu.integrators import epsm as EJ
from epsm_mitsuba3_tpu.models import bsdf as BJ
from epsm_mitsuba3_tpu.models import samplers as SJ
from scenes import cornell_box as cornell_box_jax

from epsm_mitsuba3_torch.integrators import common as CT
from epsm_mitsuba3_torch.integrators import epsm as ET
from epsm_mitsuba3_torch.models import bsdf as BT
from epsm_mitsuba3_torch.models import samplers as ST

from test_torch_render import port_scene_of
from torch_threads import one_torch_thread  # noqa: F401

RES, SPP, DEPTH = 16, 4, 4


def mirror_box(res=RES, spp=SPP, max_depth=DEPTH):
    """``cornell_box`` with a conductor left wall and a conductor back
    wall that is a 4 x 4-quad mesh with bent vertex normals."""
    d = cornell_box_jax(res=res, spp=spp, max_depth=max_depth)
    d["left"]["bsdf"] = {"type": "conductor"}
    xs, ys = np.meshgrid(np.linspace(-1, 1, 5), np.linspace(0, 2, 5))
    v = np.stack([xs, ys, np.full_like(xs, -1.0)], -1).reshape(-1, 3)
    nrm = np.stack([0.2 * np.sin(3 * v[:, 0]), 0.2 * np.cos(2 * v[:, 1]),
                    np.ones(len(v))], -1)
    f = [[5 * i + j, 5 * i + j + 1, 5 * i + j + 6] for i in range(4)
         for j in range(4)]
    f += [[5 * i + j, 5 * i + j + 6, 5 * i + j + 5] for i in range(4)
          for j in range(4)]
    d["back"] = {"type": "mesh", "vertices": v.astype(np.float32),
                 "faces": np.asarray(f, np.int32),
                 "normals": nrm.astype(np.float32),
                 "bsdf": {"type": "conductor"}}
    return d


INT_FIELDS = ("active", "bsdf_flags", "bsdf_index", "active_em",
              "prim_index", "em_prim", "em_hit_valid")


NEE_FIELDS = ("active_em", "lr_dir", "em_prim", "em_b0", "em_b1",
              "em_hit_valid", "em_dist_ratio")


def _on_emitter(st, logs_j):
    """(K, N): the bounce's hit lies on an emissive shape."""
    shape = st.face_shape.numpy()[np.asarray(logs_j.prim_index)]
    return np.asarray(logs_j.active) & (st.shape_emitter.numpy()[shape]
                                        >= 0)


def _grazing_nee(st, logs_j):
    """(K, N): the NEE direction's ray meets its hit face at |cos| < 0.05."""
    v, f = st.vertices.numpy(), st.faces.numpy()
    tri = v[f[np.asarray(logs_j.em_prim)]]                # (K, N, 3, 3)
    ng = np.cross(tri[..., 1, :] - tri[..., 0, :], tri[..., 2, :]
                  - tri[..., 0, :])
    ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
    d = np.asarray(logs_j.light) - np.asarray(logs_j.p)
    d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-20)
    return np.abs(np.sum(d * ng, -1)) < 0.05


def _t(x):
    return torch.from_numpy(np.array(x))


def _logs_t(logs_j):
    """JAX's PathLog as the port's, field by field."""
    return ET.PathLog(*(_t(np.asarray(getattr(logs_j, f)).astype(
        np.int32) if f == "bsdf_flags" else getattr(logs_j, f))
        for f in ET.PathLog._fields))


def _close_to_max(got, ref, frac, name=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    assert np.isfinite(got).all() and np.isfinite(ref).all(), name
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=frac * max(np.abs(ref).max(), 1e-30),
                               err_msg=name)


def _logged_case(d):
    sj = mi.load_dict(d)
    st = port_scene_of(sj)
    n = RES * RES * SPP
    smp_j, ray_j, _, _ = CJ.sample_rays(sj.sensors[0], SJ.seed(0, n), SPP)
    smp_t, ray_t, _, _ = CT.sample_rays(st.sensors[0],
                                        ST.seed(0, n, device="cpu"), SPP)
    logged = jax.jit(EJ.sample_path_logged, static_argnums=(3, 4))
    L_j, valid_j, logs_j = logged(sj, smp_j, ray_j, DEPTH, 5)
    return dict(sj=sj, st=st, ray_j=ray_j, smp_t=smp_t, ray_t=ray_t,
                L_j=L_j, valid_j=valid_j, logs_j=logs_j,
                logs_t=_logs_t(logs_j))


@pytest.fixture(scope="module")
def plain_box():
    return _logged_case(cornell_box_jax(res=RES, spp=SPP, max_depth=DEPTH))


@pytest.fixture(scope="module")
def box():
    return _logged_case(mirror_box())


@pytest.fixture(scope="module")
def grads_in(box):
    """Seeded dL/d(b0, b1) and dL/dp at the first hit."""
    n = RES * RES * SPP
    r = np.random.default_rng(11)
    dl = np.zeros((n, 2 * DEPTH), np.float32)
    dl[:, :2] = r.normal(size=(n, 2)) * 0.05
    dp = (r.normal(size=(n, 3)) * 0.05).astype(np.float32)
    return dl, dp


@pytest.fixture(scope="module")
def calc_grad_j(box, grads_in):
    dl, dp = grads_in
    f = jax.jit(EJ.calc_grad, static_argnums=(4,))
    return {c: f(box["logs_j"], jnp.asarray(dl), jnp.asarray(dp),
                 box["ray_j"].o, c) for c in (False, True)}


@pytest.mark.parametrize("case", ["plain_box", "box"])
def test_path_log_matches_jax(case, request):
    box = request.getfixturevalue(case)
    L, valid, logs = ET.sample_path_logged(box["st"], box["smp_t"],
                                           box["ray_t"], DEPTH, 5)
    n = RES * RES * SPP
    assert logs.b0.shape == (DEPTH, n)
    lj = box["logs_j"]
    # NEE from a hit on the emitter itself samples a point of the same
    # plane: a degenerate direction whose offset origin flips with the last
    # bit of the hit; and a NEE ray that grazes the face it hits
    skip = {f: _on_emitter(box["st"], lj) for f in NEE_FIELDS}
    grazing = _grazing_nee(box["st"], lj)
    for f in ("em_b0", "em_b1", "em_dist_ratio"):
        skip[f] = skip[f] | grazing
    for f in ET.PathLog._fields:
        got, ref = getattr(logs, f).numpy(), np.asarray(getattr(lj, f))
        sel = ~skip.get(f, np.zeros(ref.shape[:2], bool))
        if f in INT_FIELDS:
            np.testing.assert_array_equal(got[sel], ref.astype(got.dtype)[sel],
                                          err_msg=f)
        else:
            np.testing.assert_allclose(got[sel], ref[sel], rtol=2e-5,
                                       atol=1e-4, err_msg=f)
    np.testing.assert_allclose(L.numpy(), np.asarray(box["L_j"]), rtol=2e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(box["valid_j"]))
    assert logs.active.any(1).all()          # every bounce has live lanes


@pytest.mark.parametrize("use_light,detach_frame,position_row", [
    (True, False, False),    # the light rows
    (True, True, False),     # the light rows, caustic (frame detached)
    (False, False, False),   # the BSDF rows
    (True, True, True),      # the caustic position rows, light side
    (False, False, True),    # the caustic position rows, BSDF side
])
def test_row_jacobians_match_jax(box, use_light, detach_frame, position_row):
    ref = EJ._row_jacobians_all(box["logs_j"], box["ray_j"].o, use_light,
                                detach_frame, position_row)
    got = ET._row_jacobians_all(box["logs_t"], _t(box["ray_j"].o),
                                use_light, detach_frame, position_row)
    assert set(got) == set(ref)
    alive = np.asarray(box["logs_j"].active)
    for key in ref:
        r, g = np.asarray(ref[key])[alive], got[key].numpy()[alive]
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(r), key)
        ok = np.isfinite(r)
        _close_to_max(np.where(ok, g, 0.0), np.where(ok, r, 0.0), 1e-4, key)


@pytest.mark.parametrize("caustic", [False, True])
def test_calc_grad_matches_jax(box, grads_in, calc_grad_j, caustic):
    dl, dp = grads_in
    got = ET.calc_grad(box["logs_t"], _t(dl), _t(dp), _t(box["ray_j"].o),
                       caustic)
    for name, g, r in zip(("path", "light", "diffuse"), got,
                          calc_grad_j[caustic]):
        r = np.asarray(r)
        # no port scene has work for the light solve: it needs a smooth
        # non-diffuse (glossy) vertex before the first diffuse one
        assert (np.abs(r).max() > 0) == (name != "light"), name
        _close_to_max(g.numpy(), r, 1e-3, name)


@pytest.mark.parametrize("caustic", [False, True])
def test_inject_gradients_matches_jax(box, calc_grad_j, caustic):
    sj, st = box["sj"], box["st"]
    out_j = calc_grad_j[caustic]
    acc_j = {"vertices": jnp.zeros_like(sj.vertices),
             "normals": jnp.zeros_like(sj.normals),
             "alpha": jnp.zeros_like(sj.bsdfs["alpha"])}
    ref = EJ.inject_gradients(sj, box["logs_j"], *out_j, acc_j)
    got = ET.inject_gradients(
        st, box["logs_t"], *(_t(x) for x in out_j),
        {"vertices": torch.zeros_like(st.vertices),
         "normals": torch.zeros_like(st.normals),
         "alpha": torch.zeros_like(st.bsdfs["alpha"])})
    for k in ("vertices", "normals"):
        assert np.abs(np.asarray(ref[k])).max() > 0, k
        _close_to_max(got[k].numpy(), ref[k], 1e-3, k)
    # the roughness branch has no work on this box: no logged bounce is
    # glossy, and both packages' alpha grads are 0 (tests/
    # test_torch_epsm_glossy.py holds it on a glossy scene)
    glossy = BJ.has_flag(box["logs_j"].bsdf_flags, BJ.BSDFFlags.Glossy)
    assert not bool(jnp.any(glossy))
    assert not BT.has_flag(box["logs_t"].bsdf_flags,
                           BT.BSDFFlags.Glossy).any()
    assert float(jnp.abs(ref["alpha"]).max()) == 0.0
    assert float(got["alpha"].abs().max()) == 0.0


def test_constraint_frame_matches_jax():
    r = np.random.default_rng(2)
    n = r.normal(size=(500, 3)).astype(np.float32)
    v = r.normal(size=(500, 3)).astype(np.float32)
    n[:3] = [[1.0, 0.0, 0.0], [0.0, 0.0, 0.0], [1e-20, 0.0, 1e-20]]
    ref = np.asarray(EJ.to_constraint_local(jnp.asarray(n), jnp.asarray(v)))
    got = ET.to_constraint_local(_t(n), _t(v)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_manifold_seeds_independent_on_a_stratified_scene():
    """The EPSM primal and backward seed the independent sampler whatever
    the scene names, as the reference does (``integrators/epsm.py:759``,
    ``:797``): on a scene whose sampler is ``stratified`` the port's
    ``manifold`` render equals JAX's pixel for pixel (a stratified
    forward would draw other samples on every lane) and its backward
    from a seeded 5-channel cotangent gives JAX's gradients (within 1e-3
    of each largest entry, ``tests/test_torch_epsm_backward.py``).  PRB
    and ``path`` keep the scene's kind."""
    from test_torch_render import assert_images_close
    d = cornell_box_jax(res=8, spp=2, max_depth=2)
    d["sensor"]["sampler"]["type"] = "stratified"
    sj = mi.load_dict(d)
    st = port_scene_of(sj)
    assert st.static.sampler_kind == sj.static.sampler_kind == "stratified"
    ref = np.asarray(EJ.render_epsm(sj, seed=3, spp=2, max_depth=2))
    img = ET.render_epsm(st, seed=3, spp=2, max_depth=2).numpy()
    assert img.shape == ref.shape == (8, 8, 5) and img[..., :3].mean() > 0
    assert_images_close(img, ref)
    names = ("vertices", "bsdfs.reflectance", "sensors.0.to_world")
    g = np.random.default_rng(5).normal(size=(8, 8, 5)).astype(
        np.float32) * 0.05
    ref = jax.jit(EJ.render_backward, static_argnums=(3, 4, 5, 6, 7))(
        sj, jnp.asarray(g), jnp.uint32(3), 2, 5, False, -1, 2)
    got = ET.render_backward(st, names, torch.from_numpy(g), 3, 2, 5, False,
                             -1, 2)
    for k, r in (("vertices", ref.vertices),
                 ("bsdfs.reflectance", ref.bsdfs["reflectance"]),
                 ("sensors.0.to_world", ref.sensors[0].to_world)):
        assert np.abs(np.asarray(r)).max() > 0, k
        _close_to_max(got[k].numpy(), r, 1e-3, k)
