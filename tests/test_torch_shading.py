"""The port's shading modules against the JAX package's: the diffuse BSDF
(with a two-sided slot), the area emitter (two emitters, so the emitter
pick and the padded triangle CDF are exercised) and perspective camera
rays.  Same numpy inputs to both; rtol 1e-5 (atol 1e-6 for values near
zero)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.integrators import common as CJ
from epsm_mitsuba3_tpu.models import bsdf as BJ
from epsm_mitsuba3_tpu.models import emitters as EJ
from epsm_mitsuba3_tpu.models import samplers as SJ
from scenes import cornell_box as cornell_box_jax

from epsm_mitsuba3_torch.integrators import common as CT
from epsm_mitsuba3_torch.models import bsdf as BT
from epsm_mitsuba3_torch.models import emitters as ET
from epsm_mitsuba3_torch.models import samplers as ST

from test_torch_render import port_scene_of

N = 4096
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def scenes():
    d = cornell_box_jax(res=16, spp=2)
    d["floor"]["bsdf"] = {"type": "twosided", "bsdf": d["floor"]["bsdf"]}
    d["light2"] = {
        "type": "cube",
        "to_world": mi.ScalarTransform4f.translate([0.4, 0.3, 0.2])
        .scale(0.1),
        "emitter": {"type": "area", "radiance": {"type": "rgb",
                                                 "value": [1.0, 2.0, 3.0]}},
    }
    sj = mi.load_dict(d)
    return sj, port_scene_of(sj)


def _close(a, b, name):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL,
                               err_msg=name)


def _same(a, b, name):
    np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def _unit(r, n):
    v = r.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v.astype(np.float32)


def _bsdf_inputs(scenes, seed):
    sj, st = scenes
    r = np.random.default_rng(seed)
    nb = st.bsdfs["kind"].shape[0]
    idx = r.integers(-1, nb, N).astype(np.int32)
    wi = _unit(r, N)
    active = r.random(N) < 0.8
    return sj, st, r, idx, wi, active


def test_diffuse_sample(scenes):
    sj, st, r, idx, wi, active = _bsdf_inputs(scenes, 0)
    s1 = r.random(N).astype(np.float32)
    s2 = r.random((N, 2)).astype(np.float32)
    bs_j, w_j, ok_j = BJ.sample(sj.bsdfs, sj.static.bsdf_kinds,
                                jnp.asarray(idx), jnp.asarray(wi),
                                jnp.asarray(s1), jnp.asarray(s2),
                                jnp.asarray(active))
    bs_t, w_t, ok_t = BT.sample(st.bsdfs, st.static.bsdf_kinds,
                                torch.from_numpy(idx), torch.from_numpy(wi),
                                torch.from_numpy(s1), torch.from_numpy(s2),
                                torch.from_numpy(active))
    _same(ok_t, ok_j, "ok")
    assert ok_t.any() and not ok_t.all()
    for f in ("wo", "pdf", "eta", "hf"):
        _close(getattr(bs_t, f), getattr(bs_j, f), f)
    _same(bs_t.sampled_type, np.asarray(bs_j.sampled_type).astype(np.int32),
          "sampled_type")
    _close(w_t, w_j, "weight")


def test_diffuse_eval_pdf(scenes):
    sj, st, r, idx, wi, active = _bsdf_inputs(scenes, 1)
    wo = _unit(r, N)
    v_j, p_j = BJ.eval_pdf(sj.bsdfs, sj.static.bsdf_kinds, jnp.asarray(idx),
                           jnp.asarray(wi), jnp.asarray(wo),
                           jnp.asarray(active))
    v_t, p_t = BT.eval_pdf(st.bsdfs, st.static.bsdf_kinds,
                           torch.from_numpy(idx), torch.from_numpy(wi),
                           torch.from_numpy(wo), torch.from_numpy(active))
    assert (p_t > 0).any()
    _close(v_t, v_j, "value")
    _close(p_t, p_j, "pdf")
    flags_j = BJ.flags_of(sj.bsdfs, jnp.asarray(idx))
    _same(BT.flags_of(st.bsdfs, torch.from_numpy(idx)),
          np.asarray(flags_j).astype(np.int32), "flags")


def _emitter_geometry(s):
    return s.vertices, s.faces, s.em_faces


def test_area_emitter_sample_and_pdf(scenes):
    sj, st = scenes
    r = np.random.default_rng(2)
    ref_p = r.uniform([-0.9, 0.05, -0.9], [0.9, 1.9, 0.9],
                      (N, 3)).astype(np.float32)
    s2 = r.random((N, 2)).astype(np.float32)
    ds_j, w_j = EJ.sample_direction(sj.emitters, sj.static.emitter_kinds,
                                    jnp.asarray(ref_p), jnp.asarray(s2),
                                    *_emitter_geometry(sj))
    ds_t, w_t = ET.sample_direction(st.emitters, st.static.emitter_kinds,
                                    torch.from_numpy(ref_p),
                                    torch.from_numpy(s2),
                                    *_emitter_geometry(st))
    for a, b in zip(ET.area_emitter_data(*_emitter_geometry(st)),
                    EJ.area_emitter_data(*_emitter_geometry(sj))):
        _close(a, b, "cdf")
    _same(ds_t.emitter_index, ds_j.emitter_index, "emitter_index")
    assert set(np.unique(ds_t.emitter_index.numpy())) == {0, 1}
    _same(ds_t.delta, ds_j.delta, "delta")
    # XLA sums the triangle CDF in another order than torch.cumsum and
    # turns its division into a reciprocal multiply: the CDFs differ in
    # the last bit, and the triangle warp's sqrt magnifies that to ~1e-5
    # in uv near a vertex (and in direction components near zero)
    for f in ("p", "n", "uv", "d", "dist", "pdf"):
        np.testing.assert_allclose(getattr(ds_t, f).numpy(),
                                   np.asarray(getattr(ds_j, f)), rtol=RTOL,
                                   atol=2e-5, err_msg=f)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=RTOL,
                               atol=2e-5, err_msg="weight")

    # pdf_direction of hits on the sampled points; some lanes hit no
    # emitter and some are inactive
    hit_idx = np.where(r.random(N) < 0.1, -1,
                       np.asarray(ds_j.emitter_index)).astype(np.int32)
    active = r.random(N) < 0.9
    pj = EJ.pdf_direction(sj.emitters, sj.static.emitter_kinds,
                          jnp.asarray(ref_p), ds_j.d, jnp.asarray(hit_idx),
                          ds_j.p, ds_j.n, *_emitter_geometry(sj),
                          jnp.asarray(active))
    pt = ET.pdf_direction(st.emitters, st.static.emitter_kinds,
                          torch.from_numpy(ref_p), ds_t.d,
                          torch.from_numpy(hit_idx), ds_t.p, ds_t.n,
                          *_emitter_geometry(st), torch.from_numpy(active))
    assert (pt > 0).any()
    _close(pt, pj, "pdf_direction")


def test_area_emitter_eval_hit(scenes):
    sj, st = scenes
    r = np.random.default_rng(3)
    idx = r.integers(-1, 2, N).astype(np.int32)
    wz = r.uniform(-1, 1, N).astype(np.float32)
    _close(ET.eval_hit(st.emitters, torch.from_numpy(idx),
                       torch.from_numpy(wz)),
           EJ.eval_hit(sj.emitters, jnp.asarray(idx), jnp.asarray(wz)),
           "eval_hit")


@pytest.mark.parametrize("seed", [0, 7])
def test_perspective_sample_rays(scenes, seed):
    sj, st = scenes
    spp = 2
    sensor_j, sensor_t = sj.sensors[0], st.sensors[0]
    n = sensor_j.width * sensor_j.height * spp
    smp_j, ray_j, w_j, pos_j = CJ.sample_rays(
        sensor_j, SJ.seed(jnp.uint32(seed), n), spp)
    smp_t, ray_t, w_t, pos_t = CT.sample_rays(
        sensor_t, ST.seed(seed, n, device="cpu"), spp)
    for f in ("o", "d", "d_x", "d_y"):
        _close(getattr(ray_t, f), getattr(ray_j, f), f)
    _close(w_t, w_j, "weight")
    _same(pos_t, pos_j, "pos")
    # the sampler advanced by the same two draws
    _, x_j = SJ.next_1d(smp_j)
    _, x_t = ST.next_1d(smp_t)
    _same(x_t, x_j, "next draw")
