"""The port's sensors (``models/sensors.py``), its camera rays
(``integrators/common.py`` ``sample_rays``) and its loader's sensor,
sampler and film fields against the JAX package's.

Tolerances, each with its reason:

- rays: o, d, d_x, d_y and weight within 1e-6 of each field's largest
  magnitude (at least 1), against JAX's functions called one by one and
  under ``jax.jit`` as its renders run them: XLA fuses multiply-adds and
  turns divisions by a constant into reciprocal multiplies, PyTorch does
  neither.  The distant sensor's origins lie 1,000 units away, where a
  float32 ulp is 6e-5.  Under jit, the irradiancemeter's directions
  within 0.02 of its horizon are left out: z = sqrt(1 - r^2) of the
  concentric disk at r near 1 magnifies XLA's fused rounding beyond
  1e-6, as for GGX near the horizon (``ROADMAP.md`` §3); film corners
  (u or v 0 or 1) map there.
- splat positions and the sampler's state after the camera draws: equal.
- loaded sensors: every static field equal, transforms equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.core import xmlparse as XJ
from epsm_mitsuba3_tpu.integrators import common as CJ
from epsm_mitsuba3_tpu.models import samplers as SJ
from epsm_mitsuba3_tpu.models import sensors as sns_j
from scenes import cornell_box as cornell_box_jax

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.core import xmlparse as XT
from epsm_mitsuba3_torch.core.transform import ScalarTransform4f as T
from epsm_mitsuba3_torch.integrators import common as CT
from epsm_mitsuba3_torch.models import samplers as ST
from epsm_mitsuba3_torch.models import sensors as sns_t
from epsm_mitsuba3_torch.scenes import cornell_box

from test_torch_render import SENSOR_STATIC

KINDS = sns_t.KINDS
TW = np.array([[0.8, 0.1, -0.59, 0.3], [0.0, 0.98, 0.17, 1.0],
               [0.6, -0.1, 0.79, 3.9], [0, 0, 0, 1]], np.float32)


def _sensor_kw(kind):
    kw = dict(kind=kind, fov_x=39.3, width=16, height=12, rfilter="gaussian",
              aperture_radius=0.2 if kind == "thinlens" else 0.0,
              focus_distance=3.0)
    if kind == "batch":
        kw.update(sub_fov_x=(40.0, 50.0), width=32, height=16)
    return kw


def _sub():
    shifted = TW.copy()
    shifted[:3, 3] += [0.5, -0.2, 0.1]
    return np.stack([TW, shifted])


def _sensors(kind):
    kw = _sensor_kw(kind)
    sub = _sub() if kind == "batch" else None
    s_j = sns_j.Sensor(to_world=jnp.asarray(TW), sub_to_world=(
        None if sub is None else jnp.asarray(sub)), **kw)
    s_t = sns_t.Sensor(to_world=torch.from_numpy(TW), sub_to_world=(
        None if sub is None else torch.from_numpy(sub)), **kw)
    return s_j, s_t


def _close_rays(ray_t, w_t, ray_j, w_j, keep=slice(None)):
    for f in ("o", "d", "d_x", "d_y"):
        got = getattr(ray_t, f).numpy()[keep]
        ref = np.asarray(getattr(ray_j, f))[keep]
        np.testing.assert_allclose(
            got, ref, rtol=0, atol=1e-6 * max(1.0, np.abs(ref).max()),
            err_msg=f)
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))


@pytest.mark.parametrize("kind", KINDS)
def test_sample_ray_differential_matches_jax(kind):
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 1, (600, 2)).astype(np.float32)
    pos[:4] = [[0, 0], [1, 1], [0.5, 0.5], [0.999, 0.0]]
    ap = rng.uniform(0, 1, (600, 2)).astype(np.float32)
    s_j, s_t = _sensors(kind)
    ray_t, w_t = sns_t.sample_ray_differential(s_t, torch.from_numpy(pos),
                                               torch.from_numpy(ap))
    ray_j, w_j = sns_j.sample_ray_differential(s_j, jnp.asarray(pos),
                                               jnp.asarray(ap))
    _close_rays(ray_t, w_t, ray_j, w_j)
    keep = np.ones(len(pos), bool)
    if kind == "irradiancemeter":
        keep = ray_t.d.numpy() @ (TW[:3, 2] / np.linalg.norm(TW[:3, 2])) \
            >= 0.02
        assert keep.sum() >= len(pos) - 8
    ray_j, w_j = jax.jit(sns_j.sample_ray_differential)(
        s_j, jnp.asarray(pos), jnp.asarray(ap))
    _close_rays(ray_t, w_t, ray_j, w_j, keep)
    d = ray_t.d.numpy()
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-6)
    if kind == "batch":        # the two halves of the film see two views
        left, right = pos[:, 0] < 0.5, pos[:, 0] >= 0.5
        np.testing.assert_array_equal(ray_t.o.numpy()[left][0], _sub()[0,
                                      :3, 3])
        np.testing.assert_array_equal(ray_t.o.numpy()[right][0], _sub()[1,
                                      :3, 3])


@pytest.mark.parametrize("kind,rfilter,sampler", [
    ("perspective", "gaussian", "stratified"),
    ("thinlens", "box", "stratified"),
    ("thinlens", "lanczos", "independent"),
    ("orthographic", "tent", "multijitter"),
    ("distant", "mitchell", "ldsampler"),
    ("radiancemeter", "catmullrom", "orthogonal"),
    ("irradiancemeter", "gaussian", "independent"),
    ("batch", "gaussian", "stratified"),
])
def test_sample_rays_matches_jax(kind, rfilter, sampler):
    """The wavefront's camera rays, splat positions (the pixel corner for
    the box, the jittered position otherwise) and the sampler after the
    camera draws: a thin lens draws its aperture sample too, even at
    radius 0, and each later draw must then agree."""
    s_j, s_t = _sensors(kind)
    s_j = s_j.replace(rfilter=rfilter)
    s_t = dataclasses.replace(s_t, rfilter=rfilter)
    spp = 4
    n = s_t.width * s_t.height * spp
    smp_j, ray_j, w_j, pos_j = jax.jit(CJ.sample_rays, static_argnums=2)(
        s_j, SJ.seed(3, n, kind=sampler, spp=spp), spp)
    smp_t, ray_t, w_t, pos_t = CT.sample_rays(
        s_t, ST.seed(3, n, kind=sampler, spp=spp), spp)
    _close_rays(ray_t, w_t, ray_j, w_j)
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    assert smp_t.dim == int(smp_j.dim)
    _, x_j = SJ.next_2d(smp_j)
    _, x_t = ST.next_2d(smp_t)
    np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
    # the shard of lanes [off, off + m) gets those lanes' rays
    off, m = 40, 96
    _, ray_s, _, pos_s = CT.sample_rays(
        s_t, ST.seed(3, m, kind=sampler, spp=spp, lane_offset=off), spp,
        lane_offset=off)
    np.testing.assert_array_equal(ray_s.d.numpy(),
                                  ray_t.d[off:off + m].numpy())
    np.testing.assert_array_equal(pos_s.numpy(), pos_t[off:off + m].numpy())


def test_film_projection_raises_by_name():
    _, s_t = _sensors("perspective")
    p = torch.zeros(4, 3)
    with pytest.raises(NotImplementedError, match="point_to_film"):
        sns_t.point_to_film(s_t, p)
    with pytest.raises(NotImplementedError, match="project_to_film"):
        sns_t.project_to_film(s_t, p)
    bad = sns_t.Sensor(to_world=torch.eye(4), kind="fisheye")
    with pytest.raises(NotImplementedError, match="fisheye"):
        sns_t.sample_ray_differential(bad, torch.zeros(4, 2))


# -- the loader ---------------------------------------------------------------

def _box_dicts(sensor=None, rfilter="keep", sampler=None):
    """The JAX and the port's cornell_box dicts at 16^2 with the sensor,
    filter (None: no rfilter entry) and sampler changed."""
    out = []
    for d in (cornell_box_jax(res=16, spp=4, max_depth=2),
              cornell_box(res=16, spp=4, max_depth=2)):
        s = d["sensor"]
        if sensor:
            s.update(sensor)
        if rfilter is None:
            del s["film"]["rfilter"]
        elif rfilter != "keep":
            s["film"]["rfilter"] = {"type": rfilter}
        if sampler:
            s["sampler"]["type"] = sampler
        out.append(d)
    return out


def _batch(width=32, kinds=("perspective", "perspective")):
    d = {"type": "batch",
         "film": {"type": "hdrfilm", "width": width, "height": 16},
         "sampler": {"type": "independent", "sample_count": 2}}
    for i, k in enumerate(kinds):
        d[f"view{i}"] = {"type": k, "fov": 40.0 + 10 * i,
                         "to_world": T.look_at(origin=[i * 0.3, 1, 3.9],
                                               target=[0, 1, 0],
                                               up=[0, 1, 0]).matrix}
    return d


def _assert_sensors_equal(st, sj):
    assert len(st.sensors) == len(sj.sensors)
    for s_t, s_j in zip(st.sensors, sj.sensors):
        for f in SENSOR_STATIC:
            assert getattr(s_t, f) == getattr(s_j, f), f
        np.testing.assert_array_equal(s_t.to_world.numpy(),
                                      np.asarray(s_j.to_world))
        if s_j.sub_to_world is None:
            assert s_t.sub_to_world is None
        else:
            np.testing.assert_array_equal(s_t.sub_to_world.numpy(),
                                          np.asarray(s_j.sub_to_world))
    assert st.static.sampler_kind == sj.static.sampler_kind
    assert st.static.spp == sj.static.spp


LOADER_CASES = {
    "no rfilter (gaussian)": dict(rfilter=None),
    "thinlens": dict(sensor={"type": "thinlens", "aperture_radius": 0.05,
                             "focus_distance": 3.5, "near_clip": 0.1,
                             "far_clip": 50.0}, rfilter="lanczos",
                     sampler="ldsampler"),
    "orthographic": dict(sensor={"type": "orthographic"}, rfilter="tent",
                         sampler="multijitter"),
    "distant": dict(sensor={"type": "distant"}, rfilter="mitchell",
                    sampler="orthogonal"),
    "radiancemeter": dict(sensor={"type": "radiancemeter"},
                          rfilter="catmullrom", sampler="stratified"),
    "irradiancemeter": dict(sensor={"type": "irradiancemeter"},
                            rfilter="box"),
}


@pytest.mark.parametrize("case", LOADER_CASES)
def test_load_dict_sensor_fields_equal_jax(case):
    dj, dt = _box_dicts(**LOADER_CASES[case])
    _assert_sensors_equal(mt.load_dict(dt, device="cpu"), mi.load_dict(dj))


def test_load_dict_batch_sensor_equals_jax():
    dj, dt = _box_dicts(sampler="stratified")
    dj["sensor"], dt["sensor"] = _batch(), _batch()
    st = mt.load_dict(dt, device="cpu")
    _assert_sensors_equal(st, mi.load_dict(dj))
    assert st.sensors[0].kind == "batch"
    # the batch sensor names no sampler kind, as in the reference
    assert st.static.sampler_kind == "independent"
    assert "sensors.0.sub_to_world" in st.leaves()


@pytest.mark.parametrize("width,kinds,match", [
    (33, ("perspective", "perspective"), "divisible"),
    (32, ("perspective", "thinlens"), "perspective"),
])
def test_batch_sensor_refusals_as_jax(width, kinds, match):
    for load, dev in ((mi.load_dict, {}), (mt.load_dict, {"device": "cpu"})):
        dj = _box_dicts()[0]
        dj["sensor"] = _batch(width, kinds)
        with pytest.raises(ValueError, match=match):
            load(dj, **dev)


@pytest.mark.parametrize("field,value", [("rfilter", "bilinear"),
                                         ("sampler", "sobol")])
def test_unported_film_and_sampler_raise_by_name(field, value):
    _, dt = _box_dicts(**{field: value})
    with pytest.raises(NotImplementedError, match=value):
        mt.load_dict(dt, device="cpu")


XML = """<scene version="3.0.0">
  <sensor type="{kind}">
    <float name="fov" value="41"/>
    <float name="aperture_radius" value="0.05"/>
    <float name="focus_distance" value="3.7"/>
    <float name="near_clip" value="0.2"/>
    <transform name="to_world">
      <lookat origin="0, 1, 3.9" target="0, 1, 0" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="16"/><integer name="height" value="8"/>
      {rfilter}
    </film>
    <sampler type="{sampler}"><integer name="sample_count" value="9"/></sampler>
  </sensor>
  <shape type="rectangle"><bsdf type="diffuse"/></shape>
  <shape type="rectangle">
    <transform name="to_world"><translate y="1" z="1"/></transform>
    <emitter type="area"><rgb name="radiance" value="1, 2, 3"/></emitter>
  </shape>
</scene>"""

BATCH_XML = """<scene version="3.0.0">
  <sensor type="batch">
    <sensor type="perspective" name="a"><float name="fov" value="35"/>
      <transform name="to_world"><translate z="4"/></transform></sensor>
    <sensor type="perspective" name="b"><float name="fov" value="55"/>
      <transform name="to_world"><translate x="0.4" z="4"/></transform>
    </sensor>
    <film type="hdrfilm">
      <integer name="width" value="24"/><integer name="height" value="12"/>
    </film>
    <sampler type="independent"><integer name="sample_count" value="2"/>
    </sampler>
  </sensor>
  <shape type="rectangle"><bsdf type="diffuse"/></shape>
  <shape type="rectangle">
    <transform name="to_world"><translate y="1" z="1"/></transform>
    <emitter type="area"><rgb name="radiance" value="1, 2, 3"/></emitter>
  </shape>
</scene>"""


@pytest.mark.parametrize("kind,rfilter,sampler", [
    ("thinlens", "", "stratified"),
    ("perspective", '<rfilter type="lanczos"/>', "ldsampler"),
    ("orthographic", '<rfilter type="catmullrom"/>', "orthogonal"),
    ("distant", '<rfilter type="tent"/>', "multijitter"),
])
def test_load_string_sensor_fields_equal_jax(kind, rfilter, sampler):
    """``<rfilter>`` and ``<sampler>`` pass through the XML parser as in
    JAX (``core/xmlparse.py``); with no ``<rfilter>`` the film's filter
    is the gaussian."""
    text = XML.format(kind=kind, rfilter=rfilter, sampler=sampler)
    st = XT.load_string(text, device="cpu")
    _assert_sensors_equal(st, XJ.load_string(text))
    if not rfilter:
        assert st.sensors[0].rfilter == "gaussian"


def test_load_string_batch_sensor_equals_jax():
    st = XT.load_string(BATCH_XML, device="cpu")
    _assert_sensors_equal(st, XJ.load_string(BATCH_XML))
    assert st.sensors[0].sub_fov_x == (35.0, 55.0)
