"""The port's primal Cornell-box render against the JAX package's.

The JAX scene's state goes to the port through ``scene_from_arrays``, so
both packages render the very same scene at the same seed.  Per-pixel
tolerance: mean |diff| <= 1e-4 and >= 99 % of pixels within 1e-4.  XLA
and PyTorch round some operations differently, and a grazing hit that
flips changes one path of a pixel.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.utils.image import z_test
from scenes import cornell_box as cornell_box_jax

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.ad import prb as prb_t
from epsm_mitsuba3_torch.integrators import common as common_t
from epsm_mitsuba3_torch.integrators import path as path_t
from epsm_mitsuba3_torch.models import films as films_t
from epsm_mitsuba3_torch.models import samplers as smp_t
from epsm_mitsuba3_torch.models import textures as tex_t
from epsm_mitsuba3_torch.models.scene import GEOMETRY_FIELDS
from epsm_mitsuba3_torch.ops.bvh import ARRAY_FIELDS as BVH_FIELDS
from epsm_mitsuba3_torch.scenes import cornell_box
from torch_threads import one_torch_thread  # noqa: F401

#: a Sensor's static fields, the same in both packages
SENSOR_STATIC = ("kind", "fov_x", "near", "far", "width", "height",
                 "rfilter", "aperture_radius", "focus_distance", "sub_fov_x")
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
RES, SPP, DEPTH = 32, 4, 4


def jax_arrays(sj) -> dict:
    """The JAX Scene's state as numpy arrays under its field names."""
    out = {k: np.asarray(getattr(sj, k)) for k in GEOMETRY_FIELDS}
    if sj.vertex_colors is not None:
        out["vertex_colors"] = np.asarray(sj.vertex_colors)
    out.update({f"bsdfs.{k}": np.asarray(v) for k, v in sj.bsdfs.items()})
    out.update({f"emitters.{k}": np.asarray(v)
                for k, v in sj.emitters.items()})
    for i, s in enumerate(sj.sensors):
        out[f"sensors.{i}.to_world"] = np.asarray(s.to_world)
        if s.sub_to_world is not None:
            out[f"sensors.{i}.sub_to_world"] = np.asarray(s.sub_to_world)
    for i, tex in enumerate(sj.textures):
        out.update({f"textures.{i}.{k}": np.asarray(getattr(tex, k))
                    for k in tex_t.ARRAYS if getattr(tex, k) is not None})
    if sj.bvh is not None:
        out.update({f"bvh.{k}": np.asarray(getattr(sj.bvh, k))
                    for k in BVH_FIELDS})
    return out


def _jax_leaf(sj, name):
    """The JAX scene's leaf under the port's leaf name (``vertices``,
    ``bsdfs.reflectance``, ``textures.3.data``, ``sensors.0.to_world``)."""
    part = name.split(".")
    if part[0] in ("bsdfs", "emitters"):
        return getattr(sj, part[0])[part[1]]
    if part[0] in ("textures", "sensors"):
        return getattr(getattr(sj, part[0])[int(part[1])], part[2])
    return getattr(sj, name)


def _jax_with_leaf(sj, name, value):
    """The JAX scene with the leaf ``name`` replaced by ``value``."""
    part = name.split(".")
    if part[0] in ("bsdfs", "emitters"):
        return sj.replace(**{part[0]: {**getattr(sj, part[0]),
                                       part[1]: value}})
    if part[0] in ("textures", "sensors"):
        seq = list(getattr(sj, part[0]))
        seq[int(part[1])] = seq[int(part[1])].replace(**{part[2]: value})
        return sj.replace(**{part[0]: tuple(seq)})
    return sj.replace(**{name: value})


def jax_leaf_vjp(sj, fn, names):
    """``jax.vjp`` of ``fn(scene)`` w.r.t. the leaves ``names`` of the JAX
    scene ``sj`` only: (the output, the vjp, which maps a cotangent to
    the leaves' cotangents in the order of ``names``).  The same
    cotangents as a vjp w.r.t. the whole scene gives those leaves, and
    XLA compiles the backward of these leaves alone, not of every leaf
    of the scene (about 30 % less compile time for a PRB render)."""
    def f(values):
        s = sj
        for k, v in zip(names, values):
            s = _jax_with_leaf(s, k, v)
        return fn(s)
    return jax.vjp(f, [_jax_leaf(sj, k) for k in names])


def jax_leaf_grads(sj, loss, names):
    """``jax.value_and_grad`` of the scalar ``loss(scene)`` w.r.t. the
    leaves ``names`` of ``sj`` only (``jax_leaf_vjp``): (the loss,
    {name: numpy gradient})."""
    value, vjp = jax_leaf_vjp(sj, loss, names)
    (g,) = vjp(jnp.ones_like(value))
    return value, {k: np.asarray(v) for k, v in zip(names, g)}


def port_scene_of(sj, device="cpu"):
    """The port's Scene holding the JAX scene's state."""
    sensors = [{f: getattr(s, f) for f in SENSOR_STATIC}
               for s in sj.sensors]
    st = sj.static
    return mt.scene_from_arrays(jax_arrays(sj), sensors=sensors,
                                integrator=dict(st.integrator), spp=st.spp,
                                sampler_kind=st.sampler_kind,
                                shape_names=st.shape_names,
                                vertex_ranges=st.vertex_ranges,
                                textures=[{"kind": t.kind}
                                          for t in sj.textures],
                                env_texture=st.env_texture, device=device)


def assert_images_close(a, b, tol=1e-4):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    diff = np.abs(a - b).max(axis=-1)
    mean_abs = float(np.abs(a - b).mean())
    within = float((diff <= tol).mean())
    assert mean_abs <= tol and within >= 0.99, (mean_abs, within)


@pytest.fixture(scope="module")
def scenes():
    sj = mi.load_dict(cornell_box_jax(res=RES, spp=SPP, max_depth=DEPTH))
    return sj, port_scene_of(sj)


@pytest.fixture(scope="module")
def jax_image(scenes):
    return np.asarray(mi.render(scenes[0], spp=SPP, seed=0))


def test_render_matches_jax(scenes, jax_image):
    img = mt.render(scenes[1], spp=SPP, seed=0, device="cpu").numpy()
    assert img.shape == (RES, RES, 3) and np.isfinite(img).all()
    assert_images_close(img, jax_image)


def test_render_other_seed_differs(scenes, jax_image):
    """Seeds reach the sampler: seed 1 gives another noise pattern."""
    img = mt.render(scenes[1], spp=SPP, seed=1, device="cpu").numpy()
    assert float(np.abs(img - jax_image).mean()) > 1e-3


def test_render_spp_chunk_kahan_passes(scenes):
    """Two passes of 2 spp (pass p seeded seed * 2 + p), Kahan-summed."""
    ref = np.asarray(mi.render(scenes[0], spp=SPP, seed=3, spp_chunk=2))
    img = mt.render(scenes[1], spp=SPP, seed=3, spp_chunk=2,
                    device="cpu").numpy()
    assert_images_close(img, ref)


def test_load_dict_arrays_equal_jax(scenes):
    """The port's own loader builds the JAX loader's arrays."""
    sj, _ = scenes
    st = mt.load_dict(cornell_box(res=RES, spp=SPP, max_depth=DEPTH),
                      device="cpu")
    ref = jax_arrays(sj)
    for k in GEOMETRY_FIELDS:
        np.testing.assert_array_equal(getattr(st, k).numpy(), ref[k], k)
    for k, v in st.bsdfs.items():
        np.testing.assert_array_equal(v.numpy(), ref[f"bsdfs.{k}"], k)
    for k, v in st.emitters.items():
        np.testing.assert_array_equal(v.numpy(), ref[f"emitters.{k}"], k)
    np.testing.assert_array_equal(st.sensors[0].to_world.numpy(),
                                  ref["sensors.0.to_world"])
    s_j, s_t = sj.sensors[0], st.sensors[0]
    for f in SENSOR_STATIC:
        assert getattr(s_t, f) == getattr(s_j, f), f
    assert st.static.bsdf_kinds == sj.static.bsdf_kinds
    assert st.static.emitter_kinds == sj.static.emitter_kinds
    assert st.static.spp == sj.static.spp


def test_load_dict_render_matches_jax(jax_image):
    st = mt.load_dict(cornell_box(res=RES, spp=SPP, max_depth=DEPTH),
                      device="cpu")
    img = mt.render(st, spp=SPP, seed=0, device="cpu").numpy()
    assert_images_close(img, jax_image)
    # the verify recipe's orientation checks: red left, green right,
    # the light in the top rows
    left, right = img[:, : RES // 8].mean((0, 1)), img[:, -RES // 8:].mean(
        (0, 1))
    assert left[0] > left[1] and right[1] > right[0]
    assert img[: RES // 2].mean() > img[RES // 2:].mean()


def test_golden_cornell_z_test():
    """The golden Z-test of tests/test_golden.py, with the port's path
    tracer giving mean and per-sample variance at 64 spp, seed 11."""
    ref = np.load(os.path.join(DATA, "golden_cornell.npz"))
    scene = mt.load_dict(cornell_box(res=32, spp=8, max_depth=4),
                         device="cpu")
    spp = 64
    sensor = scene.sensors[0]
    sampler = smp_t.seed(11, 32 * 32 * spp, device="cpu")
    sampler, ray, weight, _ = common_t.sample_rays(sensor, sampler, spp)
    L, _ = path_t.sample_primal(scene, sampler, ray, 4, 5)
    v = L * weight
    img6 = films_t.accumulate_coalesced(torch.cat([v, v * v], -1), 32, 32,
                                        spp).numpy()
    mean = img6[..., :3]
    var = np.maximum(img6[..., 3:] - mean ** 2, 0.0) * spp / (spp - 1)
    ok, pmin, fails = z_test(mean, np.maximum(var, ref["var"]), ref["mean"],
                             spp, significance=0.01)
    assert fails < 0.02, (pmin, fails)


def test_render_prb_is_one_pass(scenes):
    """render with spp <= spp_chunk is a single render_prb pass."""
    _, st = scenes
    a = mt.render(st, spp=2, seed=5, spp_chunk=4, device="cpu")
    b = prb_t.render_prb(st, seed=5, spp=2, max_depth=DEPTH)
    assert np.array_equal(a.numpy(), b.numpy())
