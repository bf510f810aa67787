"""The EPSM layer on the remaining scalar BSDFs, ``mask`` and Beckmann,
against the JAX package:

- a ``manifold`` render and its backward from a seeded 5-channel
  cotangent on a 16^2 x 4 spp box at depth 2 with a Beckmann rough
  conductor floor (a glossy slot: the ``alpha`` branch), for the
  vertices, ``alpha`` and the reflectances.  A mask's blend would triple
  the reference's compile of ``render_backward`` (~60 s here); the
  chip's ``[bsdfs]`` phase runs a mask through the EPSM iteration.  A
  path through a ``Null`` lobe (a thin dielectric's transmission, a null)
  puts a singular half-vector constraint into the manifold solve, which
  then magnifies float32 rounding by ~10^5 (``ROADMAP.md`` queue 3): the
  logged paths are held through the ``alpha`` branch below instead;
- the injection's ``alpha`` branch alone on the port's logged paths of a
  box with a principled floor, a Beckmann rough conductor back wall, a
  blend of a rough plastic and a diffuse on the left wall, a two-sided
  rough dielectric right wall and a thin dielectric pane, both packages
  fed the same logs and half-vector gradients: the reference replays GGX
  at the slot's raw ``alpha`` on every glossy slot -- a Beckmann slot, a
  principled slot (which samples at max(clip(alpha, .02, 1)^2, 1e-3)) and
  a blend slot (whose ``alpha`` is the blend row's, not its child's)
  alike (``ROADMAP.md`` queue 3).

Tolerance: every gradient within 1e-3 of its largest entry, as
``tests/test_torch_epsm_backward.py`` holds them (``calc_grad``'s block
inverses magnify float32 rounding; sums over hundreds of lanes in
another order); the image as ``assert_images_close``.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.integrators import epsm as EJ
from scenes import cornell_box as cornell_box_jax

from epsm_mitsuba3_torch.integrators import common as CT
from epsm_mitsuba3_torch.integrators import epsm as ET
from epsm_mitsuba3_torch.models import bsdf as BT
from epsm_mitsuba3_torch.models import samplers as ST

from test_torch_epsm import _close_to_max
from test_torch_render import assert_images_close, port_scene_of
from torch_threads import one_torch_thread  # noqa: F401

RES, SPP = 16, 4


def test_manifold_render_and_backward_match_jax():
    depth = 2
    d = cornell_box_jax(res=RES, spp=SPP, max_depth=depth)
    d["integrator"] = {"type": "manifold", "max_depth": depth}
    d["floor"]["bsdf"] = {"type": "roughconductor", "alpha": 0.25,
                          "distribution": "beckmann",
                          "specular_reflectance": [0.9, 0.8, 0.7]}
    sj = mi.load_dict(d)
    st = port_scene_of(sj)
    assert st.static.bsdf_kinds == (BT.KIND_DIFFUSE, BT.KIND_ROUGHCONDUCTOR,
                                    BT.KIND_SENTINEL_BECKMANN)
    ref = np.asarray(EJ.render_epsm(sj, seed=3, spp=2, max_depth=depth))
    img = ET.render_epsm(st, seed=3, spp=2, max_depth=depth).numpy()
    assert img.shape == ref.shape == (RES, RES, 5) and img[..., :3].mean() > 0
    assert_images_close(img, ref)
    g = np.random.default_rng(17).normal(size=(RES, RES, 5)).astype(
        np.float32) * 0.05
    rj = jax.jit(EJ.render_backward, static_argnums=(3, 4, 5, 6, 7))(
        sj, jnp.asarray(g), jnp.uint32(3), depth, 5, False, -1, 2)
    refs = {"vertices": rj.vertices,
            **{f"bsdfs.{k}": rj.bsdfs[k] for k in ("alpha", "reflectance")}}
    got = ET.render_backward(st, tuple(refs), torch.from_numpy(g), 3,
                             depth, 5, False, -1, 2)
    for k, r in refs.items():
        r, gk = np.asarray(r), got[k].numpy()
        assert gk.shape == r.shape and np.isfinite(gk).all(), k
        assert np.isfinite(r).all(), k
        assert np.abs(r).max() > 0, k
        _close_to_max(gk, r, 1e-3, k)
    floor = int(st.shape_bsdf[list(st.static.shape_names).index("floor")])
    assert got["bsdfs.alpha"][floor] != 0


def test_inject_alpha_branch_on_new_kinds_matches_jax():
    d = cornell_box_jax(res=RES, spp=SPP, max_depth=3)
    d["floor"]["bsdf"] = {"type": "principled", "base_color": [0.6, 0.5, 0.4],
                          "roughness": 0.3, "metallic": 0.5}
    d["back"]["bsdf"] = {"type": "roughconductor", "alpha": 0.2,
                         "distribution": "beckmann"}
    d["left"]["bsdf"] = {"type": "blendbsdf", "weight": 0.5, "alpha": 0.35,
                         "a": {"type": "roughplastic", "alpha": 0.15},
                         "b": d["left"]["bsdf"]}
    d["right"]["bsdf"] = {"type": "twosided", "bsdf": {
        "type": "roughdielectric", "alpha": 0.3}}
    d["pane"] = {"type": "rectangle", "bsdf": {"type": "thindielectric"},
                 "to_world": mi.ScalarTransform4f.translate(
                     [0.0, 0.8, 0.3]).scale(0.3)}
    sj = mi.load_dict(d)
    st = port_scene_of(sj)
    n = RES * RES * SPP
    sampler, ray, _, _ = CT.sample_rays(st.sensors[-1],
                                        ST.seed(2, n, device="cpu"), SPP)
    _, _, logs = ET.sample_path_logged(st, sampler, ray, 3, 5)
    K = logs.b0.shape[0]
    r = np.random.default_rng(9)
    path_grad = np.zeros((K, 5, n, 3), np.float32)
    path_grad[:, 4] = r.normal(size=(K, n, 3)) * 0.01
    zeros = np.zeros((K, n, 3), np.float32)
    acc = {"vertices": torch.zeros_like(st.vertices),
           "normals": torch.zeros_like(st.normals),
           "alpha": torch.zeros_like(st.bsdfs["alpha"])}
    got = ET.inject_gradients(st, logs, torch.from_numpy(path_grad),
                              torch.from_numpy(zeros),
                              torch.from_numpy(zeros), acc)
    logs_j = EJ.PathLog(*(jnp.asarray(np.asarray(getattr(logs, f)).astype(
        np.uint32) if f == "bsdf_flags" else getattr(logs, f).numpy())
        for f in EJ.PathLog._fields))
    ref = EJ.inject_gradients(
        sj, logs_j, jnp.asarray(path_grad), jnp.asarray(zeros),
        jnp.asarray(zeros), {"vertices": jnp.zeros_like(sj.vertices),
                             "normals": jnp.zeros_like(sj.normals),
                             "alpha": jnp.zeros_like(sj.bsdfs["alpha"])})
    ga, ra = got["alpha"].numpy(), np.asarray(ref["alpha"])
    assert np.isfinite(ga).all()
    _close_to_max(ga, ra, 1e-3, "alpha")
    # every glossy slot the paths met took a gradient: the principled
    # floor, the Beckmann wall, the blend row, the rough dielectric
    names = list(st.static.shape_names)
    for shape in ("floor", "back", "left", "right"):
        slot = int(st.shape_bsdf[names.index(shape)])
        assert ga[slot] != 0 and ra[slot] != 0, shape
    # the pane's lanes are logged with its slot's flags, Null among them
    # (the ``isnull`` mask of calc_grad)
    pane = int(st.shape_bsdf[names.index("pane")])
    on_pane = logs.active & (logs.bsdf_index == pane)
    assert on_pane.any() and BT.has_flag(logs.bsdf_flags[on_pane],
                                         BT.BSDFFlags.Null).all()
    # the blend's children took none: the branch reads the hit slot's row
    blend = int(st.shape_bsdf[names.index("left")])
    for child in ("blend_a", "blend_b"):
        assert ga[int(st.bsdfs[child][blend])] == 0
