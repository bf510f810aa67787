"""The port's EPSM backward through glass and a glossy lobe against the
JAX package's: ``render_backward`` end to end, at 16^2 x 4 spp (JAX's slow
tests ``tests/test_epsm2.py:94-141`` made smaller), on the caustic scene
(``manifold_caustic``, depth 4: the glass sphere's vertices must get
gradients) and on ``glossyball`` (``manifold_caustic``, depth 2: the
roughness ``alpha`` must get its gradient through the half vector); and
the injection's roughness branch alone, both packages fed the same logs
and half-vector gradients.

Tolerance: every gradient within 1e-3 of its largest entry, as
``tests/test_torch_epsm_backward.py``'s (``calc_grad``'s block inverses
magnify float32 rounding; sums over hundreds of lanes in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from epsm_mitsuba3_tpu.app.exp import glossyball as glossyball_j
from epsm_mitsuba3_tpu.integrators import epsm as EJ
from test_epsm2 import caustic_scene

from epsm_mitsuba3_torch.integrators import common as CT
from epsm_mitsuba3_torch.integrators import epsm as ET
from epsm_mitsuba3_torch.models import samplers as ST

from test_torch_epsm import _close_to_max
from test_torch_render import port_scene_of
from torch_threads import one_torch_thread  # noqa: F401

RES, SPP = 16, 4


def _glossyball():
    exp = glossyball_j.make(resolution=RES, spp=SPP, match_res=RES)
    return exp["apply"](exp["scene"], exp["init_theta"])


def _backward(sj, names, max_depth):
    st = port_scene_of(sj)
    s = sj.sensors[-1]
    g = np.random.default_rng(5).normal(
        size=(s.height, s.width, 5)).astype(np.float32) * 0.05
    ref = jax.jit(EJ.render_backward, static_argnums=(3, 4, 5, 6, 7))(
        sj, jnp.asarray(g), jnp.uint32(3), max_depth, 5, True, -1, SPP)
    got = ET.render_backward(st, names, torch.from_numpy(g), 3, max_depth,
                             5, True, -1, SPP)
    ref = {"vertices": ref.vertices, "normals": ref.normals,
           "bsdfs.alpha": ref.bsdfs["alpha"],
           "bsdfs.reflectance": ref.bsdfs["reflectance"]}
    return st, {k: got[k].numpy() for k in names}, {
        k: np.asarray(ref[k]) for k in names}


@pytest.fixture(scope="module")
def caustic():
    return _backward(caustic_scene(res=RES, spp=SPP), ("vertices", "normals"),
                     4)


@pytest.fixture(scope="module")
def glossy():
    return _backward(_glossyball(), ("vertices", "bsdfs.alpha",
                                     "bsdfs.reflectance"), 2)


@pytest.mark.parametrize("case", ["caustic", "glossy"])
def test_render_backward_matches_jax(case, request):
    _, got, ref = request.getfixturevalue(case)
    for k in ref:
        assert np.abs(ref[k]).max() > 0, k
        _close_to_max(got[k], ref[k], 1e-3, k)


def test_caustic_moves_the_glass(caustic):
    """manifold_caustic injects gradients into the refractive sphere's
    vertices (tests/test_epsm2.py:94-106)."""
    st, got, ref = caustic
    s, c = st.static.vertex_ranges[list(st.static.shape_names).index("ball")]
    assert np.abs(ref["vertices"][s:s + c]).max() > 0
    _close_to_max(got["vertices"][s:s + c], ref["vertices"][s:s + c], 1e-3,
                  "glass vertices")


def test_glossyball_alpha_gradient(glossy):
    """The roughness gradient lands on the ball's slot alone and equals
    JAX's (tests/test_epsm2.py:109-141)."""
    st, got, ref = glossy
    slot = int(st.shape_bsdf[list(st.static.shape_names).index("ball")])
    ga = got["bsdfs.alpha"]
    assert ga[slot] != 0 and np.isfinite(ga).all()
    assert (np.delete(ga, slot) == 0).all()
    _close_to_max(ga, ref["bsdfs.alpha"], 1e-3, "alpha")


def test_inject_alpha_branch_matches_jax():
    """The roughness branch alone: the port's logged glossyball paths and
    a seeded half-vector gradient, through both packages'
    inject_gradients; the alpha accumulators agree, and only glossy
    bounces add to them."""
    st = port_scene_of(_glossyball())
    n = RES * RES * SPP
    sampler, ray, _, _ = CT.sample_rays(st.sensors[-1],
                                        ST.seed(2, n, device="cpu"), SPP)
    _, _, logs = ET.sample_path_logged(st, sampler, ray, 2, 5)
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
    sj = _glossyball()
    logs_j = EJ.PathLog(*(jnp.asarray(np.asarray(getattr(logs, f)).astype(
        np.uint32) if f == "bsdf_flags" else getattr(logs, f).numpy())
        for f in EJ.PathLog._fields))
    ref = EJ.inject_gradients(
        sj, logs_j, jnp.asarray(path_grad), jnp.asarray(zeros),
        jnp.asarray(zeros), {"vertices": jnp.zeros_like(sj.vertices),
                             "normals": jnp.zeros_like(sj.normals),
                             "alpha": jnp.zeros_like(sj.bsdfs["alpha"])})
    assert np.abs(np.asarray(ref["alpha"])).max() > 0
    _close_to_max(got["alpha"].numpy(), ref["alpha"], 1e-4, "alpha")
    assert (got["vertices"] == 0).all() and (got["normals"] == 0).all()
