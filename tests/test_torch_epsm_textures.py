"""The EPSM layer on textured boxes against the JAX package.  The logged
pass (``PathLog``) on the box of ``test_torch_render_textures.py`` (a
bitmap, a normal map, tabulated spectra and a ``mesh_attribute`` tile)
at 16^2 x 4 spp, depth 4, under the ``manifold`` integrator: its
normals are the normal-mapped shading normals, its BSDF draws see the
textures and the vertex colours.  A ``manifold`` render and its backward
from a seeded 5-channel cotangent on the box with the normal map alone,
at depth 3, for the vertices, the reflectances and the normal map's
texels.  (The backward's texture gradients are its PRB replay's, held
for a bitmap and the vertex colours in ``test_torch_render_textures.py``;
each texture and bounce adds ~20 s to the reference's compile of
``render_backward``.)

Tolerances: the logged pass as ``tests/test_torch_epsm.py`` holds it
(integer fields equal, floats within 1e-4 + 2e-5 relative, the NEE
fields of lanes on the emitter and of grazing NEE rays left out); the
image as ``assert_images_close``; the backward within 1e-3 of each
gradient's largest entry, as ``tests/test_torch_epsm_backward.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.integrators import epsm as EJ
from scenes import cornell_box as cornell_box_jax

from epsm_mitsuba3_torch.integrators import epsm as ET

from test_torch_epsm import (DEPTH, INT_FIELDS, NEE_FIELDS, RES, SPP,
                             _grazing_nee, _logged_case, _on_emitter)
from torch_threads import one_torch_thread  # noqa: F401
from test_torch_render import assert_images_close, port_scene_of
from test_torch_render_textures import textured_box
from test_torch_textures import case_bsdfs, texture_files


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return texture_files(str(tmp_path_factory.mktemp("tex")))


@pytest.fixture(scope="module")
def box(files):
    d = textured_box(files, res=RES, spp=SPP, max_depth=DEPTH)
    d["integrator"] = {"type": "manifold", "max_depth": DEPTH}
    return _logged_case(d)


def test_path_log_on_textures_matches_jax(box):
    st = box["st"]
    assert st.static.has_normal_maps and st.static.has_vertex_colors
    L, valid, logs = ET.sample_path_logged(st, box["smp_t"], box["ray_t"],
                                           DEPTH, 5)
    lj = box["logs_j"]
    skip = {f: _on_emitter(st, lj) for f in NEE_FIELDS}
    grazing = _grazing_nee(st, lj)
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
    # the normal-mapped walls' logged normals left the interpolated ones
    b0, b1 = logs.b0[..., None], logs.b1[..., None]
    n_interp = logs.n0 * b0 + logs.n1 * b1 + logs.n2 * (1 - b0 - b1)
    n_interp = n_interp / n_interp.norm(dim=-1, keepdim=True).clamp(1e-20)
    ntex = st.bsdfs["normal_tex"][logs.bsdf_index.clamp(min=0).long()]
    mapped = logs.active & (ntex >= 0)
    off = (logs.normal - n_interp).abs().amax(-1)
    assert mapped.sum() > 100 and (off[mapped] > 1e-3).float().mean() > 0.9


def test_manifold_render_and_backward_match_jax(files):
    depth = 3
    d = cornell_box_jax(res=RES, spp=SPP, max_depth=depth)
    d["integrator"] = {"type": "manifold", "max_depth": depth}
    d["left"]["bsdf"] = case_bsdfs(files)["normalmap"]
    sj = mi.load_dict(d)
    st = port_scene_of(sj)
    ref = np.asarray(EJ.render_epsm(sj, seed=3, spp=2, max_depth=depth))
    img = ET.render_epsm(st, seed=3, spp=2, max_depth=depth).numpy()
    assert img.shape == ref.shape == (RES, RES, 5) and img[..., :3].mean() > 0
    assert_images_close(img, ref)
    (nrm,) = st.static.normal_textures
    g = np.random.default_rng(17).normal(size=(RES, RES, 5)).astype(
        np.float32) * 0.05
    rj = jax.jit(EJ.render_backward, static_argnums=(3, 4, 5, 6, 7))(
        sj, jnp.asarray(g), jnp.uint32(3), depth, 5, False, -1, 2)
    refs = {"vertices": rj.vertices,
            "bsdfs.reflectance": rj.bsdfs["reflectance"],
            f"textures.{nrm}.data": rj.textures[nrm].data}
    got = ET.render_backward(st, tuple(refs), torch.from_numpy(g), 3,
                             depth, 5, False, -1, 2)
    for k, r in refs.items():
        r, gk = np.asarray(r), got[k].numpy()
        assert gk.shape == r.shape and np.isfinite(gk).all(), k
        assert np.isfinite(r).all(), k
        scale = float(np.abs(r).max())
        assert scale > 0, k
        np.testing.assert_allclose(gk, r, rtol=0, atol=1e-3 * scale,
                                   err_msg=k)
