"""Renders and PRB gradients of a textured box against the JAX package:
the Cornell box with a bitmap reflectance (scaled and offset uvs) on the
back wall, a normal map on the left wall, a ``regular`` spectrum on the
ceiling, an ``irregular`` spectrum as the light's radiance, and a PLY
tile with vertex colours and a ``mesh_attribute`` reflectance; the JAX
scene is carried across by ``scene_from_arrays``.  The PRB gradients are taken
on the same box without the normal map (whose texels' gradient is held
in ``test_torch_epsm_textures.py``'s backward): each texture the JAX
reference evaluates on every lane adds ~20 s to its compile.  (The
checkerboard, the bump map and the wrappers' other forms are held at the
loader and the surface interaction, ``test_torch_textures.py``.)

Tolerances: images ``assert_images_close`` of ``test_torch_render.py``
(mean |diff| <= 1e-4, >= 99 % of pixels within 1e-4); PRB gradients of
the vertices, the bitmap's texels, the reflectances and the vertex
colours each within 1e-4 of its largest entry, as
``tests/test_torch_prb.py`` holds the box's (the fused replay's
remaining radiance, sums in other orders).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from scenes import cornell_box as cornell_box_jax

import epsm_mitsuba3_torch as mt

from test_torch_render import (assert_images_close, jax_leaf_grads,
                               port_scene_of)
from test_torch_textures import case_bsdfs, texture_files
from torch_threads import one_torch_thread  # noqa: F401

RES, SPP, DEPTH = 16, 4, 3


def textured_box(files, res=RES, spp=SPP, max_depth=DEPTH, normal_map=True):
    d = cornell_box_jax(res=res, spp=spp, max_depth=max_depth)
    d["back"]["bsdf"] = case_bsdfs(files)["bitmap"]
    if normal_map:
        d["left"]["bsdf"] = {"type": "normalmap", "normalmap": {
            "type": "bitmap", "filename": files["normal"]},
            "bsdf": d["left"]["bsdf"]}
    d["ceiling"]["bsdf"] = {"type": "diffuse", "reflectance": {
        "type": "regular", "wavelength_min": 400, "wavelength_max": 700,
        "values": [0.2, 0.5, 0.9, 0.6]}}
    d["light"]["emitter"]["radiance"] = {
        "type": "irregular", "value": "400:12, 480:18, 560:17, 700:14"}
    d["tile"] = {"type": "ply", "filename": files["ply"], "bsdf": {
        "type": "diffuse", "reflectance": {"type": "mesh_attribute",
                                           "name": "vertex_color"}}}
    return d


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return texture_files(str(tmp_path_factory.mktemp("tex")))


def test_render_matches_jax(files):
    sj = mi.load_dict(textured_box(files))
    st = port_scene_of(sj)
    assert st.static.has_normal_maps and st.static.has_vertex_colors
    ref = np.asarray(mi.render(sj, spp=SPP, seed=0))
    img = mt.render(st, spp=SPP, seed=0, device="cpu").numpy()
    assert img.shape == (RES, RES, 3) and np.isfinite(img).all()
    assert_images_close(img, ref)
    assert img.std() > 0.05


def test_prb_gradients_match_jax(files):
    """Vertices, the back wall's texels, the table's reflectances and the
    vertex colours, against ``jax.grad`` through JAX's PRB render."""
    sj = mi.load_dict(textured_box(files, normal_map=False))
    st = port_scene_of(sj)
    W = np.random.default_rng(31).uniform(0, 1, (RES, RES, 3)).astype(
        np.float32)
    refl = int(st.bsdfs["reflectance_tex"][
        st.shape_bsdf[st.static.shape_names.index("back")]])
    assert st.textures[refl].kind == "bitmap"
    _, ref = jax_leaf_grads(
        sj, lambda s: jnp.sum(mi.render(s, spp=SPP, seed=0) * W),
        ("vertices", "bsdfs.reflectance", "vertex_colors",
         f"textures.{refl}.data"))
    lv = {k: v.clone().requires_grad_(True)
          for k, v in st.leaves().items() if k in ref}
    img = mt.render(st.with_leaves(lv), spp=SPP, seed=0, device="cpu")
    got = torch.autograd.grad((img * torch.from_numpy(W)).sum(),
                              list(lv.values()))
    for k, gk in zip(lv, got):
        r, gk = np.asarray(ref[k]), gk.numpy()
        assert np.isfinite(r).all() and np.isfinite(gk).all(), k
        scale = float(np.abs(r).max())
        assert scale > 0, k
        np.testing.assert_allclose(gk, r, rtol=0, atol=1e-4 * scale,
                                   err_msg=k)
    # the tile's colours and the bitmap's texels took a gradient
    s, c = st.static.vertex_ranges[st.static.shape_names.index("tile")]
    vc = dict(zip(lv, got))["vertex_colors"].numpy()
    assert np.abs(vc[s:s + c]).max() > 0
    assert np.abs(np.delete(vc, np.s_[s:s + c], 0)).max() == 0
