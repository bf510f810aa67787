"""The remaining scalar BSDFs in scenes against the JAX package, second
part (``test_torch_render_bsdfs.py`` has the first):

- a ``path`` render of a box with a blend of a plastic and a GGX rough
  dielectric, and thin-dielectric and pplastic quads;
- PRB gradients at depth 2 of the vertices, ``alpha``,
  ``diffuse_reflectance``, ``reflectance`` and ``eta`` on a box with a
  rough plastic floor and a plastic back wall, the walls with face
  normals so that their shading moves with the vertices
  (``blend_weight``'s is in ``test_torch_prb_mask.py``: the reference's
  blend evaluates every kind three times a lookup, and each kind adds to
  its compile).

The JAX scene is carried across by ``scene_from_arrays``.

Tolerances: images ``assert_images_close`` of ``test_torch_render.py``
(mean |diff| <= 1e-4, >= 99 % of pixels within 1e-4); PRB gradients each
within 1e-4 of its largest entry, as ``tests/test_torch_prb.py`` holds
the box's (the fused replay's remaining radiance, sums in other orders).
"""
import numpy as np
import torch

import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from scenes import cornell_box as cornell_box_jax

import epsm_mitsuba3_torch as mt

from test_torch_render import jax_leaf_grads, port_scene_of
from test_torch_render_bsdfs import SPP, box_b, check_render
from torch_threads import one_torch_thread  # noqa: F401

RES = 16


def prb_matches_jax(d, names):
    """PRB gradients of ``names`` on ``d`` (its walls with face normals)
    against ``jax.grad`` through JAX's PRB render of a seeded weighting
    of the image; each finite and non-zero.  Returns the port's
    gradients."""
    for k in ("floor", "ceiling", "back", "left", "right"):
        # face normals: the shading then moves with the vertices
        d[k]["face_normals"] = True
    sj = mi.load_dict(d)
    st = port_scene_of(sj)
    W = np.random.default_rng(31).uniform(0, 1, (RES, RES, 3)).astype(
        np.float32)
    _, ref = jax_leaf_grads(
        sj, lambda s: jnp.sum(mi.render(s, spp=SPP, seed=0) * W), names)
    lv = {k: v.clone().requires_grad_(True)
          for k, v in st.leaves().items() if k in ref}
    assert set(lv) == set(ref)
    img = mt.render(st.with_leaves(lv), spp=SPP, seed=0, device="cpu")
    got = torch.autograd.grad((img * torch.from_numpy(W)).sum(),
                              list(lv.values()))
    for k, gk in zip(lv, got):
        r, gk = np.asarray(ref[k]), gk.numpy()
        assert np.isfinite(gk).all() and np.isfinite(r).all(), k
        scale = float(np.abs(r).max())
        assert scale > 0, k
        np.testing.assert_allclose(gk, r, rtol=0, atol=1e-4 * scale,
                                   err_msg=k)
    return st, dict(zip(lv, got))


def test_render_matches_jax():
    """The blend (plastic, rough dielectric), thindielectric, pplastic."""
    check_render(box_b(), (0, 4, 5, 6, 10, 11))


def test_prb_gradients_match_jax():
    d = cornell_box_jax(res=RES, spp=SPP, max_depth=2)
    d["floor"]["bsdf"] = {"type": "roughplastic", "alpha": 0.25,
                          "int_ior": 1.6,
                          "diffuse_reflectance": [0.6, 0.55, 0.4]}
    d["back"]["bsdf"] = {"type": "plastic", "int_ior": 1.4,
                         "diffuse_reflectance": [0.3, 0.5, 0.6]}
    st, got = prb_matches_jax(d, ("vertices", "bsdfs.alpha",
                                  "bsdfs.diffuse_reflectance",
                                  "bsdfs.reflectance", "bsdfs.eta"))
    names = list(st.static.shape_names)
    floor = int(st.shape_bsdf[names.index("floor")])
    back = int(st.shape_bsdf[names.index("back")])
    for k in ("bsdfs.alpha", "bsdfs.eta"):
        assert got[k][floor] != 0, k
    assert got["bsdfs.eta"][back] != 0
    assert got["bsdfs.diffuse_reflectance"][back].abs().sum() > 0
