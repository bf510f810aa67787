"""PRB gradients through a ``mask`` (a blend of ``null`` and its
material) against the JAX package: a 16^2 x 4 spp box at depth 2 whose
back wall is a diffuse of opacity 0.6 (the walls with face normals), for
the vertices, the reflectances and ``blend_weight`` (the opacity).  The
reference's blend evaluates every kind of the scene three times a
lookup, so this box holds only the diffuse and the null kinds beside
it.

Tolerance: each gradient within 1e-4 of its largest entry, as
``tests/test_torch_prb.py`` holds the box's.
"""
from scenes import cornell_box as cornell_box_jax

from test_torch_prb_bsdfs import RES, prb_matches_jax
from test_torch_render_bsdfs import SPP
from torch_threads import one_torch_thread  # noqa: F401


def test_prb_gradients_through_a_mask_match_jax():
    d = cornell_box_jax(res=RES, spp=SPP, max_depth=2)
    d["back"]["bsdf"] = {"type": "mask", "opacity": 0.6,
                         "bsdf": d["back"]["bsdf"]}
    st, got = prb_matches_jax(d, ("vertices", "bsdfs.reflectance",
                                  "bsdfs.blend_weight"))
    assert st.static.bsdf_kinds == (0, 8, 10)
    mask = int(st.shape_bsdf[list(st.static.shape_names).index("back")])
    assert got["bsdfs.blend_weight"][mask] != 0
