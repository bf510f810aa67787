"""The median-split BVH builder (``ops/bvh.py`` ``_build_numpy``,
``build(..., builder="numpy")``) in the port against the JAX package's:
its arrays bit for bit, ``collapse4`` on its tree, the K2/K3 records
packed from it, the plain K2/K3 on it against the brute force, a render
on it against the native tree's; and a failed native build still
raises, whatever builder exists beside it.

Tolerances: the tree, its BVH4 topology and levels exactly; hits as
``tests/test_torch_bvh.py`` holds the plain K2 against the brute force
(``valid`` equal, t within 1e-5 where the triangle agrees, >= 99.9 % of
the hit lanes on the same triangle: coincident-triangle ties may part);
the render against the native tree's as ``assert_images_close``."""
import numpy as np
import pytest
import torch

from epsm_mitsuba3_tpu.ops import bvh as BJ

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.ops import bvh as BT
from epsm_mitsuba3_torch.ops import cuda_intersect as CI
from epsm_mitsuba3_torch.ops import cuda_traverse as CT
from epsm_mitsuba3_torch.ops import intersect as IT
from epsm_mitsuba3_torch.scenes import bumpy_sphere, cornell_box_mesh

from test_torch_bvh import SUBDIV, _assert_hits_close, _port_hits, _rays
from test_torch_render import assert_images_close
from torch_threads import one_torch_thread  # noqa: F401


def _soup(n, seed):
    r = np.random.default_rng(seed)
    v = r.uniform(-1, 1, (3 * n, 3)).astype(np.float32)
    return v, r.integers(0, 3 * n, (n, 3)).astype(np.int32)


@pytest.mark.parametrize("geometry", ["bumpy sphere", "soup"])
def test_build_numpy_equals_jax(geometry):
    v, f = (bumpy_sphere(subdiv=SUBDIV) if geometry == "bumpy sphere"
            else _soup(3000, 4))
    got = BT._build_numpy(np.ascontiguousarray(v, np.float32),
                          np.ascontiguousarray(f, np.int32))
    ref = BJ._build_numpy(np.ascontiguousarray(v, np.float32),
                          np.ascontiguousarray(f, np.int32), BT.LEAF_SIZE)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # levels and the BVH4 topology on that tree
    np.testing.assert_array_equal(BT._node_levels(got[2]),
                                  BJ._node_levels(ref[2]))
    for a, b in zip(BT.collapse4(got[2], BT.MAX_LEAF4),
                    BJ.collapse4(ref[2], BJ.MAX_LEAF4)):
        np.testing.assert_array_equal(a, np.asarray(b))
    bvh = BT.build(v, f, builder="numpy")
    np.testing.assert_array_equal(bvh.order.numpy(), ref[3])
    assert bvh.c4_cnt.max() <= BT.MAX_LEAF4
    # another tree than the native builder's
    assert not np.array_equal(BT.build(v, f).meta.numpy(), ref[2])


@pytest.fixture(scope="module")
def scenes():
    """cornell_box_mesh on the native tree and on the numpy tree."""
    sc = mt.load_dict(cornell_box_mesh(res=16, spp=1, subdiv=SUBDIV),
                      device="cpu")
    sn = sc.with_bvh(BT.build(sc.vertices, sc.faces, builder="numpy"))
    return sc, sn, CI.pack_tris(sc.vertices, sc.faces)


def test_packed_records_of_the_numpy_tree(scenes):
    """Every BVH4 record's four child boxes are the boxes of the binary
    nodes ``c4_node`` names, and its leaves' slots the triangles
    ``order`` lists (``pack_bvh4``'s contract, on the other tree)."""
    sc, sn, _ = scenes
    nodes, tris = sn.bvh_nodes, sn.bvh_tris
    assert nodes.dtype == torch.float32 and nodes.shape[1] == 32
    assert sn.bvh_tris_k.dtype == torch.float32
    ref_n, ref_t, _ = CT.pack_bvh4(sn.bvh, sn.vertices, sn.faces)
    assert torch.equal(nodes, ref_n) and torch.equal(tris, ref_t)
    p = sn.vertices[sn.faces[sn.bvh.order.long()].long()]
    assert torch.equal(tris.reshape(-1, 3, 3)[:, 0], p[:, 0])
    assert not torch.equal(sn.bvh.order, sc.bvh.order)


@pytest.mark.parametrize("kind", ["camera", "random"])
def test_plain_k2_k3_on_numpy_tree_match_brute_force(scenes, kind):
    _, sn, tri = scenes
    o, d, maxt = _rays(kind, sn)
    t, prim, u, v, occ = _port_hits(sn, o, d, maxt)
    ref = IT.ray_intersect_brute(tri, o, d, maxt)
    _assert_hits_close(t, prim, u, v, *ref)
    np.testing.assert_array_equal(occ.numpy(),
                                  IT.ray_test_brute(tri, o, d, maxt).numpy())


def test_render_on_numpy_tree_equals_native(scenes):
    sc, sn, _ = scenes
    a = mt.render(sc, spp=2, seed=0, device="cpu").numpy()
    b = mt.render(sn, spp=2, seed=0, device="cpu").numpy()
    assert_images_close(b, a)
    # set_vertices refits and re-packs the numpy tree as the native one
    s2 = sn.set_vertices(sn.vertices * 1.0)
    assert torch.equal(s2.bvh_nodes, sn.bvh_nodes)


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """A native builder that fails to build raises; only the explicit
    argument reaches the numpy builder, which needs no compiler."""
    v, f = bumpy_sphere(subdiv=8)
    broken = tmp_path / "bvh.cpp"
    broken.write_text("int f( {")
    monkeypatch.setattr(BT, "SPEC", BT._native.Spec(
        name="bvh_broken", source=broken, compiler="g++",
        flags=BT._native.GXX_FLAGS))
    monkeypatch.setattr(BT._native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(BT, "_lib", None)
    with pytest.raises(RuntimeError, match="failed"):
        BT.build(v, f)
    bvh = BT.build(v, f, builder="numpy")
    assert bvh.order.shape[0] == f.shape[0]
    with pytest.raises(ValueError, match="builder"):
        BT.build(v, f, builder="sah")
