"""The inputs and launch rules of the warp-cooperative K2/K3 kernels, on
the CPU: the padded rows of the triangles they read, the breadth-first
record order that lets a block keep the top R records in shared memory,
R for a shared-memory budget, and the tie rule of the closest hit that
the kernels' warp reduction reproduces."""
import re

import numpy as np
import pytest
import torch

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.ops import _native
from epsm_mitsuba3_torch.ops import cuda_traverse as CT
from epsm_mitsuba3_torch.ops import traverse as TT
from epsm_mitsuba3_torch.scenes import cornell_box_mesh

SUBDIV = 46


@pytest.fixture(scope="module")
def mesh_scene():
    return mt.load_dict(cornell_box_mesh(res=16, spp=1, subdiv=SUBDIV),
                        device="cpu")


@pytest.mark.parametrize("when", ["load", "set_vertices"])
def test_kernel_layout_equals_rows(mesh_scene, when):
    sc = mesh_scene
    if when == "set_vertices":
        moved = sc.set_vertices(sc.vertices * 0.9 + 0.01)
        assert not torch.equal(moved.bvh_tris_k, sc.bvh_tris_k)
        sc = moved
    assert sc.bvh_tris_k.shape == (sc.faces.shape[0], 12)
    assert sc.bvh_tris_k.is_contiguous()
    assert torch.equal(sc.bvh_tris_k[:, :9], sc.bvh_tris)
    assert not sc.bvh_tris_k[:, 9:].any()


@pytest.mark.parametrize("layout", sorted(CT.LAYOUTS))
def test_kernel_tris_layouts(mesh_scene, layout):
    tri = mesh_scene.bvh_tris
    k = CT.kernel_tris(tri, layout)
    assert k.is_contiguous()
    assert CT._layout_tris(k, layout, tri.device) == tri.shape[0]
    if layout == "pad":
        assert torch.equal(k[:, :9], tri)
        assert not k[:, 9:].any()
    else:
        assert k is tri
    bad = k[:, :-1].contiguous()
    with pytest.raises(ValueError):
        CT._layout_tris(bad, layout, tri.device)


def test_schedules_are_compiled_configurations():
    """Every schedule the wrapper launches names a (layout, threads) pair
    the kernel source instantiates."""
    src = (_native.PKG / "csrc" / "bvh_traverse.cu").read_text()
    body = src[src.index("#define EPSM_BVH_CONFIGS"):]
    body = body[:body.index("\n\n")]
    names = {"kRows": "rows", "kPad": "pad"}
    compiled = {(names[a], int(b))
                for a, b in re.findall(r"X\((k\w+), (\d+)\)", body)}
    for sched in (CT.SCHEDULE, *CT.STEPS.values()):
        assert (sched.layout, sched.threads) in compiled, sched
    assert CT.STEPS["1+2+3"] == CT.SCHEDULE


def test_k4_schedules_are_compiled_configurations():
    """K4's compiled (layout, threads, fetch) triples are exactly its
    design steps, ``K4_SCHEDULE`` is one of them, and it reads the rows
    of K2's layout that ``closest_hit`` hands both."""
    src = (_native.PKG / "csrc" / "bvh_traverse.cu").read_text()
    body = src[src.index("#define EPSM_K4_CONFIGS"):]
    body = body[:body.index("\n\n")]
    names = {"kRows": "rows", "kPad": "pad", "kAhead": "ahead",
             "kTurn": "turn"}
    compiled = {(names[a], int(b), names[c]) for a, b, c in
                re.findall(r"X\((k\w+), (\d+), (k\w+)\)", body)}
    steps = {(v.layout, v.threads, v.fetch) for v in CT.K4_STEPS.values()}
    assert compiled == steps
    assert CT.K4_SCHEDULE in CT.K4_STEPS.values()
    assert set(CT.FETCHES) == {"ahead", "turn"}
    assert CT.K4_SCHEDULE.layout == CT.SCHEDULE.layout
    assert CT.K4_SCHEDULE.persistent and CT.K4_SCHEDULE.shared
    assert CT.MULTI_POP == 0


@pytest.mark.parametrize("subdiv", [SUBDIV, 120])
def test_children_follow_parents(subdiv):
    """Records are in breadth-first order: every inner child's index
    exceeds its parent's, so any prefix [0, R) is closed upward and a
    walk from the root leaves shared memory at most once a path."""
    sc = (mt.load_dict(cornell_box_mesh(res=16, spp=1, subdiv=subdiv),
                       device="cpu"))
    nodes = sc.bvh_nodes
    ids, cnt = nodes[:, 0:4].long(), nodes[:, 4:8].long()
    parent = torch.arange(nodes.shape[0])[:, None].expand(-1, 4)
    inner = cnt == 0
    assert inner.any()
    assert bool((ids[inner] > parent[inner]).all())
    # every record but the root is some record's inner child, once
    seen = torch.bincount(ids[inner], minlength=nodes.shape[0])
    assert seen[0] == 0 and bool((seen[1:] == 1).all())


@pytest.mark.parametrize("n_records,budget,expect", [
    (1421, 232448 - 16, 1421),      # the mesh's whole tree fits
    (1421, 1421 * 128, 1421),
    (1421, 1421 * 128 - 1, 1420),
    (5000, 232448 - 16, 1815),      # a larger tree: its top 1,815 records
    (1421, 64 * 128 + 127, 64),
    (1421, 127, 0),
    (1421, 0, 0),
    (1, 128, 1)])
def test_shared_records(n_records, budget, expect):
    assert CT.shared_records(n_records, budget) == expect


def _tie_scene(two_leaves):
    """One root record whose leaf children hold two coincident triangles:
    both in child 0's leaf, or one in each of children 0 and 1, the leaf
    starts in slot order as ``collapse4`` makes them; a third, farther
    triangle behind them."""
    tri = torch.tensor([[0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0],
                        [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0],
                        [0.0, 0.0, -0.5, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0]])
    rec = torch.zeros(32)
    box = torch.tensor([0.0, 0.0, -0.6, 1.0, 1.0, 0.1])
    empty = torch.tensor([3e38, 3e38, 3e38, -3e38, -3e38, -3e38])
    if two_leaves:
        rec[0:4] = torch.tensor([0.0, 1.0, 2.0, 0.0])
        rec[4:8] = torch.tensor([1.0, 1.0, 1.0, -1.0])
        boxes = [box, box, box, empty]
    else:
        rec[0:4] = torch.tensor([0.0, 0.0, 0.0, 0.0])
        rec[4:8] = torch.tensor([3.0, -1.0, -1.0, -1.0])
        boxes = [box, empty, empty, empty]
    rec[8:32] = torch.cat(boxes)
    r = np.random.default_rng(3)
    n = 64
    xy = r.uniform(0.02, 0.45, (n, 2)).astype(np.float32)
    o = torch.from_numpy(np.concatenate(
        [xy, np.ones((n, 1), np.float32)], 1))
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(n, 3).contiguous()
    maxt = torch.full((n,), float("inf"))
    return rec[None].contiguous(), tri, o, d, maxt


@pytest.mark.parametrize("two_leaves", [False, True])
def test_plain_k2_keeps_the_lower_slot_on_ties(two_leaves):
    """Of two coincident triangles the closest hit keeps the lower slot,
    whether they share a leaf or lie in two leaf children: the rule the
    kernels' warp reduction (lowest lane at the least t, chunk after
    chunk, child after child) reproduces."""
    nodes, tri, o, d, maxt = _tie_scene(two_leaves)
    t, slot, u, v = CT.closest_hit(nodes, tri, o, d, maxt,
                                   tri_k=CT.kernel_tris(tri))
    assert bool((slot == 0).all())
    assert torch.equal(t, torch.ones_like(t))
    assert torch.equal(u, o[:, 0]) and torch.equal(v, o[:, 1])
    ref = TT.bvh_ray_intersect_plain(nodes, tri, o, d, maxt, multi_pop=4)
    assert torch.equal(ref[1], slot)
    assert bool(CT.any_hit(nodes, tri, o, d, maxt).all())
