"""Kernels K1, K2, K3 and K4 on the card against their plain versions, at
small and ragged shapes, and a fwd+bwd gradient on the card against the
CPU's.  These tests need CUDA and nvcc; without a card they skip.

Run them on a GPU machine (the suite's conftest imports JAX, which the
port does not need):

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \\
        tests/test_torch_cuda.py -q
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.ops import cuda_intersect as CI
from epsm_mitsuba3_torch.ops import cuda_traverse as CT
from epsm_mitsuba3_torch.ops import intersect as I
from epsm_mitsuba3_torch.ops import traverse as TR
from epsm_mitsuba3_torch.scenes import cornell_box, cornell_box_mesh

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _soup(n_tris, n_rays, seed):
    r = np.random.default_rng(seed)
    verts = r.uniform(-1, 1, (3 * n_tris, 3)).astype(np.float32)
    faces = np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)
    o = r.uniform(-2, 2, (n_rays, 3)).astype(np.float32)
    d = r.uniform(-0.8, 0.8, (n_rays, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxt = np.where(r.random(n_rays) < 0.3, r.uniform(0.5, 4, n_rays),
                    np.inf).astype(np.float32)
    maxt[r.random(n_rays) < 0.1] = 0.0
    tri = CI.pack_tris(torch.from_numpy(verts), torch.from_numpy(faces))
    return tri, torch.from_numpy(o), torch.from_numpy(d), \
        torch.from_numpy(maxt)


def _k1_case(case, n_tris, n_rays, seed):
    """K1's inputs for a test case: the random soup ("soup"); every ray
    of no extent ("dead"); every ray aimed at the first triangle, from in
    front of it, so the any hit stops at its first test ("first"); or
    rows copied across a warp chunk's edge (31 -> 32) and a tile's edge
    (999 -> 1000), half the rays aimed at the copies ("ties"); or two
    triangles 1e19 wide below the soup, whose determinant (1e38) passes
    2^126 and whose 1 / det is subnormal, hit by half the rays
    ("huge": the kernels' exact redo)."""
    tri, o, d, maxt = _soup(n_tris, n_rays, seed)
    if case == "huge":
        big = torch.tensor([-3e18, -3e18, -5.0, 1e19, 0.0, 0.0,
                            0.0, 1e19, 0.0, 0.0, 0.0, 0.0])
        tri[5] = big
        tri[n_tris - 3] = big
        r = np.random.default_rng(seed + 2)
        down = torch.from_numpy(r.random(n_rays) < 0.5)
        xy = torch.from_numpy(r.uniform(-1, 1, (n_rays, 2))
                              .astype(np.float32))
        o_down = torch.cat([xy, torch.full((n_rays, 1), -3.0)], 1)
        d_down = torch.tensor([[0.0, 0.0, -1.0]]).expand(n_rays, 3)
        o = torch.where(down[:, None], o_down, o).contiguous()
        d = torch.where(down[:, None], d_down, d).contiguous()
    elif case == "dead":
        maxt = torch.zeros_like(maxt)
    elif case in ("first", "ties"):
        if case == "ties":
            tri[32], tri[1000] = tri[31], tri[999]
        r = np.random.default_rng(seed + 1)
        rows = (np.zeros(n_rays, np.int64) if case == "first" else
                r.choice([31, 999], n_rays))
        w = tri[torch.from_numpy(rows)]
        bary = r.uniform(0.1, 0.4, (n_rays, 2)).astype(np.float32)
        bary = torch.from_numpy(bary)
        target = w[:, 0:3] + bary[:, :1] * w[:, 3:6] + bary[:, 1:] * w[:, 6:9]
        n = torch.linalg.cross(w[:, 3:6], w[:, 6:9])
        n = n / n.norm(dim=-1, keepdim=True)
        o = (target + 1e-3 * n).contiguous()
        d = (-n).contiguous()
        if case == "ties":     # and the other half as in the soup
            keep = torch.from_numpy(r.random(n_rays) < 0.5)
            _, o0, d0, _ = _soup(n_tris, n_rays, seed)
            o = torch.where(keep[:, None], o, o0).contiguous()
            d = torch.where(keep[:, None], d, d0).contiguous()
        maxt = torch.full_like(maxt, float("inf"))
    return tri, o, d, maxt


def _once(kind, fn, *args):
    """``fn(*args)``, which must launch K1's ``kind`` entry exactly once
    and no other kernel entry."""
    expect = dict(CI.launches)
    expect[f"mt_{kind}_hit"] += 1
    out = fn(*args)
    assert CI.launches == expect, (kind, fn)
    return out


def _k1_launches(tri, o, d, maxt):
    """Every K1 launch to hold against the plain versions: the main
    path's, each step's and, for tables of more than 1,000 rows, tiles of
    1,000 rows; each call launches its kernel exactly once."""
    args = (tri, o, d, maxt)
    out = {"main": (*_once("closest", CI.closest_hit, *args),
                    _once("any", CI.any_hit, *args))}
    for name, v in CI.STEPS.items():
        closest = (_once("closest", CI.launch_closest, *args, v)
                   if name in CI.CLOSEST_STEPS else out["main"][:4])
        occ = (_once("any", CI.launch_any, *args, v)
               if name in CI.ANY_STEPS else out["main"][4])
        out[name] = (*closest, occ)
    if tri.shape[0] > 1000:
        f, n = tri.shape[0], o.shape[0]
        out["tiles"] = (
            *_once("closest", CI.launch_closest, *args, replace(
                CI.launch_rule(f, n, "closest"), tile=1000)),
            _once("any", CI.launch_any, *args, replace(
                CI.launch_rule(f, n, "any"), tile=1000)))
    return out


@pytest.mark.parametrize("n_tris,n_rays,case", [
    (1, 1, "soup"), (12, 37, "soup"), (255, 4133, "soup"),
    (257, 4133, "soup"), (600, 1000, "soup"), (4096, 700, "soup"),
    (12, 1025, "dead"), (4096, 4133, "dead"), (12, 2049, "first"),
    (4096, 4133, "first"), (5000, 4133, "first"), (4096, 5003, "soup"),
    (5000, 5003, "soup"), (1100, 3001, "ties"), (5000, 3001, "ties"),
    (40, 2000, "huge"), (5000, 3001, "huge"), (12, 2 ** 20 + 37, "soup"),
    (1100, 300037, "ties")])
def test_k1_kernel_equals_plain(cuda, n_tris, n_rays, case):
    """Built with --fmad=false in the plain version's operation order:
    every launch (the main path's, each design step's, tiles) equals the
    plain versions bit for bit on the same card, at ray counts that are
    no multiple of R x the block, with all rays dead, all hitting the
    first triangle, copied rows across a chunk's and a tile's edge, and
    determinants past the fast reciprocal's range, and 2^20 rays; 5,000
    rows exceed a block's shared memory and go in tiles."""
    args_cpu = _k1_case(case, n_tris, n_rays, n_tris)
    args = [x.to(cuda) for x in args_cpu]
    before = dict(CI.launches)
    got = _k1_launches(*args)
    torch.cuda.synchronize()
    tiles = 1 if n_tris > 1000 else 0
    assert CI.launches["mt_closest_hit"] == (
        before["mt_closest_hit"] + 1 + len(CI.CLOSEST_STEPS) + tiles)
    assert CI.launches["mt_any_hit"] == (
        before["mt_any_hit"] + 1 + len(CI.ANY_STEPS) + tiles)
    ref = (*I.ray_intersect_brute(*args), I.ray_test_brute(*args))
    assert torch.equal(ref[4], ref[1] >= 0)
    for name, g in got.items():
        for field, a, b in zip(("t", "prim", "u", "v", "occ"), g, ref):
            assert a.dtype == b.dtype and torch.equal(a, b), (name, field)
    if case == "dead":
        assert not ref[4].any()
    if case == "huge":
        assert int((ref[1] == 5).sum()) > n_rays // 4
    if case == "first":
        assert bool(ref[4].all())
    if case == "ties":
        assert not bool(((ref[1] == 32) | (ref[1] == 1000)).any())
        assert int(((ref[1] == 31) | (ref[1] == 999)).sum()) > n_rays // 8
    # and the CPU plain version agrees on the hits
    t_c, prim_c, _, _ = CI.closest_hit(*args_cpu)
    assert (got["main"][1].cpu() == prim_c).float().mean() >= 0.9999


def test_k1_rejects_mixed_devices(cuda):
    tri, o, d, maxt = _soup(4, 8, 0)
    with pytest.raises(ValueError):
        CI.closest_hit(tri.to(cuda), o, d, maxt)


def test_render_cuda_matches_cpu(cuda):
    """The RNG is bit-exact on both devices: a small render agrees."""
    d = cornell_box(res=16, spp=2, max_depth=4)
    img_c = mt.render(mt.load_dict(d, device=cuda), spp=2, seed=0)
    img_h = mt.render(mt.load_dict(d, device="cpu"), spp=2, seed=0,
                      device="cpu")
    diff = (img_c.cpu() - img_h).abs()
    assert float(diff.mean()) <= 1e-3 * float(img_h.mean())
    assert float((diff.amax(-1) <= 1e-3).float().mean()) >= 0.99


def _mesh_rays(n_rays, seed):
    """Rays from inside the Cornell box in every direction, some of
    finite extent, a tenth dead."""
    r = np.random.default_rng(seed)
    o = r.uniform(-0.95, 0.95, (n_rays, 3)).astype(np.float32)
    o[:, 1] += 1.0
    d = r.normal(size=(n_rays, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    maxt = np.where(r.random(n_rays) < 0.3, r.uniform(0.1, 2.0, n_rays),
                    np.inf).astype(np.float32)
    maxt[r.random(n_rays) < 0.1] = 0.0
    return torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(maxt)


@pytest.fixture(scope="module")
def mesh_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return mt.load_dict(cornell_box_mesh(res=16, spp=1, subdiv=46),
                        device="cuda")


@pytest.mark.parametrize("n_rays,sort", [
    (1, False), (129, False), (4133, False), (4133, True), (65536, True)])
def test_k2_k3_kernels_equal_plain(mesh_scene, n_rays, sort):
    """Built with --fmad=false, walking the tree in the plain version's
    order: slots and t/u/v equal the plain version on the same card, and
    no ray runs out of stack."""
    sc = mesh_scene
    args = [x.to(sc.device) for x in _mesh_rays(n_rays, n_rays)]
    before = dict(CT.launches)
    t, slot, u, v = CT.closest_hit(sc.bvh_nodes, sc.bvh_tris, *args,
                                   sort=sort)
    occ = CT.any_hit(sc.bvh_nodes, sc.bvh_tris, *args, sort=sort)
    torch.cuda.synchronize()
    CT.raise_on_overflow(sc.device)
    assert CT.launches["bvh4_closest_hit"] == before["bvh4_closest_hit"] + 1
    assert CT.launches["bvh4_any_hit"] == before["bvh4_any_hit"] + 1
    t_p, slot_p, u_p, v_p = TR.bvh_ray_intersect_plain(
        sc.bvh_nodes, sc.bvh_tris, *args)
    assert torch.equal(slot, slot_p)
    assert torch.equal(occ, slot_p >= 0)
    assert torch.equal(occ, TR.bvh_ray_test_plain(sc.bvh_nodes,
                                                  sc.bvh_tris, *args))
    for a, b in ((t, t_p), (u, u_p), (v, v_p)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_k2_k3_overflow_is_flagged(mesh_scene, monkeypatch):
    """A stack too small for the tree sets the device flag, and
    raise_on_overflow raises once and clears it."""
    sc = mesh_scene
    args = [x.to(sc.device) for x in _mesh_rays(1024, 5)]
    monkeypatch.setattr(TR, "STACK_SIZE", 2)
    for fn in (CT.closest_hit, CT.any_hit, CT.closest_hit_reference):
        fn(sc.bvh_nodes, sc.bvh_tris, *args)
        with pytest.raises(TR.StackOverflow):
            CT.raise_on_overflow(sc.device)
        CT.raise_on_overflow(sc.device)


def test_k2_rejects_mixed_devices(mesh_scene):
    o, d, maxt = _mesh_rays(8, 0)
    with pytest.raises(ValueError):
        CT.closest_hit(mesh_scene.bvh_nodes, mesh_scene.bvh_tris, o, d, maxt)


def test_bvh_render_cuda_matches_cpu(mesh_scene):
    """A BVH scene renders through K2/K3 on the card as through their
    plain versions on the CPU."""
    d = cornell_box_mesh(res=16, spp=2, max_depth=4, subdiv=46)
    before = dict(CT.launches)
    img_c = mt.render(mt.load_dict(d, device="cuda"), spp=2, seed=0)
    assert CT.launches["bvh4_closest_hit"] == before["bvh4_closest_hit"] + 4
    assert CT.launches["bvh4_any_hit"] == before["bvh4_any_hit"] + 4
    img_h = mt.render(mt.load_dict(d, device="cpu"), spp=2, seed=0,
                      device="cpu")
    diff = (img_c.cpu() - img_h).abs()
    assert float(diff.mean()) <= 1e-3 * float(img_h.mean())
    assert float((diff.amax(-1) <= 1e-3).float().mean()) >= 0.99


def _k4_once(fn, *args, **kw):
    """``fn(*args, **kw)``, which must launch K4 exactly once and no other
    kernel entry."""
    expect = dict(CT.launches)
    expect["bvh4_closest_hit_mp"] += 1
    out = fn(*args, **kw)
    assert CT.launches == expect, fn
    return out


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("multi_pop", [2, 4])
@pytest.mark.parametrize("n_rays", [1, 129, 4133, 65536])
def test_k4_kernel_equals_plain(mesh_scene, n_rays, multi_pop, sort):
    """K4 (``closest_hit(..., multi_pop=P)``, the main path's launch) walks
    the plain version's order: every output equal, the rays Morton-sorted
    or not; and K2's t and valid; one K4 launch a call."""
    sc = mesh_scene
    args = [x.to(sc.device) for x in _mesh_rays(n_rays, n_rays + 1)]
    got = _k4_once(CT.closest_hit, sc.bvh_nodes, sc.bvh_tris, *args,
                   multi_pop=multi_pop, tri_k=sc.bvh_tris_k, sort=sort)
    torch.cuda.synchronize()
    CT.raise_on_overflow(sc.device)
    plain = TR.bvh_ray_intersect_plain(sc.bvh_nodes, sc.bvh_tris, *args,
                                       multi_pop=multi_pop)
    _assert_equal_hits(got, plain)
    k2 = CT.closest_hit(sc.bvh_nodes, sc.bvh_tris, *args)
    assert torch.equal(got[0], k2[0])
    assert torch.equal(got[1] >= 0, k2[1] >= 0)


def _k4_steps():
    return [(name, p) for name in sorted(CT.K4_STEPS) for p in CT.K4_WIDTHS]


@pytest.mark.parametrize("step,multi_pop", _k4_steps())
@pytest.mark.parametrize("n_shared", [0, None])
@pytest.mark.parametrize("n_rays", [129, 2 ** 18])
def test_k4_steps_equal_plain(mesh_scene, n_rays, n_shared, step,
                              multi_pop):
    """Every K4 design step with no record and with the whole tree (the
    block's budget) in shared memory, on more rays than the card holds at
    once: bit for bit the plain version's hits, one launch a call."""
    sc = mesh_scene
    sched = CT.K4_STEPS[step]
    args = [x.to(sc.device) for x in _mesh_rays(n_rays, n_rays + 2)]
    if n_shared is None:
        n_shared = CT.shared_records(sc.bvh_nodes.shape[0],
                                     CT.shared_budget(sc.device))
        assert n_shared == sc.bvh_nodes.shape[0]
    got = _k4_once(CT.launch_closest_mp, sc.bvh_nodes,
                   CT.kernel_tris(sc.bvh_tris, sched.layout), *args,
                   multi_pop, sched, n_shared)
    torch.cuda.synchronize()
    CT.raise_on_overflow(sc.device)
    _assert_equal_hits(got, TR.bvh_ray_intersect_plain(
        sc.bvh_nodes, sc.bvh_tris, *args, multi_pop=multi_pop))


@pytest.mark.parametrize("multi_pop", [2, 4])
@pytest.mark.parametrize("serial", [0, 2 ** 20])
def test_k4_leaf_phase_either_way(mesh_scene, serial, multi_pop):
    """K4's leaves tested always warp-wide and always lane by lane give
    the plain version's hits, on the mesh's rays and on coincident
    triangles."""
    from dataclasses import replace
    sched = replace(CT.K4_SCHEDULE, serial=serial)
    _, nodes, rows, soup = _dup_soup(1500, 20000, 13, mesh_scene.device)
    mesh = [x.to(mesh_scene.device) for x in _mesh_rays(20000, 4)]
    for nodes, rows, args in ((nodes, rows, soup),
                              (mesh_scene.bvh_nodes, mesh_scene.bvh_tris,
                               mesh)):
        got = CT.launch_closest_mp(nodes, CT.kernel_tris(rows, sched.layout),
                                   *args, multi_pop, sched)
        _assert_equal_hits(got, TR.bvh_ray_intersect_plain(
            nodes, rows, *args, multi_pop=multi_pop))


@pytest.mark.parametrize("step,multi_pop", _k4_steps())
def test_k4_on_ties_and_full_leaves(mesh_scene, step, multi_pop):
    """Coincident triangles (every triangle twice, the copies in one leaf
    or across leaves) and leaves of 32: K4's warp reduction keeps the
    plain version's slot, u and v exactly, and K2's t and valid."""
    sched = CT.K4_STEPS[step]
    _, nodes, rows, args = _dup_soup(1500, 20000, 11, mesh_scene.device)
    assert bool((mesh_scene.bvh.c4_cnt == 32).any())
    scenes = [(nodes, rows, args),
              (mesh_scene.bvh_nodes, mesh_scene.bvh_tris,
               [x.to(mesh_scene.device) for x in _mesh_rays(20000, 3)])]
    for nodes, rows, args in scenes:
        got = CT.launch_closest_mp(nodes, CT.kernel_tris(rows, sched.layout),
                                   *args, multi_pop, sched)
        _assert_equal_hits(got, TR.bvh_ray_intersect_plain(
            nodes, rows, *args, multi_pop=multi_pop))
        k2 = CT.launch_closest(nodes, CT.kernel_tris(rows), *args)
        assert torch.equal(got[0], k2[0])
        assert torch.equal(got[1] >= 0, k2[1] >= 0)
    assert (got[1] >= 0).any()


@pytest.mark.parametrize("multi_pop", [2, 4])
def test_k4_overflow_is_flagged(mesh_scene, monkeypatch, multi_pop):
    """A stack too small for the tree sets K4's device flag, and
    raise_on_overflow raises once and clears it."""
    sc = mesh_scene
    args = [x.to(sc.device) for x in _mesh_rays(1024, 5)]
    monkeypatch.setattr(TR, "STACK_SIZE", 2)
    CT.closest_hit(sc.bvh_nodes, sc.bvh_tris, *args, multi_pop=multi_pop)
    with pytest.raises(TR.StackOverflow):
        CT.raise_on_overflow(sc.device)
    CT.raise_on_overflow(sc.device)


def test_k4_rejects_other_widths(mesh_scene):
    sc = mesh_scene
    args = [x.to(sc.device) for x in _mesh_rays(64, 6)]
    for width in (0, 1, 3, 8):
        with pytest.raises(ValueError):
            CT.launch_closest_mp(sc.bvh_nodes, sc.bvh_tris_k, *args, width)
    with pytest.raises(ValueError):
        CT.closest_hit(sc.bvh_nodes, sc.bvh_tris, *args, multi_pop=3)


@pytest.mark.parametrize("multi_pop", [2, 4])
def test_k4_render_cuda_matches_cpu(mesh_scene, multi_pop):
    """``render(..., integrator={"multi_pop": P})`` reaches K4 (max_depth
    launches, K2 none) and renders as the plain K4 does on the CPU."""
    d = cornell_box_mesh(res=16, spp=2, max_depth=4, subdiv=46)
    mp = {"multi_pop": multi_pop}
    before = dict(CT.launches)
    img_c = mt.render(mt.load_dict(d, device="cuda"), spp=2, seed=0,
                      integrator=mp)
    assert (CT.launches["bvh4_closest_hit_mp"]
            == before["bvh4_closest_hit_mp"] + 4)
    assert CT.launches["bvh4_closest_hit"] == before["bvh4_closest_hit"]
    img_h = mt.render(mt.load_dict(d, device="cpu"), spp=2, seed=0,
                      device="cpu", integrator=mp)
    diff = (img_c.cpu() - img_h).abs()
    assert float(diff.mean()) <= 1e-3 * float(img_h.mean())
    assert float((diff.amax(-1) <= 1e-3).float().mean()) >= 0.99


_PLAIN = {}


def _plain_hits(sc, n_rays):
    """The plain K2/K3 on ``n_rays`` mesh rays (cached per count)."""
    key = (id(sc), n_rays)
    if key not in _PLAIN:
        args = [x.to(sc.device) for x in _mesh_rays(n_rays, n_rays + 7)]
        _PLAIN[key] = (args, (*TR.bvh_ray_intersect_plain(
            sc.bvh_nodes, sc.bvh_tris, *args), TR.bvh_ray_test_plain(
            sc.bvh_nodes, sc.bvh_tris, *args)))
    return _PLAIN[key]


def _assert_equal_hits(got, ref):
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("step", sorted(CT.STEPS))
@pytest.mark.parametrize("n_shared", [0, 64, None])
@pytest.mark.parametrize("n_rays", [1, 129, 4133, 2 ** 18])
def test_warp_kernels_equal_plain(mesh_scene, n_rays, n_shared, step):
    """The warp-cooperative K2/K3 of every design step equal the plain
    versions bit for bit with 0, 64 and all records in shared memory, on
    more rays than the card holds at once (warps take several batches)."""
    sc = mesh_scene
    args, ref = _plain_hits(sc, n_rays)
    sched = CT.STEPS[step]
    tri_k = CT.kernel_tris(sc.bvh_tris, sched.layout)
    if n_shared is None:
        n_shared = sc.bvh_nodes.shape[0]
    before = dict(CT.launches)
    got = CT.launch_closest(sc.bvh_nodes, tri_k, *args, sched, n_shared)
    occ = CT.launch_any(sc.bvh_nodes, tri_k, *args, sched, n_shared)
    torch.cuda.synchronize()
    CT.raise_on_overflow(sc.device)
    assert CT.launches["bvh4_closest_hit"] == before["bvh4_closest_hit"] + 1
    assert CT.launches["bvh4_any_hit"] == before["bvh4_any_hit"] + 1
    _assert_equal_hits((*got, occ), ref)


@pytest.mark.parametrize("n_rays", [1, 129, 4133, 65536])
def test_reference_equals_plain(mesh_scene, n_rays):
    """K2's former walk (K4's kernel at P = 1) equals the plain K2."""
    sc = mesh_scene
    args, ref = _plain_hits(sc, n_rays)
    before = dict(CT.launches)
    got = CT.closest_hit_reference(sc.bvh_nodes, sc.bvh_tris, *args)
    torch.cuda.synchronize()
    CT.raise_on_overflow(sc.device)
    assert (CT.launches["bvh4_closest_hit_ref"]
            == before["bvh4_closest_hit_ref"] + 1)
    _assert_equal_hits(got, ref[:4])


def _dup_soup(n_tris, n_rays, seed, device):
    """Random triangles, each twice (coincident pairs), in a BVH."""
    from epsm_mitsuba3_torch.ops import bvh as BT
    tri, o, d, maxt = _soup(n_tris, n_rays, seed)
    verts = torch.cat([tri[:, 0:3], tri[:, 0:3] + tri[:, 3:6],
                       tri[:, 0:3] + tri[:, 6:9]], 1).reshape(-1, 3)
    faces = torch.arange(3 * n_tris, dtype=torch.int32).reshape(-1, 3)
    faces = torch.cat([faces, faces])
    bvh = BT.build(verts, faces, device=device)
    nodes, rows, _ = CT.pack_bvh4(bvh, verts.to(device), faces.to(device))
    return bvh, nodes, rows, [x.to(device) for x in (o, d, maxt)]


@pytest.mark.parametrize("step", sorted(CT.STEPS))
def test_warp_kernels_on_ties_and_full_leaves(mesh_scene, step):
    """Coincident triangles (every triangle twice) and leaves of 32: the
    warp reduction keeps the plain version's slot, u and v exactly."""
    sched = CT.STEPS[step]
    bvh, nodes, rows, args = _dup_soup(1500, 20000, 11, mesh_scene.device)
    assert bool((mesh_scene.bvh.c4_cnt == 32).any())
    scenes = [(nodes, rows, args),
              (mesh_scene.bvh_nodes, mesh_scene.bvh_tris,
               [x.to(mesh_scene.device) for x in _mesh_rays(20000, 3)])]
    for nodes, rows, args in scenes:
        tri_k = CT.kernel_tris(rows, sched.layout)
        got = (*CT.launch_closest(nodes, tri_k, *args, sched),
               CT.launch_any(nodes, tri_k, *args, sched))
        ref = (*TR.bvh_ray_intersect_plain(nodes, rows, *args),
               TR.bvh_ray_test_plain(nodes, rows, *args))
        _assert_equal_hits(got, ref)
    hits = ref[1] >= 0
    assert hits.any()


@pytest.mark.parametrize("serial", [0, 2 ** 20])
def test_leaf_phase_either_way(mesh_scene, serial):
    """Leaves tested always warp-wide and always lane by lane give the
    plain version's hits, on scattered rays and on coincident triangles."""
    from dataclasses import replace
    sched = replace(CT.SCHEDULE, serial=serial)
    _, nodes, rows, soup = _dup_soup(1500, 20000, 12, mesh_scene.device)
    args, ref = _plain_hits(mesh_scene, 2 ** 18)
    for nodes, rows, args, ref in (
            (nodes, rows, soup, None),
            (mesh_scene.bvh_nodes, mesh_scene.bvh_tris, args, ref)):
        if ref is None:
            ref = (*TR.bvh_ray_intersect_plain(nodes, rows, *args),
                   TR.bvh_ray_test_plain(nodes, rows, *args))
        tri_k = CT.kernel_tris(rows, sched.layout)
        _assert_equal_hits((*CT.launch_closest(nodes, tri_k, *args, sched),
                            CT.launch_any(nodes, tri_k, *args, sched)), ref)


def test_lane_counts(mesh_scene):
    """The counting builds return the same hits and lane utilisations in
    (0, 1]."""
    sc = mesh_scene
    args, ref = _plain_hits(sc, 4133)
    for name, fn in (
            ("warp", lambda c: CT.launch_closest(
                sc.bvh_nodes, sc.bvh_tris_k, *args, counts=c)),
            ("K4 P=2", lambda c: CT.launch_closest_mp(
                sc.bvh_nodes, sc.bvh_tris_k, *args, 2, counts=c)),
            ("K4 P=4", lambda c: CT.launch_closest_mp(
                sc.bvh_nodes, sc.bvh_tris_k, *args, 4, counts=c)),
            ("reference", lambda c: CT.closest_hit_reference(
                sc.bvh_nodes, sc.bvh_tris, *args, counts=c))):
        counts = torch.zeros(4, dtype=torch.int64, device=sc.device)
        got = fn(counts)
        if name.startswith("K4"):
            ref_k4 = TR.bvh_ray_intersect_plain(
                sc.bvh_nodes, sc.bvh_tris, *args, multi_pop=int(name[-1]))
            _assert_equal_hits(got, ref_k4)
        else:
            _assert_equal_hits(got, ref[:4])
        steps, active, leaf_steps, leaf_active = counts.tolist()
        assert 0 < active <= 32 * steps, name
        assert 0 < leaf_active <= 32 * leaf_steps, name


@pytest.mark.parametrize("scene_fn", [cornell_box, cornell_box_mesh])
def test_grad_cuda_matches_cpu(cuda, scene_fn):
    """The PRB gradient of reflectance, radiance and vertices on the card
    equals the CPU's to 1e-3 relative (L2): vertex gradients are
    scatter-adds with float atomics on the card."""
    kw = dict(res=16, spp=2, max_depth=4)
    if scene_fn is cornell_box_mesh:
        kw["subdiv"] = 46
    grads = []
    for dev in (cuda, torch.device("cpu")):
        sc = mt.load_dict(scene_fn(**kw), device=dev)
        lv = {k: v.clone().requires_grad_(True)
              for k, v in sc.leaves().items()
              if k in ("vertices", "normals", "bsdfs.reflectance",
                       "emitters.radiance")}
        img = mt.render(sc.with_leaves(lv), spp=2, seed=0, device=dev)
        grads.append(torch.autograd.grad((img ** 2).mean(),
                                         list(lv.values())))
    for a, b in zip(*grads):
        assert torch.isfinite(a).all()
        assert float((a.cpu() - b).norm()) <= 1e-3 * float(b.norm()) + 1e-12


@pytest.mark.parametrize("kind", ["depth", "aov", "moment", "ptracer",
                                  "spectral", "spectral_mono",
                                  "spectral_spec"])
def test_output_types_cuda_match_cpu(cuda, kind):
    """The new outputs at 16^2 x 2 spp on the card against the CPU: images
    within 1e-3 of the mean on average (the particle tracer's film within
    1e-5 of its largest entry: its scatter-add sums in another order)."""
    imgs = []
    for dev in (cuda, torch.device("cpu")):
        sc = mt.load_dict(cornell_box(res=16, spp=2, max_depth=3), device=dev)
        imgs.append(mt.render(sc, spp=2, seed=1, device=dev,
                              integrator={"type": kind, "max_depth": 3}
                              ).cpu())
    a, b = imgs
    assert a.shape == b.shape and bool(torch.isfinite(a).all())
    if kind == "ptracer":
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    else:
        assert float((a - b).abs().mean()) <= 1e-3 * float(b.abs().mean())


# -- the loader and plugin slice: the numpy-built tree, analytic spheres
# and the double variant on the card ------------------------------------------

@pytest.fixture(scope="module")
def numpy_tree_scene(mesh_scene):
    from epsm_mitsuba3_torch.ops import bvh as BT
    return mesh_scene.with_bvh(BT.build(mesh_scene.vertices,
                                        mesh_scene.faces, builder="numpy"))


@pytest.mark.parametrize("n_rays", [129, 4133, 2 ** 18])
def test_k2_k3_on_numpy_tree_equal_plain(numpy_tree_scene, n_rays):
    """K2/K3 walking the median-split tree equal their plain versions on
    it bit for bit, one launch each."""
    sc = numpy_tree_scene
    args, ref = _plain_hits(sc, n_rays)
    before = dict(CT.launches)
    hit = CT.closest_hit(sc.bvh_nodes, sc.bvh_tris, *args,
                         tri_k=sc.bvh_tris_k)
    occ = CT.any_hit(sc.bvh_nodes, sc.bvh_tris, *args, tri_k=sc.bvh_tris_k)
    torch.cuda.synchronize()
    CT.raise_on_overflow(sc.device)
    assert CT.launches["bvh4_closest_hit"] == before["bvh4_closest_hit"] + 1
    assert CT.launches["bvh4_any_hit"] == before["bvh4_any_hit"] + 1
    _assert_equal_hits((*hit, occ), ref)


def _sphere_only_dict(res=16):
    T = mt.ScalarTransform4f
    return {"type": "scene",
            "sensor": {"type": "perspective", "fov": 45,
                       "to_world": T.look_at(origin=[0, 0, 3],
                                             target=[0, 0, 0], up=[0, 1, 0]),
                       "film": {"type": "hdrfilm", "width": res,
                                "height": res}},
            "light": {"type": "constant", "radiance": 1.0},
            "ball": {"type": "sphere", "radius": 1.0, "analytic": True}}


def test_sphere_only_scene_launches_no_k1(cuda):
    """A scene without triangles: no kernel is launched on zero rows, and
    the image is the CPU's."""
    before = dict(CI.launches)
    imgs = [mt.render(mt.load_dict(_sphere_only_dict(), device=dev), spp=2,
                      seed=0, device=dev).cpu()
            for dev in (cuda, torch.device("cpu"))]
    torch.cuda.synchronize()
    assert CI.launches == before
    a, b = imgs
    assert bool(torch.isfinite(a).all())
    assert float((a - b).abs().mean()) <= 1e-3 * float(b.abs().mean())


def test_double_box_launches_equal_float32(cuda):
    """The box under the double variant: K1 takes the same float32 rays
    as many times as under float32, and the float64 image agrees."""
    imgs, counts = [], []
    try:
        for name in ("cuda_ad_rgb", "cuda_ad_rgb_double"):
            mt.set_variant(name)
            sc = mt.load_dict(cornell_box(res=32, spp=4, max_depth=3),
                              device=cuda)
            before = dict(CI.launches)
            imgs.append(mt.render(sc, spp=4, seed=0, device=cuda))
            torch.cuda.synchronize()
            counts.append({k: CI.launches[k] - before[k] for k in before})
    finally:
        mt.set_variant("cuda_ad_rgb")
    assert counts[0] == counts[1] and counts[0]["mt_closest_hit"] == 3
    a, b = imgs
    assert b.dtype == torch.float64 and a.dtype == torch.float32
    assert float((b - a).abs().mean()) <= 2e-3 * float(a.mean())


# -- the polarized slice: the stokes integrator through K1, K2 and K3 -----------

def _plate(d):
    """``d`` with a linear polarizer plate in front of the back wall and a
    conductor right wall."""
    d["plate"] = {"type": "rectangle",
                  "to_world": mt.ScalarTransform4f.translate(
                      [0.0, 1.0, 0.2]).scale(0.5),
                  "bsdf": {"type": "polarizer", "theta": 30.0}}
    d["right"]["bsdf"] = {"type": "conductor",
                          "eta": {"type": "rgb", "value": [0.2, 0.9, 1.1]},
                          "k": {"type": "rgb", "value": [3.0, 2.5, 2.2]}}
    return d


@pytest.mark.parametrize("mesh", [False, True])
def test_stokes_cuda_matches_plain(cuda, mesh):
    """``stokes`` at 16^2 x 2 spp, depth 3, through K1 on the box and K2/K3
    on the mesh (each entry 3 launches, the other kernel none), against
    the plain versions on the CPU: within 1e-3 of the mean on average."""
    d = _plate(cornell_box_mesh(res=16, spp=2, max_depth=3, subdiv=46)
               if mesh else cornell_box(res=16, spp=2, max_depth=3))
    integ = {"type": "stokes", "max_depth": 3}
    before = {**CI.launches, **CT.launches}
    img_c = mt.render(mt.load_dict(d, device=cuda), spp=2, seed=0,
                      integrator=integ)
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in {**CI.launches,
                                            **CT.launches}.items()}
    k_hit, k_any = (("bvh4_closest_hit", "bvh4_any_hit") if mesh
                    else ("mt_closest_hit", "mt_any_hit"))
    assert counts[k_hit] == 3 and counts[k_any] == 3
    assert sum(counts.values()) == 6
    img_h = mt.render(mt.load_dict(d, device="cpu"), spp=2, seed=0,
                      device="cpu", integrator=integ)
    assert img_c.shape == (16, 16, 15) and bool(torch.isfinite(img_c).all())
    assert float((img_c.cpu() - img_h).abs().mean()) <= 1e-3 * float(
        img_h.abs().mean())
