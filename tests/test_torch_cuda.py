"""Kernels K1, K2, K3 and K4 on the card against their plain versions, at
small and ragged shapes, and a fwd+bwd gradient on the card against the
CPU's.  These tests need CUDA and nvcc; without a card they skip.

Run them on a GPU machine (the suite's conftest imports JAX, which the
port does not need):

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \\
        tests/test_torch_cuda.py -q
"""
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


@pytest.mark.parametrize("n_tris,n_rays", [
    (1, 1), (12, 37), (255, 4133), (257, 4133), (600, 1000), (4096, 700)])
def test_k1_kernel_equals_plain(cuda, n_tris, n_rays):
    """Built with --fmad=false in the plain version's operation order:
    hits, indices and t/u/v equal the plain version on the same card."""
    args_cpu = _soup(n_tris, n_rays, n_tris)
    args = [x.to(cuda) for x in args_cpu]
    before = dict(CI.launches)
    t, prim, u, v = CI.closest_hit(*args)
    occ = CI.any_hit(*args)
    torch.cuda.synchronize()
    assert CI.launches["mt_closest_hit"] == before["mt_closest_hit"] + 1
    assert CI.launches["mt_any_hit"] == before["mt_any_hit"] + 1
    t_p, prim_p, u_p, v_p = I.ray_intersect_brute(*args)
    assert torch.equal(prim, prim_p)
    assert torch.equal(occ, prim_p >= 0)
    assert torch.equal(occ, I.ray_test_brute(*args))
    for a, b in ((t, t_p), (u, u_p), (v, v_p)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    # and the CPU plain version agrees on the hits
    t_c, prim_c, _, _ = CI.closest_hit(*args_cpu)
    assert (prim.cpu() == prim_c).float().mean() >= 0.9999


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


@pytest.mark.parametrize("multi_pop", [2, 4])
@pytest.mark.parametrize("n_rays", [1, 129, 4133, 65536])
def test_k4_kernel_equals_plain(mesh_scene, n_rays, multi_pop):
    """K4 walks the plain version's order: every output equal; and K2's
    t and valid."""
    sc = mesh_scene
    args = [x.to(sc.device) for x in _mesh_rays(n_rays, n_rays + 1)]
    before = dict(CT.launches)
    got = CT.closest_hit(sc.bvh_nodes, sc.bvh_tris, *args,
                         multi_pop=multi_pop)
    torch.cuda.synchronize()
    CT.raise_on_overflow(sc.device)
    assert (CT.launches["bvh4_closest_hit_mp"]
            == before["bvh4_closest_hit_mp"] + 1)
    assert CT.launches["bvh4_closest_hit"] == before["bvh4_closest_hit"]
    plain = TR.bvh_ray_intersect_plain(sc.bvh_nodes, sc.bvh_tris, *args,
                                       multi_pop=multi_pop)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    k2 = CT.closest_hit(sc.bvh_nodes, sc.bvh_tris, *args)
    assert torch.equal(got[0], k2[0])
    assert torch.equal(got[1] >= 0, k2[1] >= 0)


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
            ("reference", lambda c: CT.closest_hit_reference(
                sc.bvh_nodes, sc.bvh_tris, *args, counts=c))):
        counts = torch.zeros(4, dtype=torch.int64, device=sc.device)
        got = fn(counts)
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
