"""The port's BVH scene path against the JAX package: the tree, its
refit, the packed BVH4 records, the Morton keys, the plain versions of
kernels K2/K3, and a render of ``cornell_box_mesh``.

Tolerances, each with its reason:

- the tree, its refit, the packed records and the keys are integer or
  min/max data: equal element for element;
- the plain K2/K3 against K1's plain brute force (the same PyTorch
  arithmetic): ``valid`` and ``occ`` equal, ``prim`` on >= 99.9 % of lanes
  (an exact tie of two triangles may resolve either way), t, u, v within
  1e-5 where ``prim`` agrees;
- against the JAX traversal and the interpret-mode Pallas kernels: the
  same, away from grazing hits (``_grazing``), and u, v within
  ``UV_ATOL_XLA``: XLA contracts multiply-adds into FMAs and PyTorch does
  not (``ROADMAP.md`` §3), and the barycentrics of a small triangle seen
  from afar magnify that rounding by distance over edge length;
- the render: ``assert_images_close`` of ``test_torch_render.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.models.records import Ray as RayJ
from epsm_mitsuba3_tpu.ops import bvh as BJ
from epsm_mitsuba3_tpu.ops import pallas_traverse as PTJ
from epsm_mitsuba3_tpu.ops import traverse as TJ
from scenes import cornell_box_mesh as cornell_box_mesh_jax

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.integrators import common as common_t
from epsm_mitsuba3_torch.models import samplers as smp_t
from epsm_mitsuba3_torch.models.scene import GEOMETRY_FIELDS
from epsm_mitsuba3_torch.ops import accel
from epsm_mitsuba3_torch.ops import bvh as BT
from epsm_mitsuba3_torch.ops import cuda_intersect as CI
from epsm_mitsuba3_torch.ops import cuda_traverse as CT
from epsm_mitsuba3_torch.ops import intersect as IT
from epsm_mitsuba3_torch.ops import traverse as TT
from epsm_mitsuba3_torch.scenes import bumpy_sphere, cornell_box_mesh

from test_torch_render import assert_images_close, jax_arrays, port_scene_of
from torch_threads import one_torch_thread  # noqa: F401

SUBDIV = 46            # cornell_box_mesh at 4,244 triangles
ATOL = 1e-5
#: u, v against an XLA reference: measured 1.2e-5 on a triangle of edge
#: ~0.05 hit from a distance of 2.4 at |cos| = 0.31
UV_ATOL_XLA = 3e-5


class _GeomOnly:
    """What the JAX traversal reads of a scene."""

    def __init__(self, v, f, bvh):
        self.vertices = jnp.asarray(v)
        self.faces = jnp.asarray(f)
        self.bvh = bvh


@pytest.fixture(scope="module")
def mesh_scene():
    """cornell_box_mesh loaded by the port on the CPU (it builds its own
    BVH), with the packed triangles of K1 beside it."""
    sc = mt.load_dict(cornell_box_mesh(res=16, spp=1, subdiv=SUBDIV),
                      device="cpu")
    return sc, CI.pack_tris(sc.vertices, sc.faces)


def _camera_rays(sc, spp=4):
    sensor = sc.sensors[0]
    n = sensor.width * sensor.height * spp
    sampler = smp_t.seed(0, n, device="cpu")
    _, ray, _, _ = common_t.sample_rays(sensor, sampler, spp)
    maxt = torch.full((n,), float("inf"))
    maxt[::10] = 0.0                      # dead lanes
    return ray.o.contiguous(), ray.d.contiguous(), maxt


def _random_rays(n, seed):
    """Rays from inside the box in every direction: finite and infinite
    extents, and dead lanes."""
    r = np.random.default_rng(seed)
    o = r.uniform(-0.95, 0.95, (n, 3)).astype(np.float32)
    o[:, 1] += 1.0
    d = r.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    maxt = np.where(r.random(n) < 0.3, r.uniform(0.1, 2.0, n),
                    np.inf).astype(np.float32)
    maxt[r.random(n) < 0.1] = 0.0
    return torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(maxt)


def _rays(kind, sc):
    return _camera_rays(sc) if kind == "camera" else _random_rays(2048, 3)


def _grazing(tri, slot, d):
    """Hits at |cos| < 0.05 between ray and triangle (``tri`` rows
    [p0, e1, e2]); there 1/|det| magnifies one rounding difference."""
    w = tri[np.maximum(slot, 0)]
    nrm = np.cross(w[:, 3:6], w[:, 6:9])
    cos = np.abs((nrm * d).sum(-1)) / np.maximum(
        np.linalg.norm(nrm, axis=-1), 1e-30)
    return (slot >= 0) & (cos < 0.05)


def _assert_hits_close(t, prim, u, v, t_r, prim_r, u_r, v_r, skip=None,
                       uv_atol=ATOL):
    """``valid`` equal; ``prim`` on >= 99.9 % of lanes; t within ATOL and
    u, v within ``uv_atol`` where ``prim`` agrees (and the lane is not in
    ``skip``)."""
    t, prim, u, v, t_r, prim_r, u_r, v_r = (
        np.asarray(x) for x in (t, prim, u, v, t_r, prim_r, u_r, v_r))
    np.testing.assert_array_equal(prim >= 0, prim_r >= 0)
    hit = prim_r >= 0
    assert hit.sum() > 100
    same = prim == prim_r
    assert same[hit].mean() >= 0.999, same[hit].mean()
    ok = same & hit & (True if skip is None else ~skip)
    assert ok.sum() >= 0.97 * hit.sum()
    np.testing.assert_allclose(t[ok], t_r[ok], atol=ATOL, rtol=0)
    for a, b in ((u, u_r), (v, v_r)):
        np.testing.assert_allclose(a[ok], b[ok], atol=uv_atol, rtol=0)
    assert np.isinf(t[~hit]).all()
    assert (u[~hit] == 0).all() and (v[~hit] == 0).all()


def _port_hits(sc, o, d, maxt, sort=False):
    t, slot, u, v = CT.closest_hit(sc.bvh_nodes, sc.bvh_tris, o, d, maxt,
                                   sort=sort)
    prim = torch.where(slot >= 0, sc.bvh.order[slot.clamp(min=0).long()],
                       -1)
    occ = CT.any_hit(sc.bvh_nodes, sc.bvh_tris, o, d, maxt, sort=sort)
    return t, prim, u, v, occ


# -- the tree -----------------------------------------------------------------

def test_build_equals_jax():
    """The port's g++ build of native/bvh.cpp gives the JAX package's
    tree element for element."""
    V, F = bumpy_sphere(subdiv=SUBDIV)
    bt = BT.build(V, F)
    bj = BJ.build(V, F)
    for k in BT.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(bt, k).numpy(),
                                      np.asarray(getattr(bj, k)), k)
    assert bt.n_levels == bj.n_levels
    assert bt.c4_cnt.max() <= BT.MAX_LEAF4


def test_build_never_loads_the_committed_library():
    """The builder is compiled from source into the port's _build/."""
    BT.build(*bumpy_sphere(subdiv=8))
    assert BT.SPEC.path.parent == BT._native.BUILD_DIR
    assert BT.SPEC.path.exists()
    assert "libepsm_native" not in BT._lib._name


@pytest.mark.parametrize("fault", ["source", "compiler"])
def test_failed_build_raises(fault, tmp_path, monkeypatch):
    """A build that fails, or a compiler that is missing, raises: nothing
    falls back to another builder."""
    src = tmp_path / "broken.cpp"
    src.write_text("int f( {" if fault == "source" else "int f() { return 0; }")
    spec = BT._native.Spec(
        name="broken", source=src, flags=BT._native.GXX_FLAGS,
        compiler="g++" if fault == "source" else "no-such-compiler")
    monkeypatch.setattr(BT._native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed|not found"):
        BT._native.load(spec)
    assert not spec.path.exists()


def test_refit_equals_jax():
    V, F = bumpy_sphere(subdiv=SUBDIV)
    bt = BT.build(V, F)
    bj = BJ.build(V, F)
    V2 = V + np.random.default_rng(0).normal(0, 0.05, V.shape).astype(
        np.float32)
    rj = BJ.refit(bj, jnp.asarray(V2), jnp.asarray(F))
    rt = BT.refit(bt, torch.from_numpy(V2), torch.from_numpy(F))
    np.testing.assert_array_equal(rt.bmin.numpy(), np.asarray(rj.bmin))
    np.testing.assert_array_equal(rt.bmax.numpy(), np.asarray(rj.bmax))
    assert not np.array_equal(rt.bmin.numpy(), bt.bmin.numpy())


def test_pack_bvh4_equals_pack_scene():
    V, F = bumpy_sphere(subdiv=SUBDIV)
    bj = BJ.build(V, F)
    bt = BT.build(V, F)
    nodes, tri, _ = CT.pack_bvh4(bt, torch.from_numpy(V),
                                 torch.from_numpy(F))
    nodes3, _ = PTJ.pack_scene(bj, jnp.asarray(V), jnp.asarray(F))
    n4 = bt.c4_id.shape[0]
    ref = np.asarray(nodes3).transpose(0, 2, 1).reshape(-1, 32)[:n4]
    np.testing.assert_array_equal(nodes.numpy(), ref)
    p = V[F]
    rows = np.concatenate([p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]],
                          -1)[np.asarray(bj.order)]
    np.testing.assert_array_equal(tri.numpy(), rows)


def test_sort_keys_equal_jax(mesh_scene):
    sc, _ = mesh_scene
    o, d, maxt = _random_rays(4096, 5)
    bmin, bmax = sc.bvh.bmin[0], sc.bvh.bmax[0]
    kt = CT.sort_keys(o, d, bmin, bmax, maxt)
    kj = PTJ.sort_keys(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                       jnp.asarray(bmin.numpy()), jnp.asarray(bmax.numpy()),
                       jnp.asarray(maxt.numpy()))
    np.testing.assert_array_equal(kt.numpy(),
                                  np.asarray(kj).astype(np.int64))
    assert len(np.unique(kt.numpy())) > 1000


# -- the plain versions of K2 and K3 --------------------------------------------

@pytest.mark.parametrize("kind", ["camera", "random"])
def test_plain_matches_brute_force(mesh_scene, kind):
    sc, tri = mesh_scene
    o, d, maxt = _rays(kind, sc)
    t, prim, u, v, occ = _port_hits(sc, o, d, maxt)
    ref = IT.ray_intersect_brute(tri, o, d, maxt)
    _assert_hits_close(t, prim, u, v, *ref)
    np.testing.assert_array_equal(occ.numpy(),
                                  IT.ray_test_brute(tri, o, d, maxt).numpy())
    np.testing.assert_array_equal(occ.numpy(), (prim >= 0).numpy())


@pytest.mark.parametrize("kind", ["camera", "random"])
def test_sort_leaves_hits_unchanged(mesh_scene, kind):
    """Morton-sorting the rays around the traversal changes no result."""
    sc, _ = mesh_scene
    o, d, maxt = _rays(kind, sc)
    for a, b in zip(_port_hits(sc, o, d, maxt, sort=False),
                    _port_hits(sc, o, d, maxt, sort=True)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["camera", "random"])
def test_plain_matches_jax_traversal(mesh_scene, kind):
    """Against ``ops/traverse.py`` bvh_ray_intersect / bvh_ray_test, on
    the JAX package's own tree of the same mesh."""
    sc, tri = mesh_scene
    o, d, maxt = _rays(kind, sc)
    scene_j = _GeomOnly(sc.vertices.numpy(), sc.faces.numpy(),
                        BJ.build(sc.vertices.numpy(), sc.faces.numpy()))
    ray = RayJ.make(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                    jnp.asarray(maxt.numpy()))
    pi = TJ.bvh_ray_intersect(scene_j, ray)
    prim_j = np.where(pi.valid, pi.prim_index, -1)
    t, prim, u, v, occ = _port_hits(sc, o, d, maxt)
    skip = _grazing(tri.numpy(), prim.numpy(), d.numpy())
    _assert_hits_close(t, prim, u, v, pi.t, prim_j, pi.prim_uv[:, 0],
                       pi.prim_uv[:, 1], skip, UV_ATOL_XLA)
    np.testing.assert_array_equal(occ.numpy(),
                                  np.asarray(TJ.bvh_ray_test(scene_j, ray)))


def test_plain_matches_pallas_kernels_interpreted():
    """K2 and K3 of the JAX package themselves (``_traverse_kernel``,
    ``_anyhit_kernel``), run in interpret mode: 1,058 triangles, 1,024
    rays aimed at the mesh."""
    V, F = bumpy_sphere(subdiv=23)
    r = np.random.default_rng(7)
    n = 1024
    o = r.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    o[:, 2] = 2.0
    target = r.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    target[:, 1] += 0.7
    d = target - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    maxt = np.where(r.random(n) < 0.3, r.uniform(1.0, 3.0, n),
                    np.inf).astype(np.float32)
    maxt[r.random(n) < 0.1] = 0.0
    bj = BJ.build(V, F)
    ray = RayJ.make(jnp.asarray(o), jnp.asarray(d), jnp.asarray(maxt))
    scene_j = _GeomOnly(V, F, bj)
    pi = PTJ.bvh_ray_intersect_pallas(scene_j, ray, block_sub=8)
    occ_j = PTJ.bvh_ray_test_pallas(scene_j, ray, block_sub=8)

    bt = BT.from_arrays({k: np.asarray(getattr(bj, k))
                         for k in BT.ARRAY_FIELDS}, "cpu")
    nodes, tri, _ = CT.pack_bvh4(bt, torch.from_numpy(V),
                                 torch.from_numpy(F))
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(maxt))
    t, slot, u, v = CT.closest_hit(nodes, tri, *args)
    prim = torch.where(slot >= 0, bt.order[slot.clamp(min=0).long()], -1)
    prim_j = np.where(pi.valid, pi.prim_index, -1)
    skip = _grazing(tri.numpy(), slot.numpy(), d)
    _assert_hits_close(t, prim, u, v, pi.t, prim_j, pi.prim_uv[:, 0],
                       pi.prim_uv[:, 1], skip, UV_ATOL_XLA)
    occ = CT.any_hit(nodes, tri, *args)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_j))
    assert 0.2 < occ.float().mean() < 0.95


@pytest.mark.parametrize("entry", ["closest", "any"])
def test_stack_overflow_raises(mesh_scene, entry, monkeypatch):
    """A ray that needs more stack than there is raises, in the plain
    versions as in the kernels (there through ``raise_on_overflow``)."""
    sc, _ = mesh_scene
    o, d, maxt = _random_rays(256, 9)
    monkeypatch.setattr(TT, "STACK_SIZE", 2)
    fn = CT.closest_hit if entry == "closest" else CT.any_hit
    with pytest.raises(TT.StackOverflow):
        fn(sc.bvh_nodes, sc.bvh_tris, o, d, maxt)


def test_counts_are_the_work_done(mesh_scene):
    """The plain versions' counters: a dead lane does no work, a live
    lane pops the root, and the any hit does no more than the closest."""
    sc, _ = mesh_scene
    o, d, maxt = _random_rays(1024, 11)
    *_, pops, tests = TT.bvh_ray_intersect_plain(
        sc.bvh_nodes, sc.bvh_tris, o, d, maxt, counts=True)
    _, pops_a, tests_a = TT.bvh_ray_test_plain(
        sc.bvh_nodes, sc.bvh_tris, o, d, maxt, counts=True)
    dead = maxt <= 0
    assert (pops[dead] == 0).all() and (tests[dead] == 0).all()
    assert (pops_a[dead] == 0).all() and (tests_a[dead] == 0).all()
    assert (pops[~dead] >= 1).all()
    assert tests_a.sum() <= tests.sum() * 1.5
    assert tests[~dead].float().mean() > 4


@pytest.mark.parametrize("entry", ["closest", "any"])
def test_reads_are_what_the_rays_walk(mesh_scene, entry):
    """The plain versions' ``reads``: one ray reads each record it pops
    and each row it tests once, so its masks count its pops and tests;
    a batch's masks are the union of its rays' own, and a dead ray reads
    nothing."""
    sc, _ = mesh_scene
    o, d, maxt = _random_rays(24, 13)
    fn = (TT.bvh_ray_test_plain if entry == "any"
          else TT.bvh_ray_intersect_plain)
    *_, pops, tests, nodes_read, rows_read = fn(
        sc.bvh_nodes, sc.bvh_tris, o, d, maxt, counts=True, reads=True)
    union_nodes = torch.zeros_like(nodes_read)
    union_rows = torch.zeros_like(rows_read)
    for i in range(o.shape[0]):
        k = slice(i, i + 1)
        *_, p, t, nr, rr = fn(sc.bvh_nodes, sc.bvh_tris, o[k], d[k],
                              maxt[k], counts=True, reads=True)
        assert int(nr.sum()) == int(p[0]) == int(pops[i])
        assert int(rr.sum()) == int(t[0]) == int(tests[i])
        union_nodes |= nr
        union_rows |= rr
    assert torch.equal(nodes_read, union_nodes)
    assert torch.equal(rows_read, union_rows)
    assert rows_read.any() and not rows_read.all()
    *_, nr, rr = fn(sc.bvh_nodes, sc.bvh_tris, o, d, torch.zeros_like(maxt),
                    reads=True)
    assert not nr.any() and not rr.any()


# -- the slice as a whole -----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_mesh_scene():
    return mi.load_dict(cornell_box_mesh_jax(res=16, spp=1, max_depth=3,
                                             subdiv=SUBDIV))


def test_render_matches_jax(jax_mesh_scene):
    """The JAX scene, its BVH included, carried across: the port renders
    it on the CPU through the plain K2/K3 as the JAX package does."""
    sj = jax_mesh_scene
    assert sj.bvh is not None
    st = port_scene_of(sj)
    for k in BT.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(st.bvh, k).numpy(),
                                      np.asarray(getattr(sj.bvh, k)), k)
    before = dict(CI.launches), dict(CT.launches)
    img = mt.render(st, spp=1, seed=0, device="cpu").numpy()
    ref = np.asarray(mi.render(sj, spp=1, seed=0))
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert_images_close(img, ref)
    assert (dict(CI.launches), dict(CT.launches)) == before
    assert CT._lib is None          # no CUDA library was built or loaded


def test_load_dict_mesh_arrays_equal_jax(jax_mesh_scene):
    """The port's own loader builds the JAX loader's arrays and tree."""
    sj = jax_mesh_scene
    st = mt.load_dict(cornell_box_mesh(res=16, spp=1, max_depth=3,
                                       subdiv=SUBDIV), device="cpu")
    ref = jax_arrays(sj)
    for k in GEOMETRY_FIELDS:
        np.testing.assert_array_equal(getattr(st, k).numpy(), ref[k], k)
    for k in BT.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(st.bvh, k).numpy(),
                                      np.asarray(getattr(sj.bvh, k)), k)
    assert st.bvh_nodes.shape == (st.bvh.c4_id.shape[0], 32)


def _mesh_dict(base, T, **shape):
    """``base`` (a Cornell box dict) with its blob replaced by a small
    mesh carrying normals and uvs, placed by a transform made with ``T``
    (the ScalarTransform4f of one package or the other)."""
    V, F = bumpy_sphere(subdiv=6)
    d = dict(base)
    d["blob"] = dict(type="mesh", vertices=V, faces=F,
                     normals=V - V.mean(0), uvs=V[:, :2], **shape)
    d["blob"]["to_world"] = T.translate([0.1, 0.2, -0.3]).rotate(
        [0, 1, 1], 30).scale([1.0, 0.5, 2.0])
    return d


@pytest.mark.parametrize("shape", [
    {}, {"flip_normals": True}, {"face_normals": True},
    {"flip_normals": True, "face_normals": True}])
def test_mesh_shape_loads_as_jax(shape):
    """``mesh`` shapes with ``to_world``, ``flip_normals`` and
    ``face_normals`` give the JAX loader's arrays (normals to 1e-6: numpy
    runs the same operations, but the transforms are built by each
    package's own ``ScalarTransform4f``)."""
    sj = mi.load_dict(_mesh_dict(cornell_box_mesh_jax(res=8, spp=1),
                                 mi.ScalarTransform4f, **shape))
    st = mt.load_dict(_mesh_dict(cornell_box_mesh(res=8, spp=1),
                                 mt.ScalarTransform4f, **shape),
                      device="cpu")
    ref = jax_arrays(sj)
    for k in GEOMETRY_FIELDS:
        np.testing.assert_allclose(getattr(st, k).numpy(), ref[k],
                                   rtol=0, atol=1e-6, err_msg=k)
    assert st.bvh is None


def test_dispatch_boundary(monkeypatch):
    """A scene above the threshold gets a BVH and its hits are the brute
    force's; at the threshold it has none and goes to K1."""
    o, d, maxt = _random_rays(1024, 13)
    small = cornell_box_mesh(res=8, spp=1, subdiv=12)     # 300 triangles
    monkeypatch.setattr(accel, "BRUTE_FORCE_MAX_TRIS", 100)
    sc = mt.load_dict(small, device="cpu")
    assert sc.bvh is not None and not accel.use_brute_force(sc)
    ray = mt.Ray.make(o, d, maxt)
    pi = sc.ray_intersect_preliminary(ray)
    occ = sc.ray_test(ray)
    monkeypatch.setattr(accel, "BRUTE_FORCE_MAX_TRIS", 4096)
    assert accel.use_brute_force(sc)
    ref = sc.ray_intersect_preliminary(ray)
    assert torch.equal(pi.valid, ref.valid)
    assert torch.equal(pi.prim_index, ref.prim_index)
    assert torch.equal(pi.t, ref.t)
    assert torch.equal(occ, sc.ray_test(ray))
    assert torch.equal(pi.prim_index[~pi.valid],
                       torch.zeros_like(pi.prim_index[~pi.valid]))


def test_scene_from_arrays_carries_or_builds_the_tree(jax_mesh_scene):
    """Given the JAX tree's arrays the port takes them; without them it
    builds the same tree itself."""
    sj = jax_mesh_scene
    arrays = jax_arrays(sj)
    assert "bvh.order" in arrays
    st = port_scene_of(sj)
    no_tree = {k: v for k, v in arrays.items() if not k.startswith("bvh.")}
    built = mt.scene_from_arrays(
        no_tree, sensors=[dict(kind="perspective", width=16, height=16)],
        device="cpu")
    for k in BT.ARRAY_FIELDS:
        assert torch.equal(getattr(built.bvh, k), getattr(st.bvh, k)), k
    assert torch.equal(built.bvh_nodes, st.bvh_nodes)
    assert torch.equal(built.bvh_tris, st.bvh_tris)
