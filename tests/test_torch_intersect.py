"""K1's plain version against the JAX package's brute force and against
the Pallas kernel ``_mt_kernel`` itself, run in interpret mode; and the
port's surface interactions against the JAX package's.

``valid`` and ``prim_index`` must be identical on every ray; t, u, v
within atol 1e-5 where the ray is not grazing (see ``_grazing``).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.models.records import Ray as RayJ
from epsm_mitsuba3_tpu.ops import intersect as IJ
from epsm_mitsuba3_tpu.ops import pallas_intersect as PI
from scenes import cornell_box as cornell_box_jax

from epsm_mitsuba3_torch.models.records import Ray as RayT
from epsm_mitsuba3_torch.ops import accel
from epsm_mitsuba3_torch.ops import cuda_intersect as CI
from epsm_mitsuba3_torch.ops import intersect as IT

from test_torch_render import port_scene_of

N_RAYS = 4096 + 37     # a ragged edge past one 4,096-ray Pallas block
ATOL = 1e-5


def _soup(n_tris, seed):
    """Random triangle soup in [-1, 1]^3 and rays aimed into it: finite
    and infinite extents, and dead lanes (maxt = 0)."""
    r = np.random.default_rng(seed)
    verts = r.uniform(-1, 1, (3 * n_tris, 3)).astype(np.float32)
    faces = np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)
    o = r.uniform(-2, 2, (N_RAYS, 3)).astype(np.float32)
    target = r.uniform(-0.8, 0.8, (N_RAYS, 3)).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    maxt = np.full(N_RAYS, np.inf, np.float32)
    finite = r.random(N_RAYS) < 0.3
    maxt[finite] = r.uniform(0.5, 4.0, finite.sum())
    maxt[r.random(N_RAYS) < 0.1] = 0.0
    return verts, faces, o, d, maxt


def _pallas_mt(verts, faces, o, d, maxt):
    """``_mt_kernel`` through a test-local interpret-mode pallas_call with
    plain BlockSpecs, packed and unpacked as ``ray_intersect_pallas``."""
    ray = RayJ.make(jnp.asarray(o), jnp.asarray(d), jnp.asarray(maxt))
    tri, n_tris = PI._pack_tris(jnp.asarray(verts), jnp.asarray(faces))
    o3, d3, m2, n, rows = PI._pack_rays(ray)

    def blk(c):
        return pl.BlockSpec((c, PI.BLOCK_ROWS, PI.LANE), lambda i: (0, i, 0))

    out = pl.pallas_call(
        functools.partial(PI._mt_kernel, n_tris=n_tris, any_hit=False),
        grid=(rows // PI.BLOCK_ROWS,),
        out_shape=[jax.ShapeDtypeStruct((1, rows, PI.LANE), jnp.float32)
                   for _ in range(4)],
        in_specs=[pl.BlockSpec(tri.shape, lambda i: (0, 0)),
                  blk(3), blk(3), blk(1)],
        out_specs=[blk(1) for _ in range(4)],
        interpret=True,
    )(tri, o3, d3, m2)
    t, idx, u, v = (np.asarray(x).reshape(-1)[:n] for x in out)
    return t, idx.astype(np.int32), u, v


def _port(verts, faces, o, d, maxt):
    tri = CI.pack_tris(torch.from_numpy(verts), torch.from_numpy(faces))
    args = (tri, torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(maxt))
    t, prim, u, v = CI.closest_hit(*args)
    occ = CI.any_hit(*args)
    return t.numpy(), prim.numpy(), u.numpy(), v.numpy(), occ.numpy()


def _grazing(soup, prim):
    """Hits whose ray meets the triangle at |cos| < 0.05.  There 1/|det|
    amplifies a single rounding difference (XLA contracts multiply-adds
    into FMAs, PyTorch does not) past 1e-5 in t, u and v."""
    verts, faces, _, d, _ = soup
    tri = verts[faces[np.maximum(prim, 0)]]
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    cos = np.abs((nrm * d).sum(-1)) / np.linalg.norm(nrm, axis=-1)
    return (prim >= 0) & (cos < 0.05)


def _assert_same_hits(soup, t, prim, u, v, t_ref, prim_ref, u_ref, v_ref):
    np.testing.assert_array_equal(prim >= 0, prim_ref >= 0)
    np.testing.assert_array_equal(np.maximum(prim, 0),
                                  np.maximum(prim_ref, 0))
    assert np.isinf(t[prim < 0]).all() and np.isinf(t_ref[prim < 0]).all()
    ok = ~_grazing(soup, prim)
    assert ok.mean() > 0.97
    hit = (prim >= 0) & ok
    np.testing.assert_allclose(t[hit], t_ref[hit], atol=ATOL, rtol=0)
    np.testing.assert_allclose(u[ok], u_ref[ok], atol=ATOL, rtol=0)
    np.testing.assert_allclose(v[ok], v_ref[ok], atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_tris,seed", [(40, 0), (300, 1)])
def test_k1_plain_matches_pallas_kernel(n_tris, seed):
    soup = _soup(n_tris, seed)
    t, prim, u, v, occ = _port(*soup)
    t_p, idx_p, u_p, v_p = _pallas_mt(*soup)
    t_p = np.where(idx_p >= 0, t_p, np.inf)
    _assert_same_hits(soup, t, prim, u, v, t_p, idx_p, u_p, v_p)
    # ray_test_pallas is the closest hit's valid
    np.testing.assert_array_equal(occ, idx_p >= 0)
    assert 0.2 < occ.mean() < 0.95      # the soup exercises both outcomes


@pytest.mark.parametrize("n_tris,seed", [(40, 2), (300, 3)])
def test_k1_plain_matches_jax_brute(n_tris, seed):
    soup = verts, faces, o, d, maxt = _soup(n_tris, seed)
    t, prim, u, v, occ = _port(*soup)
    ray = RayJ.make(jnp.asarray(o), jnp.asarray(d), jnp.asarray(maxt))
    pi = IJ.ray_intersect_brute(ray, jnp.asarray(verts), jnp.asarray(faces))
    valid = np.asarray(pi.valid)
    prim_ref = np.where(valid, np.asarray(pi.prim_index), -1)
    uv = np.asarray(pi.prim_uv)
    _assert_same_hits(soup, t, prim, u, v, np.asarray(pi.t), prim_ref,
                      uv[:, 0], uv[:, 1])
    occ_ref = np.asarray(IJ.ray_test_brute(ray, jnp.asarray(verts),
                                           jnp.asarray(faces)))
    np.testing.assert_array_equal(occ, occ_ref)
    np.testing.assert_array_equal(occ, prim >= 0)


def test_moeller_trumbore_matches_jax():
    """One triangle per ray, on the vertex form (p0, p1, p2)."""
    r = np.random.default_rng(6)
    p = [r.uniform(-1, 1, (N_RAYS, 3)).astype(np.float32) for _ in range(3)]
    o = r.uniform(-2, 2, (N_RAYS, 3)).astype(np.float32)
    d = (p[0] + p[1] + p[2]) / 3 - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tj, uj, vj, hj = IJ.moeller_trumbore(*(jnp.asarray(x) for x in
                                           (o, d, *p)))
    tt, ut, vt, ht = IT.moeller_trumbore(*(torch.from_numpy(x) for x in
                                           (o, d, *p)))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    # well-conditioned tests only: |det| / (|e1| |e2|) = |cos| x the sine
    # of the triangle's corner angle; below 0.05 one rounding step of
    # either side is magnified past 1e-5 (see _grazing)
    e1, e2 = p[1] - p[0], p[2] - p[0]
    det = np.abs((np.cross(e1, e2) * d).sum(-1))
    ok = ht.numpy() & (det / (np.linalg.norm(e1, axis=-1)
                              * np.linalg.norm(e2, axis=-1)) >= 0.05)
    assert ok.mean() > 0.8
    for a, b in ((tt, tj), (ut, uj), (vt, vj)):
        np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok],
                                   atol=ATOL, rtol=1e-5)


def test_k1_ties_pick_lowest_index():
    """Two copies of one triangle: every hit reports the first copy."""
    verts, faces, o, d, maxt = _soup(8, 4)
    faces = np.concatenate([faces, faces[:1]])
    _, prim, _, _, occ = _port(verts, faces, o, d, maxt)
    assert (prim != 8).all() and (prim[occ] >= 0).all()


def test_k1_wrapper_rejects_bad_inputs():
    verts, faces, o, d, maxt = _soup(4, 5)
    tri = CI.pack_tris(torch.from_numpy(verts), torch.from_numpy(faces))
    o_t, d_t, m_t = (torch.from_numpy(x) for x in (o, d, maxt))
    with pytest.raises(TypeError):
        CI.closest_hit(tri.double(), o_t, d_t, m_t)
    with pytest.raises(ValueError):
        CI.any_hit(tri, o_t.t().contiguous().t(), d_t, m_t)
    with pytest.raises(ValueError):
        CI.closest_hit(tri, o_t, d_t, m_t[:-1])


def test_accel_refuses_bvh_sized_scene():
    """A scene above BRUTE_FORCE_MAX_TRIS is no longer refused: as in the
    reference (``use_brute_force``), without a BVH it goes to K1's brute
    force, and with one to K2/K3, with the same hits."""
    from epsm_mitsuba3_torch.ops import bvh as BT
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    sj = mi.load_dict(cornell_box_jax(res=8, spp=1))
    st = port_scene_of(sj)
    big = dataclasses.replace(st, faces=st.faces.repeat(400, 1))
    assert big.bvh is None and accel.use_brute_force(big)
    o, d = _cornell_rays(sj)
    ray = RayT.make(torch.from_numpy(o), torch.from_numpy(d))
    ref = IT.ray_intersect_brute(CI.pack_tris(big.vertices, big.faces),
                                 ray.o, ray.d, ray.maxt)
    pi = accel.ray_intersect(big, ray)
    assert torch.equal(pi.valid, ref[1] >= 0)
    assert torch.equal(pi.prim_index, ref[1].clamp(min=0))
    tree = BT.build(big.vertices, big.faces)
    nodes, tris, tris_k = CT.pack_bvh4(tree, big.vertices, big.faces)
    with_bvh = dataclasses.replace(big, bvh=tree, bvh_nodes=nodes,
                                   bvh_tris=tris, bvh_tris_k=tris_k)
    assert not accel.use_brute_force(with_bvh)
    pi_b = accel.ray_intersect(with_bvh, ray)
    assert torch.equal(pi_b.valid, pi.valid)
    # repeated faces tie exactly: the tree may report another copy
    same_tri = (with_bvh.faces[pi_b.prim_index.long()]
                == big.faces[pi.prim_index.long()]).all(-1)
    assert bool(same_tri[pi.valid].all())
    torch.testing.assert_close(pi_b.t, pi.t, rtol=0, atol=0)
    assert torch.equal(accel.ray_test(with_bvh, ray), pi.valid)


def _cornell_rays(sj, seed=0):
    """The JAX camera rays of the scene plus random rays from inside the
    box (these reach the light and escape through the open front)."""
    from epsm_mitsuba3_tpu.integrators import common as CJ
    from epsm_mitsuba3_tpu.models import samplers as SJ
    sensor = sj.sensors[0]
    n = sensor.width * sensor.height
    _, ray, _, _ = CJ.sample_rays(sensor, SJ.seed(jnp.uint32(seed), n), 1)
    r = np.random.default_rng(seed)
    o2 = r.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (n, 3))
    d2 = r.normal(size=(n, 3))
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    o = np.concatenate([np.asarray(ray.o), o2]).astype(np.float32)
    d = np.concatenate([np.asarray(ray.d), d2]).astype(np.float32)
    return o, d


SI_FIELDS = ("t", "p", "n", "sh_n", "sh_s", "sh_t", "uv", "wi", "b0", "b1",
             "p0", "p1", "p2", "n0", "n1", "n2", "ismesh")
SI_INDEX_FIELDS = ("valid", "prim_index", "shape_index", "bsdf_index",
                   "emitter_index")


def test_surface_interaction_on_cornell_rays():
    sj = mi.load_dict(cornell_box_jax(res=24, spp=1))
    st = port_scene_of(sj)
    o, d = _cornell_rays(sj)
    ray_j = RayJ.make(jnp.asarray(o), jnp.asarray(d))
    si_j = sj.ray_intersect(ray_j)
    si_t = st.ray_intersect(RayT.make(torch.from_numpy(o),
                                      torch.from_numpy(d)))
    valid = np.asarray(si_j.valid)
    assert 0.5 < valid.mean() < 1.0
    assert (np.asarray(si_j.emitter_index) >= 0).any()
    for f in SI_INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(si_t, f).numpy(),
                                      np.asarray(getattr(si_j, f)), f)
    for f in SI_FIELDS:
        a = getattr(si_t, f).numpy()[valid]
        b = np.asarray(getattr(si_j, f))[valid]
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=1e-5, err_msg=f)
