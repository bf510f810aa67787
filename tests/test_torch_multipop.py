"""The plain version of kernel K4 (K2 popping up to P stack entries an
iteration, ``ops/traverse.py`` ``bvh_ray_intersect_plain(...,
multi_pop=P)``) against the plain K2 and the JAX package's K4.

Tolerances, each with its reason:

- against the plain K2 (the same PyTorch arithmetic, another visit
  order): ``t`` and ``valid`` equal element for element, since culling
  is exact and every triangle that could win is still tested; ``slot``,
  ``u``, ``v`` may differ only on rays where two triangles give the same
  ``t`` (the test counts those rays);
- against the interpret-mode Pallas K4 (``_traverse_kernel_mp``):
  ``valid`` equal, ``t`` within 1e-5 away from grazing hits, u and v
  within ``UV_ATOL_XLA``: XLA contracts multiply-adds into FMAs and
  PyTorch does not (``ROADMAP.md`` §3).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from epsm_mitsuba3_tpu.models.records import Ray as RayJ
from epsm_mitsuba3_tpu.ops import bvh as BJ
from epsm_mitsuba3_tpu.ops import pallas_traverse as PTJ

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.ops import bvh as BT
from epsm_mitsuba3_torch.ops import cuda_traverse as CT
from epsm_mitsuba3_torch.ops import traverse as TT
from epsm_mitsuba3_torch.ops.intersect import _mt_edges
from epsm_mitsuba3_torch.scenes import bumpy_sphere, cornell_box_mesh

from test_torch_bvh import (SUBDIV, UV_ATOL_XLA, _GeomOnly,
                            _assert_hits_close, _camera_rays, _grazing,
                            _random_rays)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def mesh_scene():
    return mt.load_dict(cornell_box_mesh(res=16, spp=1, subdiv=SUBDIV),
                        device="cpu")


def _ties(sc, o, d, t, slot_a, slot_b):
    """Rays whose two slots differ: each must be a tie, the other slot's
    triangle hit at the same t."""
    diff = (slot_a != slot_b).nonzero().squeeze(1)
    for i in diff.tolist():
        w = sc.bvh_tris[slot_b[i]]
        tt, _, _, hit = _mt_edges(o[i].unbind(), d[i].unbind(),
                                  w[0:3].unbind(), w[3:6].unbind(),
                                  w[6:9].unbind())
        assert bool(hit) and float(tt) == float(t[i]), i
    return diff.numel()


@pytest.mark.parametrize("kind", ["camera", "random"])
@pytest.mark.parametrize("multi_pop", [2, 4])
def test_k4_plain_gives_k2_hits(mesh_scene, kind, multi_pop):
    sc = mesh_scene
    o, d, maxt = (_camera_rays(sc) if kind == "camera"
                  else _random_rays(4096, 3))
    ref = TT.bvh_ray_intersect_plain(sc.bvh_nodes, sc.bvh_tris, o, d, maxt,
                                     counts=True)
    got = TT.bvh_ray_intersect_plain(sc.bvh_nodes, sc.bvh_tris, o, d, maxt,
                                     counts=True, multi_pop=multi_pop)
    assert torch.equal(got[0], ref[0])                       # t
    assert torch.equal(got[1] >= 0, ref[1] >= 0)             # valid
    n_ties = _ties(sc, o, d, ref[0], got[1], ref[1])
    same = got[1] == ref[1]
    assert torch.equal(got[2][same], ref[2][same])
    assert torch.equal(got[3][same], ref[3][same])
    assert n_ties <= 1e-3 * o.shape[0]
    # a batch does not profit from its own pops' shrinking t: the work
    # grows a little, never falls
    assert got[4].sum() >= ref[4].sum()
    assert got[4].sum() <= 1.5 * ref[4].sum()


def test_k4_wrapper_routes_and_rejects(mesh_scene):
    """closest_hit's ``multi_pop`` reaches the plain K4 on the CPU; a
    width K4 is not built for raises."""
    sc = mesh_scene
    o, d, maxt = _random_rays(512, 5)
    a = CT.closest_hit(sc.bvh_nodes, sc.bvh_tris, o, d, maxt, multi_pop=4)
    b = TT.bvh_ray_intersect_plain(sc.bvh_nodes, sc.bvh_tris, o, d, maxt,
                                   multi_pop=4)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        CT.closest_hit(sc.bvh_nodes, sc.bvh_tris, o, d, maxt, multi_pop=3)


@pytest.mark.parametrize("multi_pop", [2, 4])
def test_k4_wrapper_on_cpu_takes_the_plain_k4(mesh_scene, multi_pop):
    """With the kernels' rows given (``tri_k``), as ``ops/accel.py`` gives
    them, ``closest_hit(..., multi_pop=P)`` on CPU tensors still returns
    the plain K4's outputs, with the rays Morton-sorted or not."""
    sc = mesh_scene
    o, d, maxt = _random_rays(700, 8)
    ref = TT.bvh_ray_intersect_plain(sc.bvh_nodes, sc.bvh_tris, o, d, maxt,
                                     multi_pop=multi_pop)
    for sort in (False, True):
        got = CT.closest_hit(sc.bvh_nodes, sc.bvh_tris, o, d, maxt,
                             sort=sort, multi_pop=multi_pop,
                             tri_k=sc.bvh_tris_k)
        for x, y in zip(got, ref):
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_multi_pop_default_is_read_by_closest_hit(monkeypatch):
    """With no ``multi_pop`` named, every layer from ``render`` and
    ``render_prb`` down passes None and ``closest_hit`` reads
    ``MULTI_POP`` at the call; a named width wins over it."""
    from epsm_mitsuba3_torch.ad import prb as prb_t
    sc = mt.load_dict(cornell_box_mesh(res=4, spp=1, max_depth=2,
                                       subdiv=SUBDIV), device="cpu")
    seen = []
    plain = TT.bvh_ray_intersect_plain

    def spy(*a, multi_pop=0, **kw):
        seen.append(multi_pop)
        return plain(*a, multi_pop=multi_pop, **kw)

    monkeypatch.setattr(TT, "bvh_ray_intersect_plain", spy)
    monkeypatch.setattr(CT, "MULTI_POP", 4)
    mt.render(sc, spp=1, device="cpu")
    prb_t.render_prb(sc, spp=1, max_depth=2)
    assert seen and set(seen) == {4}
    seen.clear()
    mt.render(sc, spp=1, device="cpu", integrator={"multi_pop": 2})
    assert seen and set(seen) == {2}


@pytest.mark.parametrize("multi_pop,n,spread", [(2, 128, 0.4),
                                                (4, 512, 0.6)])
def test_k4_plain_matches_pallas_k4_interpreted(multi_pop, n, spread):
    """The JAX package's K4 (``_traverse_kernel_mp`` at P = 2 and 4), run
    in interpret mode: 1,058 triangles, ``n`` rays aimed at points within
    ``spread`` of the mesh's centre (fewer rays at P = 2, to keep the
    interpreter's time down, aimed closer so that most hit)."""
    V, F = bumpy_sphere(subdiv=23)
    r = np.random.default_rng(17)
    o = r.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    o[:, 2] = 2.0
    target = r.uniform(-spread, spread, (n, 3)).astype(np.float32)
    target[:, 1] += 0.7
    d = target - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    maxt = np.where(r.random(n) < 0.3, r.uniform(1.0, 3.0, n),
                    np.inf).astype(np.float32)
    maxt[r.random(n) < 0.1] = 0.0
    bj = BJ.build(V, F)
    ray = RayJ.make(jnp.asarray(o), jnp.asarray(d), jnp.asarray(maxt))
    pi = PTJ.bvh_ray_intersect_pallas(_GeomOnly(V, F, bj), ray, block_sub=8,
                                      multi_pop=multi_pop)

    bt = BT.from_arrays({k: np.asarray(getattr(bj, k))
                         for k in BT.ARRAY_FIELDS}, "cpu")
    nodes, tri, _ = CT.pack_bvh4(bt, torch.from_numpy(V),
                                 torch.from_numpy(F))
    t, slot, u, v = TT.bvh_ray_intersect_plain(
        nodes, tri, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(maxt), multi_pop=multi_pop)
    prim = torch.where(slot >= 0, bt.order[slot.clamp(min=0).long()], -1)
    prim_j = np.where(pi.valid, pi.prim_index, -1)
    skip = _grazing(tri.numpy(), slot.numpy(), d)
    _assert_hits_close(t, prim, u, v, pi.t, prim_j, pi.prim_uv[:, 0],
                       pi.prim_uv[:, 1], skip, UV_ATOL_XLA)


def test_k4_plain_overflow_raises(mesh_scene, monkeypatch):
    """A batch that would push past the stack raises, as K2's does."""
    sc = mesh_scene
    o, d, maxt = _random_rays(256, 9)
    monkeypatch.setattr(TT, "STACK_SIZE", 3)
    with pytest.raises(TT.StackOverflow):
        TT.bvh_ray_intersect_plain(sc.bvh_nodes, sc.bvh_tris, o, d, maxt,
                                   multi_pop=4)
