"""Path tracer with NEE + MIS (counterpart of ``integrators/path.py``):
the detached primal, and the recording primal whose per-bounce hits and
shadow visibilities the PRB replay (``ad/prb.py``) reads back.

Every lane runs every bounce; lanes that have left the path are masked.
Each bounce issues one closest-hit query and one shadow-ray query for the
whole wavefront (dead lanes carry zero-extent rays), and every lane draws
from its sampler in the same order whether it is active or not — next_2d
for NEE, next_1d and next_2d for the BSDF, next_1d for Russian roulette —
so the streams stay in step with the reference.  ``hit_stage``, the part
of a bounce the replay shares, traverses nothing when given a recorded
``cached`` record.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from ..models import bsdf as B
from ..models import emitters as E
from ..models import samplers as smp
from ..models.records import PreliminaryIntersection, Ray, RayFlags
from ..ops import intersect as I
from .common import mis_weight

_INF = float("inf")


@dataclass(frozen=True)
class LoopState:
    sampler: smp.Sampler
    ray_o: torch.Tensor            # (N, 3)
    ray_d: torch.Tensor            # (N, 3)
    depth: torch.Tensor            # (N,) int32
    L: torch.Tensor                # (N, 3) radiance so far
    beta: torch.Tensor             # (N, 3) path throughput
    eta: torch.Tensor              # (N,)
    active: torch.Tensor           # (N,) bool
    prev_p: torch.Tensor           # (N, 3) previous vertex
    prev_bsdf_pdf: torch.Tensor    # (N,)
    prev_bsdf_delta: torch.Tensor  # (N,) bool


def _emitter_hit_le(scene, si, ray_d, prev_p, prev_bsdf_pdf, prev_bsdf_delta,
                    active):
    """Emission at the current vertex, MIS-weighted against NEE
    (epsm.py:566-577), and the environment's on escaped rays (JAX
    ``integrators/path.py:49-79``).

    The environment's MIS pdf is ``pdf_direction`` of emitter row 0, as
    in the reference (:66-72): where row 0 is an area light, an escaped
    ray's pdf is the area branch's on the miss record's ``si.p`` and
    ``si.n``, not the environment's own.  Without a constant or envmap
    light the environment term is the plain (zero) sum."""
    ek = scene.static.emitter_kinds
    tex, env = scene.textures, scene.static.env_texture
    mis_active = active & ~prev_bsdf_delta
    ds_pdf = E.pdf_direction(
        scene.emitters, ek, prev_p, ray_d, si.emitter_index, si.p, si.n,
        scene.vertices, scene.faces, scene.em_faces, mis_active, tex, env)
    mis = mis_weight(prev_bsdf_pdf, ds_pdf)
    le_surf = E.eval_hit(scene.emitters, si.emitter_index, si.wi[..., 2],
                         uv=si.uv, kinds_present=ek)
    le_surf = torch.where((active & si.valid)[..., None], le_surf, 0.0)
    le_env = E.eval_env(scene.emitters, ek, ray_d, active & ~si.valid, tex,
                        env)
    if E.KIND_CONSTANT not in ek and E.KIND_ENVMAP not in ek:
        return mis[..., None] * le_surf + le_env
    env_pdf = E.pdf_direction(
        scene.emitters, ek, prev_p, ray_d,
        torch.zeros_like(si.emitter_index), si.p, si.n, scene.vertices,
        scene.faces, scene.em_faces, mis_active, tex, env)
    mis_env = mis_weight(prev_bsdf_pdf, torch.where(~si.valid, env_pdf, 0.0))
    return mis[..., None] * le_surf + mis_env[..., None] * le_env


def _nee(scene, si, sampler, active_em):
    """Emitter sampling with visibility (epsm.py:585-605).  Returns
    (sampler, ds, lr_dir, active_em, occluded): the direction sample, and
    the mask of the lanes that sampled an emitter."""
    sampler, s2 = smp.next_2d(sampler)
    ds, em_weight = E.sample_direction(
        scene.emitters, scene.static.emitter_kinds, si.p, s2,
        scene.vertices, scene.faces, scene.em_faces, scene.textures,
        scene.static.env_texture)
    active_em = active_em & (ds.pdf != 0.0)
    # lanes with no NEE work carry zero-extent shadow rays
    shadow_ray = si.spawn_ray(ds.d)
    shadow_ray = shadow_ray.replace(
        maxt=torch.where(active_em, ds.dist * (1.0 - 1e-3), 0.0))
    occluded = scene.ray_test(shadow_ray)
    em_weight = torch.where((active_em & ~occluded)[..., None], em_weight,
                            0.0)
    wo = si.to_local(ds.d)
    bsdf_val_em, bsdf_pdf_em = B.eval_pdf(
        scene.bsdfs, scene.static.bsdf_kinds, si.bsdf_index, si.wi, wo,
        active_em, uv=si.uv, textures=scene.bsdf_textures(),
        vcolor=si.vcolor)
    # a delta light (point, spot, projector, directional) takes weight 1
    mis_em = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf_em))
    lr_dir = mis_em[..., None] * bsdf_val_em * em_weight
    return sampler, ds, lr_dir, active_em, occluded


def advance(st: LoopState, si, sampler, bsdfs, bsdf_kinds, active_next,
            rr_depth: int, textures=()):
    """BSDF sampling, throughput and Russian roulette: the next loop state
    from this bounce's (detached) interaction ``si``.  Draws next_1d and
    next_2d for the BSDF, then next_1d for the roulette.  ``textures``:
    the BSDF slots' textures by index (``Scene.bsdf_textures``).  Returns
    (the state with ``st.L`` carried over, the sampled direction in world
    space)."""
    sampler, s1 = smp.next_1d(sampler)
    sampler, s2 = smp.next_2d(sampler)
    bs, bsdf_weight, ok = B.sample(bsdfs, bsdf_kinds, si.bsdf_index, si.wi,
                                   s1, s2, active_next, uv=si.uv,
                                   textures=textures, vcolor=si.vcolor)
    wo_world = si.to_world(bs.wo)
    new_ray = si.spawn_ray(wo_world)
    eta = st.eta * torch.where(ok, bs.eta, 1.0)
    beta = st.beta * torch.where(ok[..., None], bsdf_weight, 0.0)

    beta_max = torch.amax(beta, dim=-1)
    active_next = active_next & (beta_max != 0.0)
    rr_prob = torch.clamp(beta_max * eta * eta, max=0.95)
    rr_active = st.depth >= rr_depth
    beta = torch.where(rr_active[..., None],
                       beta / torch.clamp(rr_prob, min=1e-8)[..., None], beta)
    sampler, rr_u = smp.next_1d(sampler)
    active_next = active_next & (~rr_active | (rr_u < rr_prob))
    st2 = LoopState(
        sampler=sampler, ray_o=new_ray.o, ray_d=new_ray.d,
        depth=st.depth + si.valid.to(st.depth.dtype), L=st.L, beta=beta,
        eta=eta, active=active_next, prev_p=si.p.detach(),
        prev_bsdf_pdf=bs.pdf,
        prev_bsdf_delta=B.has_flag(bs.sampled_type, B.BSDFFlags.Delta))
    return st2, wo_world


def hit_stage(scene, st: LoopState, max_depth: int, cached: dict = None,
              multi_pop: Optional[int] = None):
    """The part of a bounce that the primal and the PRB replay share: the
    hit, its surface interaction ``si``, the MIS-weighted emission ``le``
    there, and the masks of the lanes that go on (``active_next``) and
    that sample an emitter (``active_em``).  Given a recorded ``cached``
    record the hit is read from it and nothing is traversed (:134-135).
    ``multi_pop``: the closest hit's schedule (``ops/cuda_traverse.py``).
    Returns (pi, si, le, active_next, active_em)."""
    ray = Ray.make(st.ray_o, st.ray_d,
                   maxt=torch.where(st.active, _INF, 0.0))
    if cached is not None:
        pi = cached["pi"]
    else:
        pi = scene.ray_intersect_preliminary(ray, multi_pop=multi_pop)
        pi = pi.replace(valid=pi.valid & st.active)
    si = I.compute_surface_interaction(scene, ray, pi, RayFlags.All)

    le = st.beta * _emitter_hit_le(scene, si, st.ray_d, st.prev_p,
                                   st.prev_bsdf_pdf, st.prev_bsdf_delta,
                                   st.active)

    bsdf_flags = B.flags_of(scene.bsdfs, si.bsdf_index)
    active_next = (st.depth + 1 < max_depth) & si.valid & st.active
    active_em = active_next & B.has_flag(bsdf_flags, B.BSDFFlags.Smooth)
    return pi, si, le, active_next, active_em


def bounce(scene, st: LoopState, max_depth: int, rr_depth: int,
           multi_pop: Optional[int] = None):
    """One path-tracing bounce of the whole wavefront.  Returns (state,
    record): the record holds the hit ``pi`` and the shadow visibility
    ``occl`` (``bounce`` :204-219) that the replay reads back."""
    pi, si, le, active_next, active_em = hit_stage(
        scene, st, max_depth, multi_pop=multi_pop)
    sampler, _, lr_dir, _, occl = _nee(scene, si, st.sampler, active_em)
    lr_dir = st.beta * lr_dir

    st2, _ = advance(st, si, sampler, scene.bsdfs, scene.static.bsdf_kinds,
                     active_next, rr_depth, scene.bsdf_textures())
    L = st.L + torch.where(st.active[..., None], le + lr_dir, 0.0)
    return replace(st2, L=L), {"pi": pi, "occl": occl}


def init_state(sampler, ray: Ray, n: int) -> LoopState:
    dtype, device = ray.o.dtype, ray.o.device
    return LoopState(
        sampler=sampler, ray_o=ray.o, ray_d=ray.d,
        depth=torch.zeros(n, dtype=torch.int32, device=device),
        L=torch.zeros((n, 3), dtype=dtype, device=device),
        beta=torch.ones((n, 3), dtype=dtype, device=device),
        eta=torch.ones(n, dtype=dtype, device=device),
        active=torch.ones(n, dtype=torch.bool, device=device),
        prev_p=ray.o,
        prev_bsdf_pdf=torch.ones(n, dtype=dtype, device=device),
        prev_bsdf_delta=torch.ones(n, dtype=torch.bool, device=device))


def sample_primal(scene, sampler, ray: Ray, max_depth: int,
                  rr_depth: int = 5, multi_pop: Optional[int] = None):
    """Primal radiance estimate: (L (N, 3), valid (N,))."""
    L, valid, _ = _primal(scene, sampler, ray, max_depth, rr_depth,
                          multi_pop, record=False)
    return L, valid


def sample_primal_recorded(scene, sampler, ray: Ray, max_depth: int,
                           rr_depth: int = 5,
                           multi_pop: Optional[int] = None):
    """Primal estimate that also records each bounce's traversal results
    (:265-298).  Returns (L, valid, trace): ``trace`` holds ``pi``, a
    PreliminaryIntersection of (D, N, ...) tensors, and ``occl`` (D, N),
    stacked over the depth D; about 18 B a lane a bounce.  The replay
    (``hit_stage(..., cached=...)``) then traverses nothing."""
    return _primal(scene, sampler, ray, max_depth, rr_depth, multi_pop,
                   record=True)


def _primal(scene, sampler, ray, max_depth, rr_depth, multi_pop, record):
    st = init_state(sampler, ray, ray.o.shape[0])
    recs = []
    for _ in range(max_depth):
        st, rec = bounce(scene, st, max_depth, rr_depth,
                         multi_pop=multi_pop)
        if record:
            recs.append(rec)
    trace = None
    if record:
        pis = [r["pi"] for r in recs]
        trace = {"pi": PreliminaryIntersection(
            t=torch.stack([p.t for p in pis]),
            prim_uv=torch.stack([p.prim_uv for p in pis]),
            prim_index=torch.stack([p.prim_index for p in pis]),
            valid=torch.stack([p.valid for p in pis])),
            "occl": torch.stack([r["occl"] for r in recs])}
    return st.L, st.depth > 0, trace


def trace_at(trace: dict, i: int) -> dict:
    """Bounce ``i``'s record of a stacked trace."""
    pi = trace["pi"]
    return {"pi": PreliminaryIntersection(
        t=pi.t[i], prim_uv=pi.prim_uv[i], prim_index=pi.prim_index[i],
        valid=pi.valid[i]), "occl": trace["occl"][i]}
