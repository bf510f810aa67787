"""Path tracer with NEE + MIS, primal only (counterpart of
``integrators/path.py``).

Every lane runs every bounce; lanes that have left the path are masked.
Each bounce issues one closest-hit query and one shadow-ray query for the
whole wavefront (dead lanes carry zero-extent rays), and every lane draws
from its sampler in the same order whether it is active or not — next_2d
for NEE, next_1d and next_2d for the BSDF, next_1d for Russian roulette —
so the streams stay in step with the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models import bsdf as B
from ..models import emitters as E
from ..models import samplers as smp
from ..models.records import Ray, RayFlags
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
    (epsm.py:566-577)."""
    ek = scene.static.emitter_kinds
    ds_pdf = E.pdf_direction(
        scene.emitters, ek, prev_p, ray_d, si.emitter_index, si.p, si.n,
        scene.vertices, scene.faces, scene.em_faces,
        active & ~prev_bsdf_delta)
    mis = mis_weight(prev_bsdf_pdf, ds_pdf)
    le_surf = E.eval_hit(scene.emitters, si.emitter_index, si.wi[..., 2])
    le_surf = torch.where((active & si.valid)[..., None], le_surf, 0.0)
    le_env = E.eval_env(scene.emitters, ek, ray_d)
    return mis[..., None] * le_surf + le_env


def _nee(scene, si, sampler, active_em):
    """Emitter sampling with visibility (epsm.py:585-605)."""
    sampler, s2 = smp.next_2d(sampler)
    ds, em_weight = E.sample_direction(
        scene.emitters, scene.static.emitter_kinds, si.p, s2,
        scene.vertices, scene.faces, scene.em_faces)
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
        active_em)
    mis_em = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf_em))
    return sampler, mis_em[..., None] * bsdf_val_em * em_weight


def bounce(scene, st: LoopState, max_depth: int, rr_depth: int) -> LoopState:
    """One path-tracing bounce of the whole wavefront."""
    ray = Ray.make(st.ray_o, st.ray_d,
                   maxt=torch.where(st.active, _INF, 0.0))
    pi = scene.ray_intersect_preliminary(ray)
    pi = pi.replace(valid=pi.valid & st.active)
    si = I.compute_surface_interaction(scene, ray, pi, RayFlags.All)

    le = st.beta * _emitter_hit_le(scene, si, st.ray_d, st.prev_p,
                                   st.prev_bsdf_pdf, st.prev_bsdf_delta,
                                   st.active)

    bsdf_flags = B.flags_of(scene.bsdfs, si.bsdf_index)
    active_next = (st.depth + 1 < max_depth) & si.valid & st.active
    active_em = active_next & B.has_flag(bsdf_flags, B.BSDFFlags.Smooth)

    sampler, lr_dir = _nee(scene, si, st.sampler, active_em)
    lr_dir = st.beta * lr_dir

    sampler, s1 = smp.next_1d(sampler)
    sampler, s2 = smp.next_2d(sampler)
    bs, bsdf_weight, ok = B.sample(
        scene.bsdfs, scene.static.bsdf_kinds, si.bsdf_index, si.wi, s1, s2,
        active_next)

    L = st.L + torch.where(st.active[..., None], le + lr_dir, 0.0)
    new_ray = si.spawn_ray(si.to_world(bs.wo))
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

    return LoopState(
        sampler=sampler, ray_o=new_ray.o, ray_d=new_ray.d,
        depth=st.depth + si.valid.to(st.depth.dtype), L=L, beta=beta,
        eta=eta, active=active_next, prev_p=si.p, prev_bsdf_pdf=bs.pdf,
        prev_bsdf_delta=B.has_flag(bs.sampled_type, B.BSDFFlags.Delta))


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
                  rr_depth: int = 5):
    """Primal radiance estimate: (L (N, 3), valid (N,))."""
    st = init_state(sampler, ray, ray.o.shape[0])
    for _ in range(max_depth):
        st = bounce(scene, st, max_depth, rr_depth)
    return st.L, st.depth > 0
