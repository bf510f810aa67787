"""Path Replay Backpropagation (counterpart of ``ad/prb.py``) as a
``torch.autograd.Function``.

Forward: the recording primal, one pass of the path tracer over a
wavefront of ``W * H * spp`` lanes that keeps each bounce's hits and
shadow visibilities (``path.sample_primal_recorded``).  Backward: the
film's adjoint turns the image cotangent into each lane's δL; the replay
re-runs the loop from the same sampler stream, reads the recorded trace
instead of traversing, and at every bounce takes one
``torch.autograd.grad`` of ``sum(Lo * δL)`` w.r.t. the scene's leaves,

    Lo = Le + Lr_dir + L_remaining * replace_grad(1, bsdf_val / bsdf_val)

(epsm.py:688-715, the denominator detached).  The replay is the fused form
(``_prb_backward_fused``): one bounce computes the attached contribution
and, from detached values, the next loop state, drawing from the sampler
in the primal's order (NEE 2-D, BSDF 1-D and 2-D, roulette 1-D).  No
graph spans two bounces.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, Optional, Sequence

import torch

from ..core import math as m
from ..integrators import common, path as P
from ..models import bsdf as B
from ..models import emitters as E
from ..models import films, samplers as smp
from ..models.records import Ray
from ..ops import intersect as I


def _film_fn(values, pos, weight, sensor, spp):
    """The film of the pixel-major lanes (``_film_fn``, :93-101): the box
    filter's per-pixel mean, or any other filter's scatter-free splat of
    the samples at ``pos`` developed by a detached weight channel."""
    value = values * weight
    if sensor.rfilter == "box":
        return films.accumulate_coalesced(value, sensor.width,
                                          sensor.height, spp)
    jitter = pos - torch.floor(pos)
    data, w = films.splat_coalesced(jitter, value, sensor.width,
                                    sensor.height, spp, sensor.rfilter)
    return films.develop(data, w.detach())


def film_adjoint(g_img, pos, weight, sensor, spp: int,
                 n: int) -> torch.Tensor:
    """Per-lane adjoint radiance δL (n, 3) of the image cotangent
    ``g_img`` (``film_adjoint``, :104-108), by ``torch.autograd.grad``
    through the film."""
    with torch.enable_grad():
        values = torch.zeros((n, 3), dtype=g_img.dtype,
                             device=g_img.device, requires_grad=True)
        img = _film_fn(values, pos, weight, sensor, spp)
        (dL,) = torch.autograd.grad(img, values, g_img)
    return dL


def _camera(scene, seed, sensor_idx, spp):
    """The pass's sampler (the scene's kind, advanced past the camera
    draws), camera rays, film weights and splat positions: the same in
    the forward and the replay (:744-746)."""
    sensor = scene.sensors[sensor_idx]
    n = sensor.width * sensor.height * spp
    sampler = smp.seed(seed, n, kind=scene.static.sampler_kind, spp=spp,
                       device=scene.device)
    sampler, ray, weight, pos = common.sample_rays(sensor, sampler, spp)
    return sensor, n, sampler, ray, weight, pos


def _replay_bounce(sc, leaves: Sequence[torch.Tensor], st: P.LoopState,
                   cached: dict, dL, max_depth: int, rr_depth: int):
    """One bounce of the fused replay: (the next detached state, the
    gradient of sum(Lo * dL) w.r.t. each of ``leaves``, None where it
    does not reach one)."""
    with torch.enable_grad():
        # the primal's hit stage, on the recorded hit: no traversal
        _, si, le, active_next, active_em = P.hit_stage(sc, st, max_depth,
                                                        cached=cached)

        # NEE, attached: the emitter point and the receiving point carry
        # the gradient; pdfs and the recorded visibility are detached
        sampler, s2 = smp.next_2d(st.sampler)
        ds, _ = E.sample_direction(
            sc.emitters, sc.static.emitter_kinds, si.p.detach(), s2,
            sc.vertices, sc.faces, sc.em_faces)
        active_em = active_em & (ds.pdf != 0.0)
        d_att = m.normalize(ds.p - si.p)
        # every emitter kind of the port is an area emitter (check_kinds),
        # whose attached evaluation is eval_hit
        em_val = E.eval_hit(sc.emitters, ds.emitter_index,
                            m.dot(-d_att, ds.n))
        pdf_d = ds.pdf.detach()
        em_weight = torch.where(
            (pdf_d > 0.0)[..., None],
            em_val / torch.clamp(pdf_d, min=1e-20)[..., None], 0.0)
        em_weight = torch.where((active_em & ~cached["occl"])[..., None],
                                em_weight, 0.0)
        wo_em = si.to_local(d_att.detach())
        bsdf_val_em, bsdf_pdf_em = B.eval_pdf(
            sc.bsdfs, sc.static.bsdf_kinds, si.bsdf_index, si.wi, wo_em,
            active_em)
        mis_em = torch.where(ds.delta, 1.0,
                             common.mis_weight(pdf_d, bsdf_pdf_em))
        lr_dir = st.beta * mis_em[..., None] * bsdf_val_em * em_weight

        # the state advance, detached: bitwise the primal bounce's
        si_d = si.detach()
        bsdfs_d = {k: v.detach() for k, v in sc.bsdfs.items()}
        st2, wo_world = P.advance(st, si_d, sampler, bsdfs_d,
                                  sc.static.bsdf_kinds, active_next,
                                  rr_depth)

        # indirect: the detached BSDF weight cancelled and re-attached
        L_remaining = (st.L - le - lr_dir).detach()
        bsdf_val, _ = B.eval_pdf(
            sc.bsdfs, sc.static.bsdf_kinds, si.bsdf_index, si.wi,
            si.to_local(wo_world), active_next)
        val_d = bsdf_val.detach()
        nz = val_d != 0.0
        inv_det = torch.where(nz, 1.0, 0.0) / torch.where(nz, val_d, 1.0)
        lr_ind = L_remaining * I.replace_grad(torch.ones_like(bsdf_val),
                                              inv_det * bsdf_val)
        obj = torch.sum((le + lr_dir + lr_ind) * dL)
        grads = (torch.autograd.grad(obj, leaves, allow_unused=True)
                 if obj.requires_grad else (None,) * len(leaves))
    return replace(st2, L=L_remaining), grads


def prb_backward(scene, names: Sequence[str], sampler, ray: Ray, dL,
                 L_total, max_depth: int, rr_depth: int,
                 trace: dict) -> Dict[str, torch.Tensor]:
    """The replay: the gradient of sum(image * cotangent) w.r.t. the
    scene's leaves ``names``, accumulated over the bounces.  ``trace`` is
    the recording primal's; the replay traverses nothing."""
    all_leaves = scene.leaves()
    leaves = {k: all_leaves[k].detach().requires_grad_(True) for k in names}
    sc = scene.with_leaves(leaves)
    order = list(leaves.values())
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    st = P.init_state(sampler, ray, ray.o.shape[0])
    st = replace(st, L=L_total)
    for i in range(max_depth):
        st, g = _replay_bounce(sc, order, st, P.trace_at(trace, i), dL,
                               max_depth, rr_depth)
        for k, gk in zip(names, g):
            if gk is not None:
                grads[k] += gk
    return grads


class _RenderPRB(torch.autograd.Function):
    """``_make_render``'s custom_vjp (:763-858): the inputs are the scene
    leaves that require grad, and the backward hands back one gradient for
    each."""

    @staticmethod
    def forward(ctx, scene, cfg, names, *leaves):
        seed, sensor_idx, spp, max_depth, rr_depth, multi_pop = cfg
        sensor, _, sampler, ray, weight, pos = _camera(scene, seed,
                                                       sensor_idx, spp)
        L, _, trace = P.sample_primal_recorded(scene, sampler, ray,
                                               max_depth, rr_depth,
                                               multi_pop)
        ctx.scene, ctx.cfg, ctx.names = scene, cfg, names
        ctx.L, ctx.trace = L, trace
        return _film_fn(L, pos, weight, sensor, spp)

    @staticmethod
    def backward(ctx, g_img):
        seed, sensor_idx, spp, max_depth, rr_depth, _ = ctx.cfg
        scene = ctx.scene
        sensor, n, sampler, ray, weight, pos = _camera(scene, seed,
                                                       sensor_idx, spp)
        dL = film_adjoint(g_img.contiguous(), pos, weight, sensor, spp, n)
        grads = prb_backward(scene, ctx.names, sampler, ray, dL, ctx.L,
                             max_depth, rr_depth, ctx.trace)
        ctx.L = ctx.trace = None
        return (None, None, None, *(grads[k] for k in ctx.names))


def render_prb(scene, seed: int = 0, sensor_idx: int = 0, spp: int = 16,
               max_depth: int = 6, rr_depth: int = 5,
               multi_pop: Optional[int] = None, reparam: bool = False,
               execution: str = "megakernel",
               compact_chunks: int = 0) -> torch.Tensor:
    """One pass (``render_prb``): the (H, W, 3) image.  Where grad mode is
    on and a scene leaf requires grad, the pass records its trace and is
    differentiable through the replay; otherwise it is the detached
    primal.  ``multi_pop``: the BVH closest hit's schedule (K2 or K4;
    ``None`` leaves it to ``cuda_traverse.closest_hit``)."""
    if reparam:
        raise NotImplementedError(
            "reparam (prb_reparam) comes with a later slice of the port")
    if execution != "megakernel":
        raise NotImplementedError(
            f"execution '{execution}': the port runs the megakernel "
            "(masked full-width) loop only")
    if compact_chunks:
        raise NotImplementedError(
            "dead-lane compaction comes with a later slice of the port")
    leaves = scene.leaves()
    names = tuple(k for k, v in leaves.items() if v.requires_grad)
    if torch.is_grad_enabled() and names:
        cfg = (seed, sensor_idx, spp, max_depth, rr_depth, multi_pop)
        return _RenderPRB.apply(scene, cfg, names,
                                *(leaves[k] for k in names))
    with torch.no_grad():
        sensor, _, sampler, ray, weight, pos = _camera(scene, seed,
                                                       sensor_idx, spp)
        L, _ = P.sample_primal(scene, sampler, ray, max_depth, rr_depth,
                               multi_pop)
        return _film_fn(L, pos, weight, sensor, spp)
