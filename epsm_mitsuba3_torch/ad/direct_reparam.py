"""The reparameterised direct integrators (counterpart of
``ad/direct_reparam.py``): ``direct_reparam`` and ``emission_reparam``.

Unlike the PRB family these are single-pass attached estimators: direct
illumination has two ray segments, so the backward evaluates the whole
estimator attached and takes one gradient of it.  ``direct_reparam`` has
three reparameterisation sites (``reparameterize_ray``, auxiliary seed
``seed * 0x9E3779B9 + salt``): the camera ray (salt 11), the NEE shadow
ray from the ``FollowShape`` receiver (salt 13 + 4k for sample k) and the
BSDF-sampled ray from it (salt 15 + 4k); ``emission_reparam`` only the
camera ray (salt 11), seeing the emission directly.  The camera vertex's
warp and divergence enter at the film: the sample is re-projected through
the attached sensor (``point_to_film(sensor, o + d)``) and splatted with
the divergence as an extra filter weight, through a gaussian where the
sensor's filter is the box (JAX :202-247, :330-366).

Each is a ``torch.autograd.Function`` whose forward is the detached
primal (``integrators/direct.py`` for ``direct_reparam``) and whose
backward is the attached estimator's gradient.  At 512^2 the attached
graph does not fit whole, so the backward runs in lane chunks of
``ad/prb.py`` ``REPARAM_CHUNK``: a first pass without the warps (their
primal values are the input direction and 1) gives the whole film's data
and weight, then each chunk takes the gradient of its first-order part
of ``sum(develop(data, weight) * g)`` at those values (``prb.develop_coefs``),
as ``prb._camera_term`` does.  Each chunk's camera rays and auxiliary
streams are those lanes' of the whole wavefront.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import math as m
from ..integrators import common, direct as D
from ..models import bsdf as B
from ..models import emitters as E
from ..models import films
from ..models import samplers as smp
from ..models import sensors as S
from ..models.records import Ray, RayFlags
from ..ops import intersect as I
from . import prb


def _site(sc, rp: Optional[dict], seed: int, salt: int, ray: Ray, active,
          lane0: int):
    """A reparameterisation site: the warped direction and its divergence
    (``prb._warp`` with the auxiliary seed ``seed * 0x9E3779B9 + salt``),
    or, for ``rp`` None, their primal values (the detached direction and
    1), which trace nothing."""
    if rp is None:
        return ray.d.detach(), torch.ones_like(ray.o[..., 0])
    return prb._warp(sc, rp, seed * prb._GOLDEN + salt, ray, active, lane0)


def _attached_L(sc, sampler, ray: Ray, seed: int, emitter_samples: int,
                bsdf_samples: int, rp: Optional[dict], lane0: int):
    """The attached direct-illumination estimate of lanes [lane0, lane0 +
    N) (JAX ``_attached_L``, :37-182), drawing from ``sampler`` as
    ``integrators/direct.py`` does: (L (N, 3), the camera ray's warped
    direction d0, its divergence det0).  With ``rp`` None the sites take
    their primal values and no auxiliary ray is traced."""
    n = ray.o.shape[0]
    ek, env = sc.static.emitter_kinds, sc.static.env_texture
    textures = sc.bsdf_textures()
    textures_d = {i: t.detach() for i, t in textures.items()}
    bsdfs_d = {k: v.detach() for k, v in sc.bsdfs.items()}
    ones = torch.ones(n, dtype=torch.bool, device=ray.o.device)

    # the camera ray's site: the hit of the detached ray, its surface
    # re-attached along the warped direction
    d0, det0 = _site(sc, rp, seed, 11, ray, ones, lane0)
    ray_rep = Ray.make(ray.o, d0)
    pi = sc.ray_intersect_preliminary(ray)
    si = I.compute_surface_interaction(sc, ray_rep, pi, RayFlags.All)
    si_f = I.compute_surface_interaction(sc, ray_rep, pi,
                                         RayFlags.All | RayFlags.FollowShape)
    si_d = si.detach()
    active = si.valid
    frac_lum = emitter_samples / (emitter_samples + bsdf_samples)
    frac_bsdf = bsdf_samples / (emitter_samples + bsdf_samples)

    L = E.eval_hit(sc.emitters, si.emitter_index, si.wi[..., 2],
                   uv=si.uv, kinds_present=sc.static.emitter_kinds)
    L = L + E.eval_env(sc.emitters, ek, d0, ~si.valid, sc.textures, env)
    smooth = B.has_flag(B.flags_of(sc.bsdfs, si.bsdf_index),
                        B.BSDFFlags.Smooth) & active

    for k in range(emitter_samples):
        sampler, s2 = smp.next_2d(sampler)
        ds, em_w_att = E.sample_direction(
            sc.emitters, ek, si.p.detach(), s2, sc.vertices, sc.faces,
            sc.em_faces, sc.textures, env)
        a_em = smooth & (ds.pdf != 0.0)
        occ = sc.ray_test(si_d.spawn_ray(ds.d.detach()).replace(
            maxt=(ds.dist * (1.0 - 1e-3)).detach()))
        a_em = a_em & ~occ
        em_weight = prb.attached_emitter_weight(
            sc, ds, m.normalize(ds.p - si.p), em_w_att)
        # the shadow ray's site, from the receiver following its shape
        ray_em = Ray.make(si_f.p, m.normalize(ds.p.detach() - si_f.p))
        d_em, det_em = _site(sc, rp, seed, 13 + 4 * k, ray_em, a_em, lane0)
        val_b, pdf_b = B.eval_pdf(sc.bsdfs, sc.static.bsdf_kinds,
                                  si.bsdf_index, si.wi, si.to_local(d_em),
                                  a_em, uv=si.uv, textures=textures,
                                  vcolor=si.vcolor)
        w = torch.where(ds.delta, 1.0,
                        common.mis_weight(ds.pdf * frac_lum,
                                          pdf_b * frac_bsdf))
        contrib = val_b * em_weight * (w * det_em
                                       / emitter_samples)[..., None]
        L = L + torch.where(a_em[..., None], contrib, 0.0)

    for k in range(bsdf_samples):
        sampler, s1 = smp.next_1d(sampler)
        sampler, s2 = smp.next_2d(sampler)
        # the sampled direction, detached (JAX :186-189)
        bs, w_det, ok = B.sample(bsdfs_d, sc.static.bsdf_kinds,
                                 si.bsdf_index, si_d.wi, s1, s2, active,
                                 uv=si_d.uv, textures=textures_d,
                                 vcolor=si_d.vcolor)
        d_world = si_d.to_world(bs.wo)
        # the attached weight: the BSDF value over the detached pdf
        val_b, pdf_b = B.eval_pdf(sc.bsdfs, sc.static.bsdf_kinds,
                                  si.bsdf_index, si.wi, si.to_local(d_world),
                                  ok, uv=si.uv, textures=textures,
                                  vcolor=si.vcolor)
        delta = B.has_flag(bs.sampled_type, B.BSDFFlags.Delta)
        pdf_bd = pdf_b.detach()
        bsdf_weight = torch.where(
            (pdf_bd > 0.0)[..., None],
            val_b / torch.clamp(pdf_bd, min=1e-20)[..., None], 0.0)
        # a delta lobe's eval_pdf is zero: its sampled weight, detached
        bsdf_weight = torch.where(delta[..., None], w_det.detach(),
                                  bsdf_weight)
        # the BSDF ray's site, from the receiver following its shape
        d_b, det_b = _site(sc, rp, seed, 15 + 4 * k,
                           Ray.make(si_f.p, d_world), ok, lane0)
        ray2 = Ray.make(si_f.p + (si_d.spawn_ray(d_world).o - si_d.p), d_b)
        si2 = I.compute_surface_interaction(
            sc, ray2, sc.ray_intersect_preliminary(ray2), RayFlags.All)
        le = E.eval_hit(sc.emitters, si2.emitter_index, si2.wi[..., 2],
                        uv=si2.uv, kinds_present=sc.static.emitter_kinds)
        le = le + E.eval_env(sc.emitters, ek, d_b, ~si2.valid, sc.textures,
                             env)
        pdf_em = E.pdf_direction(
            {c: v.detach() for c, v in sc.emitters.items()}, ek,
            si_d.p, ray2.d.detach(), si2.emitter_index, si2.p.detach(),
            si2.n.detach(), sc.vertices.detach(), sc.faces, sc.em_faces,
            ok, tuple(t.detach() for t in sc.textures), env)
        w = torch.where(delta, 1.0,
                        common.mis_weight(bs.pdf * frac_bsdf,
                                          pdf_em * frac_lum))
        L = L + torch.where(ok[..., None],
                            bsdf_weight * le
                            * (w * det_b / bsdf_samples)[..., None], 0.0)
    return L, d0, det0


def _emission_L(sc, sampler, ray: Ray, seed: int, rp: Optional[dict],
                lane0: int):
    """The emission the camera ray sees (JAX ``_emission_L``, :255-286):
    (L (N, 3), d0, det0), the primal hit from the detached ray, the
    surface re-attached along the warped direction."""
    n = ray.o.shape[0]
    ones = torch.ones(n, dtype=torch.bool, device=ray.o.device)
    d0, det0 = _site(sc, rp, seed, 11, ray, ones, lane0)
    pi = sc.ray_intersect_preliminary(ray)
    si = I.compute_surface_interaction(sc, Ray.make(ray.o, d0), pi,
                                       RayFlags.All)
    L = E.eval_hit(sc.emitters, si.emitter_index, si.wi[..., 2],
                   uv=si.uv, kinds_present=sc.static.emitter_kinds)
    L = L + E.eval_env(sc.emitters, sc.static.emitter_kinds, d0, ~si.valid,
                       sc.textures, sc.static.env_texture)
    return L, d0, det0


def _estimator(kind: str, cfg):
    """(sc, sampler, ray, seed, rp, lane0) -> (L, d0, det0) of ``kind``."""
    if kind == "emission_reparam":
        return _emission_L
    es, bs = cfg

    def est(sc, sampler, ray, seed, rp, lane0):
        return _attached_L(sc, sampler, ray, seed, es, bs, rp, lane0)
    return est


def _film_splat(sc, est, seed: int, sensor_idx: int, spp: int, pos,
                rp: Optional[dict], a: int, b: int):
    """The attached film splat of lanes [a, b) (JAX :215-241): the camera
    rays re-sampled from the same stream through the scene ``sc``'s
    sensor, the estimate ``est``, its value splatted at the re-projected
    warped direction (the detached ``pos`` where the sensor kind has
    none) with the camera divergence as an extra weight.  (data, w)."""
    sensor = sc.sensors[sensor_idx]
    smp_c = smp.seed(seed, b - a, kind=sc.static.sampler_kind, spp=spp,
                     lane_offset=a, device=sc.device)
    smp_c, ray, weight, _ = common.sample_rays(sensor, smp_c, spp,
                                               lane_offset=a)
    L, d0, det0 = est(sc, smp_c, ray, seed, rp, a)
    pos_att = S.point_to_film(sensor, ray.o + d0)
    if pos_att is None:
        pos_att = pos[a:b]
    rfilter = "gaussian" if sensor.rfilter == "box" else sensor.rfilter
    return films.splat(pos_att, L * weight.detach(), sensor.width,
                       sensor.height, rfilter, extra_weight=det0)


def _primal(scene, kind, seed, sensor_idx, spp, cfg):
    if kind == "direct_reparam":
        return D.render_direct(scene, seed, sensor_idx, spp, *cfg)
    with torch.no_grad():
        sensor, _, sampler, ray, weight, pos = common.camera(
            scene, seed, sensor_idx, spp)
        L, _, _ = _emission_L(scene, sampler, ray, seed, None, 0)
        return common.film(sensor, L * weight, pos, spp)


def render_backward(scene, names, kind: str, seed: int, sensor_idx: int,
                    spp: int, cfg, rp: dict, g_img):
    """The gradient of sum(image * g_img) w.r.t. the leaves ``names``
    through the attached estimator of ``kind``, in lane chunks of
    ``prb.REPARAM_CHUNK``."""
    sc, order = prb._attached(scene, names)
    grads = {k: torch.zeros_like(v) for k, v in zip(names, order)}
    est = _estimator(kind, cfg)
    step = prb.REPARAM_CHUNK
    with torch.no_grad():
        _, n, _, _, _, pos = common.camera(scene, seed, sensor_idx, spp)
        data = w = 0.0
        for a in range(0, n, step):
            data_c, w_c = _film_splat(scene, est, seed, sensor_idx, spp, pos,
                                      None, a, min(n, a + step))
            data, w = data + data_c, w + w_c
        coefs = prb.develop_coefs(data, w, g_img)
    for a in range(0, n, step):
        with torch.enable_grad():
            obj = prb.develop_objective(coefs, *_film_splat(
                sc, est, seed, sensor_idx, spp, pos, rp, a,
                min(n, a + step)))
            if obj.requires_grad:
                prb._add(grads, names, torch.autograd.grad(
                    obj, order, allow_unused=True))
    return grads


class _Render(torch.autograd.Function):
    """``_make_render`` / ``_make_emission_render``'s custom_vjp (JAX
    :185-247, :289-374): the forward is the detached primal, the backward
    the attached estimator's gradient of each leaf that requires grad."""

    @staticmethod
    def forward(ctx, scene, args, names, *leaves):
        kind, seed, sensor_idx, spp, cfg, _ = args
        ctx.scene, ctx.args, ctx.names = scene, args, names
        return _primal(scene, kind, seed, sensor_idx, spp, cfg)

    @staticmethod
    def backward(ctx, g_img):
        kind, seed, sensor_idx, spp, cfg, rp = ctx.args
        grads = render_backward(ctx.scene, ctx.names, kind, seed,
                                sensor_idx, spp, cfg, rp,
                                g_img.contiguous())
        return (None, None, None, *(grads[k] for k in ctx.names))


def _render(scene, kind, seed, sensor_idx, spp, cfg, rp_items):
    rp = prb.reparam_config(rp_items)
    leaves = scene.leaves()
    names = tuple(k for k, v in leaves.items() if v.requires_grad)
    args = (kind, seed, sensor_idx, spp, cfg, rp)
    if torch.is_grad_enabled() and names:
        return _Render.apply(scene, args, names, *(leaves[k] for k in names))
    return _primal(scene, kind, seed, sensor_idx, spp, cfg)


def render_direct_reparam(scene, seed: int = 0, sensor_idx: int = 0,
                          spp: int = 16, emitter_samples: int = 1,
                          bsdf_samples: int = 1, rp_items=()) -> torch.Tensor:
    """One pass of ``direct_reparam`` (JAX ``render_direct_reparam``): the
    (H, W, 3) image of ``integrators/direct.py``, differentiable through
    the reparameterised attached estimator w.r.t. every leaf that
    requires grad.  ``rp_items``: the settings ``prb.reparam_config``
    reads (num_rays, kappa, exponent)."""
    return _render(scene, "direct_reparam", seed, sensor_idx, spp,
                   (emitter_samples, bsdf_samples), rp_items)


def render_emission_reparam(scene, seed: int = 0, sensor_idx: int = 0,
                            spp: int = 16, rp_items=()) -> torch.Tensor:
    """One pass of ``emission_reparam`` (JAX ``render_emission_reparam``):
    the emission the camera rays see, differentiable through the camera
    ray's reparameterisation."""
    return _render(scene, "emission_reparam", seed, sensor_idx, spp, (),
                   rp_items)
