"""Direct illumination (counterpart of ``integrators/direct.py``;
src/integrators/direct.cpp).

At the camera ray's first hit: the emission seen there, ``emitter_samples``
NEE samples and ``bsdf_samples`` BSDF samples, combined by the power
heuristic with the reference's weight split ``frac_lum`` / ``frac_bsdf``
(direct.cpp:98-116).  Each lane draws from the scene's sampler after its
camera draws: next_2d for each NEE sample, then next_1d and next_2d for
each BSDF sample.  The closest hits go to K1 or K2 and the shadow rays to
K1's any hit or K3 (``Scene.ray_intersect`` / ``Scene.ray_test``): one
closest-hit launch for the camera rays, one any-hit launch an NEE sample
and one closest-hit launch a BSDF sample.

The reference detaches the whole scene (:24), so ``direct``'s gradient
w.r.t. every leaf is zero: ``render_direct`` hands back zeros through
``torch.autograd`` (``common.detached``) rather than an image that no
leaf reaches.  The differentiable members of the family are
``ad/direct_reparam.py``'s.
"""
from __future__ import annotations

import torch

from ..models import bsdf as B
from ..models import emitters as E
from ..models import samplers as smp
from ..models.records import Ray
from . import common


@torch.no_grad()
def sample_direct(scene, sampler, ray: Ray, emitter_samples: int = 1,
                  bsdf_samples: int = 1):
    """The direct-illumination estimate of each lane (JAX ``sample_direct``,
    :22-84): (L (N, 3), valid (N,)), detached."""
    ek, env = scene.static.emitter_kinds, scene.static.env_texture
    textures = scene.bsdf_textures()
    si = scene.ray_intersect(ray)
    active = si.valid
    frac_lum = emitter_samples / (emitter_samples + bsdf_samples)
    frac_bsdf = bsdf_samples / (emitter_samples + bsdf_samples)

    # the emitters and the environment the camera ray sees
    L = E.eval_hit(scene.emitters, si.emitter_index, si.wi[..., 2])
    L = L + E.eval_env(scene.emitters, ek, ray.d, ~si.valid, scene.textures,
                       env)
    smooth = B.has_flag(B.flags_of(scene.bsdfs, si.bsdf_index),
                        B.BSDFFlags.Smooth) & active

    for _ in range(emitter_samples):
        sampler, s2 = smp.next_2d(sampler)
        ds, em_weight = E.sample_direction(
            scene.emitters, ek, si.p, s2, scene.vertices, scene.faces,
            scene.em_faces, scene.textures, env)
        a_em = smooth & (ds.pdf != 0.0)
        occ = scene.ray_test(si.spawn_ray(ds.d).replace(
            maxt=ds.dist * (1.0 - 1e-3)))
        val, pdf_b = B.eval_pdf(scene.bsdfs, scene.static.bsdf_kinds,
                                si.bsdf_index, si.wi, si.to_local(ds.d),
                                a_em, uv=si.uv, textures=textures,
                                vcolor=si.vcolor)
        w = torch.where(ds.delta, 1.0, common.mis_weight(
            ds.pdf * frac_lum, pdf_b * frac_bsdf))
        contrib = val * em_weight * (w / emitter_samples)[..., None]
        L = L + torch.where((a_em & ~occ)[..., None], contrib, 0.0)

    for _ in range(bsdf_samples):
        sampler, s1 = smp.next_1d(sampler)
        sampler, s2 = smp.next_2d(sampler)
        bs, weight, ok = B.sample(scene.bsdfs, scene.static.bsdf_kinds,
                                  si.bsdf_index, si.wi, s1, s2, active,
                                  uv=si.uv, textures=textures,
                                  vcolor=si.vcolor)
        ray2 = si.spawn_ray(si.to_world(bs.wo))
        si2 = scene.ray_intersect(ray2)
        le = E.eval_hit(scene.emitters, si2.emitter_index, si2.wi[..., 2])
        le = le + E.eval_env(scene.emitters, ek, ray2.d, ~si2.valid,
                             scene.textures, env)
        pdf_em = E.pdf_direction(
            scene.emitters, ek, si.p, ray2.d, si2.emitter_index, si2.p,
            si2.n, scene.vertices, scene.faces, scene.em_faces, ok,
            scene.textures, env)
        delta = B.has_flag(bs.sampled_type, B.BSDFFlags.Delta)
        w = torch.where(delta, 1.0, common.mis_weight(
            bs.pdf * frac_bsdf, pdf_em * frac_lum))
        L = L + torch.where(ok[..., None],
                            weight * le * (w / bsdf_samples)[..., None], 0.0)
    return L, si.valid


def _primal(scene, seed, sensor_idx, spp, emitter_samples, bsdf_samples):
    sensor, _, sampler, ray, weight, pos = common.camera(
        scene, seed, sensor_idx, spp)
    L, _ = sample_direct(scene, sampler, ray, emitter_samples, bsdf_samples)
    return common.film(sensor, L * weight, pos, spp)


def render_direct(scene, seed: int = 0, sensor_idx: int = 0, spp: int = 16,
                  emitter_samples: int = 1, bsdf_samples: int = 1
                  ) -> torch.Tensor:
    """One pass of ``direct`` (JAX ``render_direct``, :87-104): the (H, W,
    3) image.  Where grad mode is on and a scene leaf requires grad, each
    such leaf's gradient is zero (``common.detached``)."""
    return common.detached(scene, lambda: _primal(
        scene, seed, sensor_idx, spp, emitter_samples, bsdf_samples))
