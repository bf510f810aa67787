"""Ray reparameterisation for moving-discontinuity gradients (counterpart
of ``ad/reparam.py``; "Unbiased Warped-Area Sampling for Differentiable
Rendering", Bangaru, Li and Durand 2020).

``reparameterize_ray`` traces ``num_rays`` auxiliary rays from a von
Mises-Fisher lobe about the input direction, intersects them with
``FollowShape`` semantics (the hit point moves rigidly with its
triangle), and builds the attached warp field V / Z and its divergence.
The primal values are the input direction and 1; the gradients flow
through the auxiliary hit points (``replace_grad``).  The auxiliary rays
are closest-hit queries through ``Scene.ray_intersect_preliminary``:
kernel K1 (``mt_closest_hit``) on scenes of at most
``ops/accel.py`` ``BRUTE_FORCE_MAX_TRIS`` triangles, K2
(``bvh4_closest_hit``) on BVH scenes; one launch an auxiliary ray set.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import math as m
from ..models import samplers as smp
from ..models.records import Ray, RayFlags
from ..ops import intersect as I


def boundary_test(scene, si, ray_d: torch.Tensor) -> torch.Tensor:
    """Silhouette proximity B (mesh.cpp:840-886 ``BoundaryTest``): 0 at a
    silhouette, so the harmonic weights concentrate there.  The grazing
    term ``dot(sh_n, -d)^2``, and where ``scene.face_open`` is given the
    barycentric distance to the hit triangle's open edges (edge opposite
    vertex k ~ 3 b_k, 1 at the barycentre), the smaller of the two; 1 on a
    miss (JAX ``ad/reparam.py:25-62``)."""
    dp = m.dot(si.sh_n, -ray_d)
    b_graze = dp * dp
    face_open = scene.face_open
    if face_open is None or face_open.shape[0] == 0:
        return torch.where(si.valid, b_graze, 1.0)
    idx = torch.clamp(si.prim_index.long(), 0, face_open.shape[0] - 1)
    fo = face_open[idx].to(si.b0.dtype)
    b2 = 1.0 - si.b0 - si.b1
    bary = torch.stack([si.b0, si.b1, b2], -1)
    b_edge = torch.amin(torch.where(fo > 0.5, 3.0 * bary, 1.0), dim=-1)
    b = torch.where(si.ismesh > 0.5, torch.minimum(b_graze, b_edge),
                    b_graze)
    return torch.where(si.valid, b, 1.0)


def _exp_neg_2k(kappa: float) -> float:
    """exp(-2 kappa) in float32, as the reference evaluates it."""
    with np.errstate(under="ignore"):
        return float(np.exp(np.float32(-2.0 * kappa)))


def square_to_von_mises_fisher(sample: torch.Tensor,
                               kappa: float) -> torch.Tensor:
    """The vMF lobe about +Z (warp.h ``square_to_von_mises_fisher``) in
    the stable form whose inverse density ``_sample_warp_field`` uses:
    ``z = 1 + log(sy + (1 - sy) e^{-2 kappa}) / kappa``."""
    sy = torch.clamp(sample[..., 1], 1e-7, 1.0 - 1e-7)
    z = 1.0 + torch.log(sy + (1.0 - sy) * _exp_neg_2k(kappa)) / kappa
    r = m.safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * sample[..., 0]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def _sample_warp_field(scene, sample: torch.Tensor, ray: Ray, d_frame,
                       kappa: float, exponent: float, flip: bool = False):
    """One auxiliary ray (reparam.py:10-124): (Z, dZ, V, div_lhs).  With
    ``flip`` the tangential components of the vMF sample are negated, the
    antithetic twin of the same draw (reparam.py:84-86).

    The weights are detached.  The inverse vMF density is
    ``1 / (sy + (1 - sy) e^{-2 kappa})``, the inverse of this file's
    warp, which maps sy -> 1 onto the axis; the reference's formula
    (reparam.py:113) assumes the opposite convention and would invert
    the harmonic weights."""
    omega = square_to_von_mises_fisher(sample, kappa)
    if flip:
        omega = omega * torch.tensor([-1.0, -1.0, 1.0], dtype=omega.dtype,
                                     device=omega.device)
    s_, t_ = d_frame
    d_det = ray.d.detach()
    aux_d = (s_ * omega[..., 0:1] + t_ * omega[..., 1:2]
             + d_det * omega[..., 2:3])
    aux_ray = Ray.make(ray.o, aux_d)

    pi = scene.ray_intersect_preliminary(aux_ray)
    si = I.compute_surface_interaction(
        scene, aux_ray, pi, RayFlags.All | RayFlags.FollowShape)
    V_direct = torch.where(si.valid[..., None],
                           m.normalize(si.p - ray.o), aux_d)

    B = boundary_test(scene, si, aux_d).detach()
    sy = torch.clamp(sample[..., 1], 1e-7, 1.0 - 1e-7)
    inv_vmf_density = 1.0 / (sy + (1.0 - sy) * _exp_neg_2k(kappa))
    w_denom = inv_vmf_density - 1.0 + B
    w_denom_rcp = torch.where(w_denom > 1e-4,
                              1.0 / torch.clamp(w_denom, min=1e-4), 0.0)
    w = (w_denom_rcp ** exponent) * inv_vmf_density
    tmp1 = torch.clamp(inv_vmf_density * w * w_denom_rcp * kappa * exponent,
                       -1e10, 1e10)
    tmp2 = s_ * omega[..., 0:1] + t_ * omega[..., 1:2]
    d_w_omega = tmp1[..., None] * tmp2
    return w, d_w_omega, w[..., None] * V_direct, m.dot(d_w_omega, V_direct)


def reparameterize_ray(scene, sampler, ray: Ray, active: torch.Tensor,
                       num_rays: int = 16, kappa: float = 1e5,
                       exponent: float = 3.0, antithetic: bool = True):
    """(sampler, d_reparam, det) (reparam.py:410-430
    ``reparameterize_rays``): the primal values are ``ray.d`` (detached)
    and 1; their gradients are the warp field's and its divergence's.

    ``antithetic``: each vMF draw is used twice, as drawn and mirrored, so
    ``num_rays`` must be even.  The radius variable is stratified over the
    ``pairs`` draws, ``sy = (i + s.y) / pairs``.  Z and dZ of the
    self-normalised estimator are detached.  Inactive lanes get the
    detached direction and 1."""
    if antithetic and num_rays % 2:
        # a pair evaluates both flips: an odd count would draw num_rays + 1
        # warp samples and change the self-normalised estimator
        raise ValueError("antithetic reparameterization requires an even "
                         f"num_rays (got {num_rays})")
    d_det = ray.d.detach()
    s_, t_ = m.coordinate_system(d_det)
    pairs = (num_rays + 1) // 2 if antithetic else num_rays
    n = ray.o.shape[0]
    Z = torch.zeros(n, dtype=d_det.dtype, device=d_det.device)
    dZ = torch.zeros((n, 3), dtype=d_det.dtype, device=d_det.device)
    V = torch.zeros_like(dZ)
    div_lhs = torch.zeros_like(Z)
    flips = (False, True) if antithetic else (False,)
    for i in range(pairs):
        sampler, s2 = smp.next_2d(sampler)
        sy = (float(i) + s2[..., 1]) / float(pairs)
        s2 = torch.stack([s2[..., 0], sy], -1)
        for flip in flips:
            Z_i, dZ_i, V_i, div_i = _sample_warp_field(
                scene, s2, ray, (s_, t_), kappa, exponent, flip=flip)
            Z = Z + Z_i
            dZ = dZ + dZ_i
            V = V + V_i
            div_lhs = div_lhs + div_i

    inv_Z = 1.0 / torch.clamp(Z.detach(), min=1e-8)
    V_theta = V * inv_Z[..., None]
    div = (div_lhs - m.dot(V_theta, dZ.detach())) * inv_Z
    # direction = normalize(ray.d + V_theta) (reparam.py:283): an attached
    # incoming direction passes through (the sensor pose), and the warp
    # field's derivative is projected onto the tangent plane
    dir_att = m.normalize(ray.d + V_theta - V_theta.detach())
    d_r = I.replace_grad(d_det, dir_att)
    det = I.replace_grad(torch.ones_like(div), div)
    d_r = torch.where(active[..., None], d_r, d_det)
    det = torch.where(active, det, 1.0)
    return sampler, d_r, det
