"""Sampling warps used by the primal path tracer (counterpart of
``core/warp.py``): the hemisphere, sphere, cone and triangle warps, and
GGX's visible-normal sampling with its NDF, Smith G1 and pdf.  The
Beckmann distribution and the classic ``square_to_ggx`` are not ported
(``models/bsdf.py`` raises for Beckmann)."""
from __future__ import annotations

import math

import torch

from . import math as m

_INV_PI = 1.0 / math.pi
_INV_TWO_PI = 0.5 / math.pi
_INV_FOUR_PI = 0.25 / math.pi


def square_to_uniform_disk_concentric(sample: torch.Tensor) -> torch.Tensor:
    """Concentric (Shirley) square -> disk mapping (warp.h:190-216)."""
    x = 2.0 * sample[..., 0] - 1.0
    y = 2.0 * sample[..., 1] - 1.0
    is_zero = (x == 0.0) & (y == 0.0)
    quadrant_1_or_3 = torch.abs(x) < torch.abs(y)
    r = torch.where(quadrant_1_or_3, y, x)
    rp = torch.where(quadrant_1_or_3, x, y)
    phi = 0.25 * math.pi * rp / torch.where(r == 0.0, 1.0, r)
    phi = torch.where(quadrant_1_or_3, 0.5 * math.pi - phi, phi)
    phi = torch.where(is_zero, 0.0, phi)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_cosine_hemisphere(sample: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere via the concentric disk (warp.h:539)."""
    p = square_to_uniform_disk_concentric(sample)
    z = m.safe_sqrt(1.0 - p[..., 0] * p[..., 0] - p[..., 1] * p[..., 1])
    return torch.cat([p, z[..., None]], dim=-1)


def square_to_cosine_hemisphere_pdf(v: torch.Tensor) -> torch.Tensor:
    return _INV_PI * torch.clamp(v[..., 2], min=0.0)


def square_to_uniform_sphere(sample: torch.Tensor) -> torch.Tensor:
    """Uniform sphere (warp.h:478): z = 1 - 2 s1, uniform azimuth."""
    z = 1.0 - 2.0 * sample[..., 1]
    r = m.safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * sample[..., 0]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_sphere_pdf(v: torch.Tensor) -> torch.Tensor:
    return torch.full(v.shape[:-1], _INV_FOUR_PI, dtype=v.dtype,
                      device=v.device)


def square_to_uniform_hemisphere(sample: torch.Tensor) -> torch.Tensor:
    z = sample[..., 1]
    r = m.safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * sample[..., 0]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_hemisphere_pdf(v: torch.Tensor) -> torch.Tensor:
    return torch.full(v.shape[:-1], _INV_TWO_PI, dtype=v.dtype,
                      device=v.device)


def square_to_uniform_cone(sample: torch.Tensor, cos_cutoff) -> torch.Tensor:
    """Uniform direction inside a cone around +Z (warp.h:344)."""
    one_minus = 1.0 - cos_cutoff
    cos_theta = 1.0 - one_minus * sample[..., 1]
    sin_theta = m.safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = 2.0 * math.pi * sample[..., 0]
    return torch.stack([sin_theta * torch.cos(phi),
                        sin_theta * torch.sin(phi), cos_theta], dim=-1)


def square_to_uniform_cone_pdf(cos_cutoff):
    return _INV_TWO_PI / (1.0 - cos_cutoff)


def square_to_uniform_triangle(sample: torch.Tensor) -> torch.Tensor:
    """Uniform barycentrics on the standard triangle (warp.h:280-292)."""
    t = m.safe_sqrt(1.0 - sample[..., 0])
    return torch.stack([1.0 - t, t * sample[..., 1]], dim=-1)


def _alpha(alpha, like: torch.Tensor) -> torch.Tensor:
    """A roughness (a number, or a tensor of the lanes' shape) broadcast
    to the lanes of ``like`` (..., 3)."""
    a = torch.as_tensor(alpha, dtype=like.dtype, device=like.device)
    return torch.broadcast_to(a, like.shape[:-1])


def ggx_visible_normal_sample(wi: torch.Tensor, sample: torch.Tensor,
                              alpha_u, alpha_v) -> torch.Tensor:
    """GGX visible-normal sampling (Heitz 2018, microfacet.h:331-375):
    the micro-normal m for ``wi`` in the local shading frame; ``wi`` from
    below the surface is sampled as -wi."""
    alpha = torch.stack([_alpha(alpha_u, wi), _alpha(alpha_v, wi)], dim=-1)
    # 1. stretch wi
    wi_p = m.normalize(torch.cat([wi[..., :2] * alpha, wi[..., 2:3]],
                                 dim=-1))
    flip = wi_p[..., 2] < 0.0
    wi_p = torch.where(flip[..., None], -wi_p, wi_p)
    # 2. an orthonormal basis around wi_p
    lensq = wi_p[..., 0] ** 2 + wi_p[..., 1] ** 2
    t1_rot = (torch.stack([-wi_p[..., 1], wi_p[..., 0],
                           torch.zeros_like(lensq)], dim=-1)
              * m.safe_rsqrt(lensq)[..., None])
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=wi.dtype, device=wi.device)
    t1 = torch.where((lensq > 1e-7)[..., None], t1_rot,
                     torch.broadcast_to(ex, wi_p.shape))
    t2 = m.cross(wi_p, t1)
    # 3. a point on the projected disk
    p = square_to_uniform_disk_concentric(sample)
    s = 0.5 * (1.0 + wi_p[..., 2])
    p1 = p[..., 0]
    p2 = (1.0 - s) * m.safe_sqrt(1.0 - p[..., 0] ** 2) + s * p[..., 1]
    # 4. reproject onto the hemisphere
    p3 = m.safe_sqrt(1.0 - p1 ** 2 - p2 ** 2)
    n_h = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * wi_p
    # 5. unstretch
    return m.normalize(torch.cat(
        [alpha * n_h[..., :2], torch.clamp(n_h[..., 2:3], min=1e-6)],
        dim=-1))


def ggx_ndf(mvec: torch.Tensor, alpha_u, alpha_v) -> torch.Tensor:
    """The GGX normal distribution D(m) (microfacet.h ``eval``)."""
    alpha_u, alpha_v = _alpha(alpha_u, mvec), _alpha(alpha_v, mvec)
    alpha_uv = alpha_u * alpha_v
    beta = ((mvec[..., 0] / alpha_u) ** 2 + (mvec[..., 1] / alpha_v) ** 2
            + mvec[..., 2] ** 2)
    # safe_div: beta is 0 for the zero half vector of antipodal wi, wo
    result = m.safe_div(torch.ones_like(beta),
                        math.pi * alpha_uv * beta * beta)
    return torch.where(mvec[..., 2] > 0.0, result, 0.0)


def ggx_smith_g1(v: torch.Tensor, mvec: torch.Tensor, alpha_u,
                 alpha_v) -> torch.Tensor:
    """Smith's masking G1 for GGX (microfacet.h ``smith_g1``)."""
    alpha_u, alpha_v = _alpha(alpha_u, v), _alpha(alpha_v, v)
    xy_alpha_2 = (alpha_u * v[..., 0]) ** 2 + (alpha_v * v[..., 1]) ** 2
    tan_theta_alpha_2 = m.safe_div(xy_alpha_2, v[..., 2] ** 2)
    result = 2.0 / (1.0 + torch.sqrt(1.0 + tan_theta_alpha_2))
    result = torch.where(xy_alpha_2 == 0.0, 1.0, result)
    # perpendicular incidence with respect to m
    return torch.where(m.dot(v, mvec) * v[..., 2] <= 0.0, 0.0, result)


def ggx_pdf_visible(wi: torch.Tensor, mvec: torch.Tensor, alpha_u,
                    alpha_v) -> torch.Tensor:
    """The pdf of visible-normal sampling, G1(wi) |wi.m| D(m) / |cos
    theta_i|."""
    d = ggx_ndf(mvec, alpha_u, alpha_v)
    g1 = ggx_smith_g1(wi, mvec, alpha_u, alpha_v)
    return m.safe_div(d * g1 * torch.abs(m.dot(wi, mvec)),
                      torch.abs(wi[..., 2]))
