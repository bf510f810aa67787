"""Sampling warps used by the path tracers (counterpart of
``core/warp.py``): the hemisphere, sphere, cone and triangle warps, the
classic GGX and Beckmann normal sampling, and the visible-normal sampling
of both microfacet distributions with their NDF, Smith G1 and pdf.

The Beckmann visible-slope sampler inverts its CDF with
``torch.special.erf`` / ``erfinv``, which round differently from XLA's
float32 approximations: the tests hold it at the tolerance they state
(``ROADMAP.md`` queue 3)."""
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


def square_to_ggx(sample: torch.Tensor, alpha_u, alpha_v) -> torch.Tensor:
    """Classic (not visible-normal) GGX normal sampling (:94-106):
    tan^2 theta = alpha_u alpha_v u / (1 - u)."""
    phi = 2.0 * math.pi * sample[..., 0]
    alpha2 = alpha_u * alpha_v
    tan_theta2 = alpha2 * sample[..., 1] / torch.clamp(1.0 - sample[..., 1],
                                                       min=1e-20)
    cos_theta = 1.0 / torch.sqrt(1.0 + tan_theta2)
    sin_theta = m.safe_sqrt(1.0 - cos_theta * cos_theta)
    return torch.stack([sin_theta * torch.cos(phi),
                        sin_theta * torch.sin(phi), cos_theta], dim=-1)


def square_to_beckmann(sample: torch.Tensor, alpha_u,
                       alpha_v) -> torch.Tensor:
    """Classic Beckmann normal sampling (:109-120): tan^2 theta =
    -ln(1 - u) / (cos^2 phi / alpha_u^2 + sin^2 phi / alpha_v^2)."""
    phi = 2.0 * math.pi * sample[..., 0]
    cos_phi, sin_phi = torch.cos(phi), torch.sin(phi)
    inv_a2 = (cos_phi / alpha_u) ** 2 + (sin_phi / alpha_v) ** 2
    tan_theta2 = -torch.log(torch.clamp(1.0 - sample[..., 1],
                                        min=1e-20)) / inv_a2
    cos_theta = 1.0 / torch.sqrt(1.0 + tan_theta2)
    sin_theta = m.safe_sqrt(1.0 - cos_theta * cos_theta)
    return torch.stack([sin_theta * cos_phi, sin_theta * sin_phi,
                        cos_theta], dim=-1)


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


def beckmann_ndf(mvec: torch.Tensor, alpha_u, alpha_v) -> torch.Tensor:
    """The Beckmann distribution D(m) (microfacet.h ``eval``, :123-129)."""
    alpha_u, alpha_v = _alpha(alpha_u, mvec), _alpha(alpha_v, mvec)
    cos2 = mvec[..., 2] ** 2
    e = m.safe_div((mvec[..., 0] / alpha_u) ** 2
                   + (mvec[..., 1] / alpha_v) ** 2, cos2)
    result = m.safe_div(torch.exp(-e),
                        math.pi * alpha_u * alpha_v * cos2 * cos2)
    return torch.where(mvec[..., 2] > 0.0, result, 0.0)


def beckmann_smith_g1(v: torch.Tensor, mvec: torch.Tensor, alpha_u,
                      alpha_v) -> torch.Tensor:
    """Smith's G1 for Beckmann, Walter's rational approximation
    (microfacet.h ``smith_g1``, :132-144)."""
    alpha_u, alpha_v = _alpha(alpha_u, v), _alpha(alpha_v, v)
    xy_alpha_2 = (alpha_u * v[..., 0]) ** 2 + (alpha_v * v[..., 1]) ** 2
    tan_theta_alpha = m.safe_sqrt(m.safe_div(xy_alpha_2, v[..., 2] ** 2))
    a = m.safe_div(torch.ones_like(tan_theta_alpha), tan_theta_alpha)
    result = torch.where(
        a >= 1.6, 1.0,
        (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a))
    result = torch.where(xy_alpha_2 == 0.0, 1.0, result)
    return torch.where(m.dot(v, mvec) * v[..., 2] <= 0.0, 0.0, result)


def beckmann_pdf(mvec: torch.Tensor, alpha_u, alpha_v) -> torch.Tensor:
    """The pdf of classic Beckmann sampling, D(m) cos theta_m."""
    return beckmann_ndf(mvec, alpha_u, alpha_v) * torch.clamp(
        mvec[..., 2], min=0.0)


_SQRT_PI_INV = 0.5641895835477563


def _beckmann_sample_visible_11(cos_theta_i, u1, u2):
    """Visible-slope sampling of the Beckmann distribution at unit
    roughness (Heitz and d'Eon 2014; microfacet.h ``sample_visible_11``,
    :153-200): ten fixed Newton-bisection steps on the erf-domain CDF, no
    early exit; a Gaussian slope where cos theta_i > 0.9999.  A
    derivative of magnitude <= 1e-12 is replaced by ``sign * 1e-12 +
    1e-12``, which is 0 for a negative one, as in the reference."""
    cos_i = torch.clamp(cos_theta_i, -1.0, 1.0)
    sin_i = m.safe_sqrt(1.0 - cos_i * cos_i)
    tan_i = sin_i / torch.clamp(cos_i, min=1e-6)
    cot_i = 1.0 / torch.clamp(tan_i, min=1e-6)

    c = torch.special.erf(cot_i)
    sample_x = torch.clamp(u1, min=1e-6)
    # safe_acos: arccos of the clamped cosine, with a zero derivative at
    # the pole, where the reference's arccos gives 0 * inf = NaN
    theta_i = m.safe_acos(cos_i)
    fit = 1.0 + theta_i * (-0.876 + theta_i * (0.4265 - 0.0594 * theta_i))
    b = c - (1.0 + c) * torch.pow(1.0 - sample_x, fit)
    norm = 1.0 / (1.0 + c + _SQRT_PI_INV * tan_i * torch.exp(-cot_i * cot_i))

    a, cc = torch.full_like(b, -1.0), c
    for _ in range(10):
        b = torch.where((b >= a) & (b <= cc), b, 0.5 * (a + cc))
        inv_erf = torch.special.erfinv(torch.clamp(b, -0.9999, 0.9999))
        value = norm * (1.0 + b + _SQRT_PI_INV * tan_i
                        * torch.exp(-inv_erf * inv_erf)) - sample_x
        derivative = norm * (1.0 - inv_erf * tan_i)
        cc = torch.where(value > 0.0, b, cc)
        a = torch.where(value > 0.0, a, b)
        b = b - value / torch.where(torch.abs(derivative) > 1e-12, derivative,
                                    torch.sign(derivative) * 1e-12 + 1e-12)
    b = torch.minimum(torch.maximum(b, a), cc)
    slope_x = torch.special.erfinv(torch.clamp(b, -0.9999, 0.9999))
    slope_y = torch.special.erfinv(torch.clamp(
        2.0 * torch.clamp(u2, min=1e-6) - 1.0, -0.9999, 0.9999))

    # near normal incidence the slopes are Gaussian
    r = torch.sqrt(-torch.log(torch.clamp(1.0 - u1, min=1e-20)))
    phi = 2.0 * math.pi * u2
    near_normal = cos_i > 0.9999
    slope_x = torch.where(near_normal, r * torch.cos(phi), slope_x)
    slope_y = torch.where(near_normal, r * torch.sin(phi), slope_y)
    return slope_x, slope_y


def beckmann_visible_normal_sample(wi: torch.Tensor, sample: torch.Tensor,
                                   alpha_u, alpha_v) -> torch.Tensor:
    """Beckmann visible-normal sampling (microfacet.h ``sample``,
    :203-230): stretch ``wi``, sample the slope at unit roughness, rotate
    and unstretch; ``wi`` from below the surface is sampled as -wi."""
    alpha = torch.stack([_alpha(alpha_u, wi), _alpha(alpha_v, wi)], dim=-1)
    wi_p = m.normalize(torch.cat([wi[..., :2] * alpha, wi[..., 2:3]],
                                 dim=-1))
    flip = wi_p[..., 2] < 0.0
    wi_p = torch.where(flip[..., None], -wi_p, wi_p)

    sin2 = wi_p[..., 0] ** 2 + wi_p[..., 1] ** 2
    inv_len = m.safe_rsqrt(torch.clamp(sin2, min=1e-20))
    cos_phi = torch.where(sin2 > 1e-14, wi_p[..., 0] * inv_len, 1.0)
    sin_phi = torch.where(sin2 > 1e-14, wi_p[..., 1] * inv_len, 0.0)

    sx, sy = _beckmann_sample_visible_11(wi_p[..., 2], sample[..., 0],
                                         sample[..., 1])
    rx = (cos_phi * sx - sin_phi * sy) * alpha[..., 0]
    ry = (sin_phi * sx + cos_phi * sy) * alpha[..., 1]
    return m.normalize(torch.stack([-rx, -ry, torch.ones_like(rx)], dim=-1))


def beckmann_pdf_visible(wi: torch.Tensor, mvec: torch.Tensor, alpha_u,
                         alpha_v) -> torch.Tensor:
    """The pdf of Beckmann visible-normal sampling, G1(wi) |wi.m| D(m) /
    |cos theta_i|."""
    d = beckmann_ndf(mvec, alpha_u, alpha_v)
    g1 = beckmann_smith_g1(wi, mvec, alpha_u, alpha_v)
    return m.safe_div(d * g1 * torch.abs(m.dot(wi, mvec)),
                      torch.abs(wi[..., 2]))
