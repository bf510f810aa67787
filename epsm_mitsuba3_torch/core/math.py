"""Vector math and orthonormal frames (counterpart of ``core/math.py``).

Vectors are ``(..., 3)`` tensors.  The guarded functions (``normalize``,
``safe_sqrt``, ``safe_rsqrt``, ``safe_acos``, ``safe_rcp``, ``safe_div``)
are ``torch.autograd.Function``s with the reference's custom tangent
rules, as a ``backward`` for reverse mode and a ``jvp`` for forward mode
(``torch.autograd.forward_ad``, ``ad/prb.py`` ``prb_forward``): their
primal is the plain clamped formula, and their derivative is finite
(zero) where the plain formula's would overflow float32, so a zero
cotangent on a masked lane never turns into ``0 * inf = NaN``.
"""
from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor, keepdim: bool = False):
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def squared_norm(a: torch.Tensor, keepdim: bool = False):
    return torch.sum(a * a, dim=-1, keepdim=keepdim)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _rsqrt(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.sqrt(x)


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    """Reduce a broadcast gradient back to an input's shape."""
    if g.shape == shape:
        return g
    lead = g.dim() - len(shape)
    g = g.sum(dim=tuple(range(lead))) if lead else g
    dims = tuple(i for i, s in enumerate(shape) if s == 1 and g.shape[i] != 1)
    return g.sum(dim=dims, keepdim=True) if dims else g


class _Normalize(torch.autograd.Function):
    """``a / |a|`` with ``|a|^2`` clamped to ``eps``; the tangent is
    detached where ``|a|^2 <= 1e-24`` (``_normalize_jvp``, :38-48)."""

    @staticmethod
    def forward(ctx, a, eps):
        n2 = squared_norm(a, keepdim=True)
        r = _rsqrt(torch.clamp(n2, min=eps))
        out = a * r
        ctx.save_for_backward(a, n2, r, out)
        ctx.save_for_forward(a, n2, r, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, n2, r, out = ctx.saved_tensors
        w = torch.where(n2 > 1e-24, g, 0.0)
        return w * r - a * (r * r * dot(w, out, keepdim=True)), None

    @staticmethod
    def jvp(ctx, da, _):
        a, n2, r, out = ctx.saved_tensors
        dn = dot(a, da, keepdim=True)
        return torch.where(n2 > 1e-24, da * r - out * (r * r * dn), 0.0)


class _SafeSqrt(torch.autograd.Function):
    """sqrt clamped to 0 below zero; zero derivative at and below zero
    (``_safe_sqrt_jvp``, :85-90)."""

    @staticmethod
    def forward(ctx, x):
        out = torch.sqrt(torch.clamp(x, min=0.0))
        ctx.save_for_backward(x, out)
        ctx.save_for_forward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return torch.where(x > 0.0, 0.5 * g / torch.clamp(out, min=1e-37),
                           0.0)

    jvp = backward      # elementwise: the tangent rule is the cotangent rule


class _SafeRsqrt(torch.autograd.Function):
    """1/sqrt with the argument clamped to 1e-37; detached where
    ``x <= 1e-24`` (``_safe_rsqrt_jvp``, :101-106)."""

    @staticmethod
    def forward(ctx, x):
        out = _rsqrt(torch.clamp(x, min=1e-37))
        ctx.save_for_backward(x, out)
        ctx.save_for_forward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return torch.where(x > 1e-24, -0.5 * out * out * out * g, 0.0)

    jvp = backward      # elementwise: the tangent rule is the cotangent rule


class _SafeAcos(torch.autograd.Function):
    """arccos of x clamped to [-1, 1]; zero derivative where
    ``|x| >= 1 - 1e-6`` (``_safe_acos_jvp``, :118-125)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)
        return torch.arccos(torch.clamp(x, -1.0, 1.0))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        xg = torch.clamp(x, -1.0 + 1e-6, 1.0 - 1e-6)
        return torch.where(torch.abs(x) < 1.0 - 1e-6,
                           -g * _rsqrt(1.0 - xg * xg), 0.0)

    jvp = backward      # elementwise: the tangent rule is the cotangent rule


class _SafeRcp(torch.autograd.Function):
    """1/x, and 0 where x == 0; derivative -out^2 (``_safe_rcp_jvp``,
    :143-147)."""

    @staticmethod
    def forward(ctx, x):
        nz = x != 0.0
        out = torch.where(nz, 1.0 / torch.where(nz, x, 1.0), 0.0)
        ctx.save_for_backward(out)
        ctx.save_for_forward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return -out * out * g

    jvp = backward      # elementwise: the tangent rule is the cotangent rule


class _SafeDiv(torch.autograd.Function):
    """``x / max(y, eps)``; the denominator's partial only where
    ``y > 1e-18`` (``_safe_div_jvp``, :156-165)."""

    @staticmethod
    def forward(ctx, x, y, eps):
        ctx.save_for_backward(x, y)
        ctx.save_for_forward(x, y)
        ctx.eps = eps
        return x / torch.clamp(y, min=eps)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        r = 1.0 / torch.clamp(y, min=ctx.eps)
        gx = gy = None
        if ctx.needs_input_grad[0]:
            gx = _sum_to(g * r, x.shape)
        if ctx.needs_input_grad[1]:
            gy = _sum_to(-torch.where(y > 1e-18, x * r * r, 0.0) * g,
                         y.shape)
        return gx, gy, None

    @staticmethod
    def jvp(ctx, dx, dy, _):
        x, y = ctx.saved_tensors
        r = 1.0 / torch.clamp(y, min=ctx.eps)
        return dx * r - torch.where(y > 1e-18, x * r * r, 0.0) * dy


def normalize(a: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """``a / |a|``, with ``|a|^2`` clamped to ``eps`` (1e-37 where eps is
    0)."""
    return _Normalize.apply(a, eps if eps > 0 else 1e-37)


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt clamped to 0 below zero."""
    return _SafeSqrt.apply(x)


def safe_rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1/sqrt with the argument clamped to 1e-37."""
    return _SafeRsqrt.apply(x)


def safe_acos(x: torch.Tensor) -> torch.Tensor:
    """arccos with the argument clamped to [-1, 1]."""
    return _SafeAcos.apply(x)


def safe_rcp(x: torch.Tensor) -> torch.Tensor:
    """Reciprocal that is 0 where ``x == 0``."""
    return _SafeRcp.apply(x)


def safe_div(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-20):
    """``x / max(y, eps)``."""
    return _SafeDiv.apply(x, y, eps)


def lerp(a, b, t):
    """``a (1 - t) + b t``."""
    return a * (1.0 - t) + b * t


def mulsign(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x * sign(s) with sign(0) == +1 (drjit ``mulsign``)."""
    return torch.where(s >= 0.0, x, -x)


def coordinate_system(n: torch.Tensor):
    """Orthonormal basis (s, t) around unit normal ``n`` (Duff et al. 2017,
    include/mitsuba/core/vector.h ``coordinate_system``)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign_ = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign_ + nz)
    b = nx * ny * a
    s = torch.stack([mulsign(nx * nx * a, nz) + 1.0,
                     mulsign(b, nz),
                     mulsign(-nx, nz)], dim=-1)
    t = torch.stack([b, ny * ny * a + sign_, -ny], dim=-1)
    return s, t


def to_local(n, s, t, v):
    """World -> frame coordinates: (v.s, v.t, v.n)."""
    return torch.stack([dot(v, s), dot(v, t), dot(v, n)], dim=-1)


def to_world(n, s, t, v):
    """Frame -> world coordinates."""
    return s * v[..., 0:1] + t * v[..., 1:2] + n * v[..., 2:3]


def reflect(wi: torch.Tensor) -> torch.Tensor:
    """Local-frame mirror reflection about n = (0, 0, 1): (-x, -y, z)."""
    return torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], dim=-1)


def reflect_m(wi: torch.Tensor, mvec: torch.Tensor) -> torch.Tensor:
    """``wi`` reflected about the (micro)normal ``mvec``: 2 <wi, m> m -
    wi."""
    return 2.0 * dot(wi, mvec, keepdim=True) * mvec - wi


def refract(wi: torch.Tensor, mvec: torch.Tensor, cos_theta_t: torch.Tensor,
            eta_ti: torch.Tensor) -> torch.Tensor:
    """``wi`` refracted about ``mvec`` (fresnel.h ``refract``): the signed
    cosine ``cos_theta_t`` on the transmitted side and the relative
    inverse index ``eta_ti``, both (...,)."""
    eta_ti = eta_ti[..., None]
    return (mvec * (dot(wi, mvec, keepdim=True) * eta_ti
                    + cos_theta_t[..., None]) - wi * eta_ti)


def fresnel(cos_theta_i: torch.Tensor, eta: torch.Tensor):
    """Unpolarized dielectric Fresnel term (fresnel.h ``fresnel``;
    ``fresnel``, :288-320).  Returns (F, cos_theta_t, eta_it, eta_ti),
    ``cos_theta_t`` signed opposite to ``cos_theta_i``; F is 1 under
    total internal reflection."""
    outside = cos_theta_i >= 0.0
    rcp_eta = 1.0 / eta
    eta_it = torch.where(outside, eta, rcp_eta)
    eta_ti = torch.where(outside, rcp_eta, eta)
    cos_theta_t_sqr = (-(-cos_theta_i * cos_theta_i + 1.0)
                       * (eta_ti * eta_ti) + 1.0)
    cos_i_abs = torch.abs(cos_theta_i)
    cos_t_abs = safe_sqrt(cos_theta_t_sqr)
    index_matched = eta == 1.0
    special_case = index_matched | (cos_i_abs == 0.0)
    r_sc = torch.where(index_matched, 0.0, 1.0)
    a_s = ((-eta_it * cos_t_abs + cos_i_abs)
           / (eta_it * cos_t_abs + cos_i_abs + 1e-37))
    a_p = ((-eta_it * cos_i_abs + cos_t_abs)
           / (eta_it * cos_i_abs + cos_t_abs + 1e-37))
    r = 0.5 * (a_s * a_s + a_p * a_p)
    r = torch.where(special_case, r_sc, r)
    r = torch.where(cos_theta_t_sqr <= 0.0, 1.0, r)
    cos_theta_t = mulsign(cos_t_abs, -cos_theta_i)
    return r, cos_theta_t, eta_it, eta_ti


def fresnel_conductor(cos_theta_i: torch.Tensor, eta: torch.Tensor,
                      k: torch.Tensor) -> torch.Tensor:
    """Unpolarized conductor Fresnel term (fresnel.h
    ``fresnel_conductor``; ``fresnel_conductor``, :323-346)."""
    cos_theta_i_2 = cos_theta_i * cos_theta_i
    sin_theta_i_2 = 1.0 - cos_theta_i_2
    sin_theta_i_4 = sin_theta_i_2 * sin_theta_i_2
    temp_1 = eta * eta - k * k - sin_theta_i_2
    a_2_pb_2 = safe_sqrt(temp_1 * temp_1 + 4.0 * k * k * eta * eta)
    a = safe_sqrt(0.5 * (a_2_pb_2 + temp_1))
    term_1 = a_2_pb_2 + cos_theta_i_2
    term_2 = 2.0 * cos_theta_i * a
    r_s = (term_1 - term_2) / (term_1 + term_2 + 1e-37)
    term_3 = a_2_pb_2 * cos_theta_i_2 + sin_theta_i_4
    term_4 = term_2 * sin_theta_i_2
    r_p = r_s * (term_3 - term_4) / (term_3 + term_4 + 1e-37)
    return 0.5 * (r_s + r_p)
