"""Mueller / Stokes polarization algebra (counterpart of ``core/mueller.py``;
include/mitsuba/render/mueller.h).

A Mueller matrix is a ``(..., 4, 4, C)`` tensor (C colour channels, 3 for
RGB), a Stokes vector ``(..., 4, C)``.  Achromatic elements (the
rotators) are built with C = 1 and broadcast.  Products are
``torch.einsum`` over the 4 x 4 axes with the channel axis carried along.

Conventions (mueller.h):

- the Stokes basis of a propagation direction ``w`` is the first axis of
  ``coordinate_system(w)`` (``stokes_basis``);
- ``rotator(theta)`` rotates the reference frame by ``theta``: its
  entries take ``2 theta`` (Stokes space double-covers rotations);
- ``specular_reflection`` and ``specular_transmission`` are in the s/p
  basis (the reference axis perpendicular to the plane of incidence) and
  are rotated into the implicit bases with ``rotate_mueller_basis``.

The complex Fresnel arithmetic is written out as (re, im) pairs, as the
reference writes it, so that the same float32 operations run.
"""
from __future__ import annotations

import torch

from . import math as m


def _t(x, like=None) -> torch.Tensor:
    """``x`` as a float tensor (``like``'s dtype and device where given)."""
    if isinstance(x, torch.Tensor):
        return x
    if like is not None:
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return torch.as_tensor(x, dtype=torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mueller x Mueller: (..., 4, 4, C) @ (..., 4, 4, C) -> (..., 4, 4, C);
    the channel axis broadcasts (C = 1 for the rotators)."""
    shp = torch.broadcast_shapes(a.shape, b.shape)
    return torch.einsum("...ikc,...kjc->...ijc", a.expand(shp),
                        b.expand(shp))


def matvec(mm: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Mueller x Stokes: (..., 4, 4, C) @ (..., 4, C) -> (..., 4, C)."""
    c = max(mm.shape[-1], s.shape[-1])
    batch = torch.broadcast_shapes(mm.shape[:-3], s.shape[:-2])
    return torch.einsum("...ikc,...kc->...ic",
                        mm.expand(batch + (4, 4, c)),
                        s.expand(batch + (4, c)))


def identity(shape=(), channels: int = 1, dtype=torch.float32,
             device=None) -> torch.Tensor:
    eye = torch.eye(4, dtype=dtype, device=device)[..., None]
    return eye.expand(tuple(shape) + (4, 4, channels))


def _assemble(*entries) -> torch.Tensor:
    """Stack 16 (..., C) entries, row-major, into (..., 4, 4, C)."""
    entries = torch.broadcast_tensors(*entries)
    rows = [torch.stack(entries[4 * r:4 * r + 4], dim=-2) for r in range(4)]
    return torch.stack(rows, dim=-3)


def depolarizer(value: torch.Tensor) -> torch.Tensor:
    """Ideal depolarizer scaled by ``value`` (mueller.h depolarizer): only
    M[0, 0] = value.  (..., C) -> (..., 4, 4, C)."""
    z = torch.zeros_like(value)
    return _assemble(value, z, z, z, z, z, z, z, z, z, z, z, z, z, z, z)


def absorber(value: torch.Tensor) -> torch.Tensor:
    """Neutral absorber: value x identity.  (..., C) -> (..., 4, 4, C)."""
    return (identity(value.shape[:-1], 1, value.dtype, value.device)
            * value[..., None, None, :])


def linear_polarizer(value: torch.Tensor) -> torch.Tensor:
    """Ideal linear polarizer, transmission axis the reference x axis,
    peak transmittance ``value`` (mueller.h linear_polarizer)."""
    a = value * 0.5
    z = torch.zeros_like(a)
    return _assemble(a, a, z, z, a, a, z, z, z, z, z, z, z, z, z, z)


def linear_retarder(phase: torch.Tensor) -> torch.Tensor:
    """Linear retarder, fast axis the reference x axis, retardance
    ``phase`` in radians (mueller.h linear_retarder; pi is a half-wave
    plate)."""
    s, c = torch.sin(phase), torch.cos(phase)
    one, z = torch.ones_like(phase), torch.zeros_like(phase)
    return _assemble(one, z, z, z, z, one, z, z, z, z, c, -s, z, z, s, c)


def circular_polarizer(value: torch.Tensor) -> torch.Tensor:
    """Ideal right-circular polarizer (mueller.h
    right_circular_polarizer)."""
    a = value * 0.5
    z = torch.zeros_like(a)
    return _assemble(a, z, z, a, z, z, z, z, z, z, z, z, a, z, z, a)


def rotator(theta) -> torch.Tensor:
    """Stokes frame rotator by ``theta`` radians (mueller.h rotator):
    (...,) -> (..., 4, 4, 1)."""
    theta = _t(theta)
    c = torch.cos(2.0 * theta)[..., None]
    s = torch.sin(2.0 * theta)[..., None]
    one, z = torch.ones_like(c), torch.zeros_like(c)
    return _assemble(one, z, z, z, z, c, s, z, z, -s, c, z, z, z, z, one)


def rotated_element(theta, mm: torch.Tensor) -> torch.Tensor:
    """An optical element rotated by ``theta``: R(theta) M R(-theta)
    (mueller.h rotated_element)."""
    theta = _t(theta, mm)
    return matmul(rotator(theta), matmul(mm, rotator(-theta)))


# ---------------------------------------------------------------------------
# Fresnel amplitudes and their Mueller matrices (fresnel.h
# fresnel_polarized, mueller.h specular_reflection / transmission)
# ---------------------------------------------------------------------------

def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv(ar, ai, br, bi):
    den = torch.clamp(br * br + bi * bi, min=1e-30)
    return (ar * br + ai * bi) / den, (ai * br - ar * bi) / den


def _csqrt(xr, xi):
    """The principal complex square root (branch cut on the negative real
    axis; xi = 0, xr < 0 gives +i sqrt(-xr))."""
    r = torch.sqrt(xr * xr + xi * xi)
    sr = torch.sqrt(torch.clamp(0.5 * (r + xr), min=0.0))
    si_mag = torch.sqrt(torch.clamp(0.5 * (r - xr), min=0.0))
    return sr, torch.where(xi >= 0.0, si_mag, -si_mag)


def fresnel_amplitudes(cos_theta_i, eta_re: torch.Tensor,
                       eta_im: torch.Tensor):
    """Complex s and p reflection amplitudes for the relative IOR
    eta_re + i eta_im: conductors (eta_im > 0), dielectrics (eta_im = 0)
    and total internal reflection (a complex cos_theta_t) alike.  Shapes
    broadcast; cos_theta_i >= 0.  Returns ((a_s_re, a_s_im), (a_p_re,
    a_p_im))."""
    ci = _t(cos_theta_i, eta_re)
    zi = torch.zeros_like(eta_im)
    sin_i2 = torch.clamp(1.0 - ci * ci, min=0.0)
    e2r, e2i = _cmul(eta_re, eta_im, eta_re, eta_im)
    qr, qi = _cdiv(sin_i2, zi, e2r, e2i)
    ctr, cti = _csqrt(1.0 - qr, -qi)
    ectr, ecti = _cmul(eta_re, eta_im, ctr, cti)
    a_s = _cdiv(ci - ectr, -ecti, ci + ectr, ecti)
    ecir, ecii = eta_re * ci, eta_im * ci
    a_p = _cdiv(ecir - ctr, ecii - cti, ecir + ctr, ecii + cti)
    return a_s, a_p


def _amplitudes_to_mueller(a_s, a_p) -> torch.Tensor:
    """The Mueller matrix of complex s / p amplitudes, reference axis s
    (mueller.h specular_reflection's body)."""
    asr, asi = a_s
    apr, api = a_p
    s2 = asr * asr + asi * asi
    p2 = apr * apr + api * api
    c, s = _cmul(asr, asi, apr, -api)          # a_s conj(a_p)
    A = 0.5 * (s2 + p2)
    B = 0.5 * (s2 - p2)
    z = torch.zeros_like(A)
    return _assemble(A, B, z, z, B, A, z, z, z, z, c, s, z, z, -s, c)


def specular_reflection(cos_theta_i, eta_re: torch.Tensor,
                        eta_im: torch.Tensor = None) -> torch.Tensor:
    """Mueller matrix of specular reflection at a (conducting) interface,
    s/p basis.  cos_theta_i: (...,), eta: (..., C)."""
    if eta_im is None:
        eta_im = torch.zeros_like(eta_re)
    ci = _t(cos_theta_i, eta_re)
    if ci.dim() < eta_re.dim():
        ci = ci[..., None]
    return _amplitudes_to_mueller(*fresnel_amplitudes(ci, eta_re, eta_im))


def specular_transmission(cos_theta_i, eta: torch.Tensor) -> torch.Tensor:
    """Mueller matrix of specular transmission through a dielectric, s/p
    basis (mueller.h specular_transmission), with the radiance transport's
    energy factor; total internal reflection transmits nothing."""
    ci = torch.clamp(_t(cos_theta_i, eta), 0.0, 1.0)
    if ci.dim() < eta.dim():
        ci = ci[..., None]
    sin_t2 = (1.0 - ci * ci) / (eta * eta)
    valid = sin_t2 < 1.0
    ct = torch.sqrt(torch.clamp(1.0 - sin_t2, min=0.0))
    t_s = 2.0 * ci / torch.clamp(ci + eta * ct, min=1e-8)
    t_p = 2.0 * ci / torch.clamp(eta * ci + ct, min=1e-8)
    factor = torch.where(valid, (eta * ct) / torch.clamp(ci, min=1e-8), 0.0)
    rt = torch.sqrt(factor)
    z = torch.zeros_like(t_s)
    mm = _amplitudes_to_mueller((t_s * rt, z), (t_p * rt, z))
    return mm * valid[..., None, None, :].to(mm.dtype)


# ---------------------------------------------------------------------------
# Stokes reference bases (mueller.h stokes_basis, rotate_stokes_basis,
# rotate_mueller_basis)
# ---------------------------------------------------------------------------

def stokes_basis(w: torch.Tensor) -> torch.Tensor:
    """The implicit Stokes basis vector of the propagation direction w."""
    return m.coordinate_system(w)[0]


def unit_angle(a: torch.Tensor, b: torch.Tensor,
               forward: torch.Tensor) -> torch.Tensor:
    """The signed angle that turns unit vector a onto b about
    ``forward``."""
    return torch.atan2(m.dot(m.cross(a, b), forward), m.dot(a, b))


def rotate_stokes_basis(forward, basis_cur, basis_tgt) -> torch.Tensor:
    """The rotator taking Stokes vectors from basis_cur to basis_tgt, both
    perpendicular to ``forward``."""
    return rotator(unit_angle(basis_cur, basis_tgt, forward))


def rotate_mueller_basis(mm: torch.Tensor, in_forward, in_basis_cur,
                         in_basis_tgt, out_forward, out_basis_cur,
                         out_basis_tgt) -> torch.Tensor:
    """A Mueller matrix re-expressed in new input and output Stokes bases:
    R_out M R_in^-1 (mueller.h rotate_mueller_basis)."""
    r_in = rotate_stokes_basis(in_forward, in_basis_cur, in_basis_tgt)
    r_out = rotate_stokes_basis(out_forward, out_basis_cur, out_basis_tgt)
    return matmul(r_out, matmul(mm, r_in.transpose(-3, -2)))


def rotate_mueller_basis_collinear(mm: torch.Tensor, forward, basis_cur,
                                   basis_tgt) -> torch.Tensor:
    """``rotate_mueller_basis`` where the input and output directions are
    one."""
    r = rotate_stokes_basis(forward, basis_cur, basis_tgt)
    return matmul(r, matmul(mm, r.transpose(-3, -2)))
