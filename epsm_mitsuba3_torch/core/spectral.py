"""The spectral substrate (counterpart of ``core/spectral.py``).

- The CIE 1931 colour-matching functions as multi-lobe Gaussian fits
  (Wyman et al. 2013) and the 6504 K Planckian illuminant that stands in
  for D65: numpy float64 on the host for the loader and the projection's
  constants, float32 tensors in the renderer (the array's kind picks).
- The white-balanced projection of a spectrum onto linear sRGB
  (``_projection``), which the loader uses for tabulated ``regular`` and
  ``irregular`` spectra.
- What the ``spectral`` integrator draws and lifts (:110-233): K
  stratified-shifted wavelengths a lane from the visible-range warp
  (``sample_wavelengths``), the Jakob–Hanika sigmoid-polynomial
  reflectance model fitted on the fly by 20 damped Gauss–Newton steps
  (``fit_reflectance``), the lifts of an RGB reflectance and emission to
  spectra, and the developments back to RGB and to luminance.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0
N_QUAD = 32          # quadrature nodes of the projection

#: XYZ -> linear sRGB, rounded to float32 as the reference keeps it
XYZ_TO_SRGB = np.array([[3.240479, -1.537150, -0.498535],
                        [-0.969256, 1.875991, 0.041556],
                        [0.055648, -0.204043, 1.057311]], np.float32)


def _xp(w):
    """The array namespace of ``w``: torch for a tensor, else numpy."""
    return torch if isinstance(w, torch.Tensor) else np


def _g(x, mu, s1, s2):
    xp = _xp(x)
    t = (x - mu) * xp.where(x < mu, 1.0 / s1, 1.0 / s2)
    return xp.exp(-0.5 * t * t)


def cie1931_xyz(w):
    """CIE 1931 colour matching at wavelength(s) ``w`` [nm] -> (..., 3),
    in the dtype of ``w`` (a tensor's float32, numpy's float64)."""
    x = (1.056 * _g(w, 599.8, 37.9, 31.0)
         + 0.362 * _g(w, 442.0, 16.0, 26.7)
         - 0.065 * _g(w, 501.1, 20.4, 26.2))
    y = (0.821 * _g(w, 568.8, 46.9, 40.5)
         + 0.286 * _g(w, 530.9, 16.3, 31.1))
    z = (1.217 * _g(w, 437.0, 11.8, 36.0)
         + 0.681 * _g(w, 459.0, 26.0, 13.8))
    return _xp(w).stack([x, y, z], -1)


def illuminant_spd(w):
    """The 6504 K Planckian radiance at ``w`` [nm], 1 at 560 nm."""
    lam = w * 1e-9
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    L = 1.0 / (lam ** 5 * _xp(w).expm1(h * c / (lam * kb * 6504.0)))
    lam0 = 560e-9
    L0 = 1.0 / (lam0 ** 5 * math.expm1(h * c / (lam0 * kb * 6504.0)))
    return L / L0


@functools.lru_cache(maxsize=None)
def _projection():
    """(W (M, 3), lam (M,), wb (3,)), float32: the quadrature weights that
    map a spectrum sampled at ``lam`` to white-balanced linear sRGB, and
    ``wb``, the illuminant's unbalanced projection (the von Kries
    divisor)."""
    lam = np.linspace(LAMBDA_MIN + 2.0, LAMBDA_MAX - 2.0, N_QUAD,
                      dtype=np.float64)
    dlam = lam[1] - lam[0]
    ill = illuminant_spd(lam)
    xyz = cie1931_xyz(lam)                          # (M, 3)
    norm_y = np.sum(xyz[:, 1] * ill) * dlam
    W = xyz * ill[:, None] * dlam / norm_y          # reflectance -> XYZ
    rgbW = W @ XYZ_TO_SRGB.astype(np.float64).T     # reflectance -> sRGB
    wb = np.sum(rgbW, axis=0)                       # projection of S = 1
    return (np.asarray(rgbW / wb[None, :], np.float32),
            np.asarray(lam, np.float32), np.asarray(wb, np.float32))


def project_to_rgb(S_fn):
    """The white-balanced linear sRGB of the spectrum ``S_fn`` (a
    callable of the wavelengths [nm])."""
    rgbW, lam, _ = _projection()
    return S_fn(lam) @ rgbW


# ---------------------------------------------------------------------------
# wavelength sampling (spectrum.cpp sample_rgb_spectrum), float32 tensors
# ---------------------------------------------------------------------------

def sample_visible(u: torch.Tensor) -> torch.Tensor:
    """The visible-range warp: pdf proportional to sech^2(0.0072 (lam -
    538)), clipped to [LAMBDA_MIN, LAMBDA_MAX]."""
    lam = 538.0 - 138.888889 * torch.atanh(0.85691062 - 1.82750197 * u)
    return torch.clamp(lam, LAMBDA_MIN, LAMBDA_MAX)


def pdf_visible(lam: torch.Tensor) -> torch.Tensor:
    x = torch.cosh(0.0072 * (lam - 538.0))
    pdf = 0.0039398042 / (x * x)
    return torch.where((lam >= LAMBDA_MIN) & (lam <= LAMBDA_MAX), pdf, 0.0)


def sample_wavelengths(u: torch.Tensor, k: int = 4):
    """K stratified-shifted wavelengths a lane from one uniform (the hero
    wavelength and its rotations): u (N,) -> (lam (N, K), pdf (N, K))."""
    shifts = (torch.arange(k, dtype=u.dtype, device=u.device) / k)[None, :]
    uk = torch.remainder(u[:, None] + shifts, 1.0)
    lam = sample_visible(uk)
    return lam, pdf_visible(lam)


# ---------------------------------------------------------------------------
# the sigmoid-polynomial reflectance model (Jakob & Hanika 2019)
# ---------------------------------------------------------------------------

def _sigmoid(t: torch.Tensor) -> torch.Tensor:
    return 0.5 + 0.5 * t * torch.rsqrt(1.0 + t * t)


def _xnorm(lam):
    return (lam - LAMBDA_MIN) / (LAMBDA_MAX - LAMBDA_MIN)


def eval_sigmoid(coeff: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """coeff (..., 3) = (c0, c1, c2); lam (..., K) [nm] -> S (..., K)."""
    x = _xnorm(lam)
    t = coeff[..., 0:1] + coeff[..., 1:2] * x + coeff[..., 2:3] * x * x
    return _sigmoid(t)


def _gauss_newton_step(J: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(J^T J + 1e-4 I)^-1 J^T r for (..., 3, 3) ``J`` and (..., 3) ``r``
    in closed form: the normal equations' six distinct entries, then their
    Cholesky factor (the matrix is symmetric positive definite); some
    forty elementwise operations on every lane, no batched LAPACK call."""
    col = [J[..., :, k] for k in range(3)]

    def dot(a, b):
        return torch.sum(a * b, -1)

    l00 = torch.sqrt(dot(col[0], col[0]) + 1e-4)
    l10 = dot(col[1], col[0]) / l00
    l20 = dot(col[2], col[0]) / l00
    l11 = torch.sqrt(dot(col[1], col[1]) + 1e-4 - l10 * l10)
    l21 = (dot(col[2], col[1]) - l20 * l10) / l11
    l22 = torch.sqrt(dot(col[2], col[2]) + 1e-4 - l20 * l20 - l21 * l21)
    y0 = dot(col[0], r) / l00
    y1 = (dot(col[1], r) - l10 * y0) / l11
    y2 = (dot(col[2], r) - l20 * y0 - l21 * y1) / l22
    x2 = y2 / l22
    x1 = (y1 - l21 * x2) / l11
    x0 = (y0 - l10 * x1 - l20 * x2) / l00
    return torch.stack([x0, x1, x2], -1)


#: the Gauss-Newton steps of ``fit_reflectance`` (the reference's 20)
FIT_STEPS = 20


def fit_reflectance(rgb: torch.Tensor) -> torch.Tensor:
    """Sigmoid-polynomial coefficients (..., 3) whose white-balanced
    projection reproduces ``rgb`` in [0, 1]^3 (:151-183): the target
    clipped to [1e-4, 1 - 1e-4], a flat start at its luminance, then
    FIT_STEPS damped (1e-4) Gauss-Newton steps.  It stands in for the
    reference's precomputed rgb2spec table.

    A step's Jacobian ``J[..., i, j] = sum_m rgbW[m, i] s'(t_m) x_m^j`` is
    one matrix product of s'(t) with the (M, 9) table ``rgbW[m, i]
    x_m^j``; its normal equations are solved lane by lane
    (``_gauss_newton_step``)."""
    rgbW_np, lam_np, _ = _projection()
    rgbW = torch.as_tensor(rgbW_np, device=rgb.device)       # (M, 3)
    x = _xnorm(torch.as_tensor(lam_np, device=rgb.device))   # (M,)
    basis = torch.stack([torch.ones_like(x), x, x * x], -1)  # (M, 3)
    table = (rgbW[:, :, None] * basis[:, None, :]).reshape(-1, 9)
    tgt = torch.clamp(rgb, 1e-4, 1.0 - 1e-4)

    lum_w = torch.tensor([0.2126, 0.7152, 0.0722], dtype=rgb.dtype,
                         device=rgb.device)
    lum = torch.clamp(torch.sum(tgt * lum_w, -1, keepdim=True), 1e-3,
                      1.0 - 1e-3)
    t0 = (lum - 0.5) / torch.sqrt(torch.clamp(lum * (1.0 - lum), min=1e-6))
    c = torch.cat([t0, torch.zeros(tgt.shape[:-1] + (2,), dtype=tgt.dtype,
                                   device=tgt.device)], -1)
    for _ in range(FIT_STEPS):
        t = c @ basis.T                                   # (..., M)
        u = 1.0 + t * t
        r = (0.5 + 0.5 * t * torch.rsqrt(u)) @ rgbW - tgt  # (..., 3)
        J = ((0.5 * u ** -1.5) @ table).unflatten(-1, (3, 3))
        c = c - _gauss_newton_step(J, r)
    return c


def reflectance_to_spectrum(rgb: torch.Tensor, lam: torch.Tensor):
    """rgb (..., 3) in [0, inf) at lam (..., K) -> S (..., K); values
    above 1 fit rgb / max and scale back (rgb2spec's scale trick)."""
    s = torch.clamp(torch.amax(rgb, -1, keepdim=True), min=1.0)
    return eval_sigmoid(fit_reflectance(rgb / s), lam) * s


def emission_to_spectrum(rgb: torch.Tensor, lam: torch.Tensor):
    """RGB emission -> spectrum: the upsampled chromaticity times the
    illuminant (srgb.cpp), so that ``spectrum_to_rgb`` inverts it."""
    return reflectance_to_spectrum(rgb, lam) * illuminant_spd(lam)


# ---------------------------------------------------------------------------
# film development
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _radiance_norm() -> float:
    """1 / the illuminant's Y integral on the projection's nodes
    (float64 on the host, :219-227)."""
    _, lam, _ = _projection()
    lam = np.asarray(lam, np.float64)
    dlam = lam[1] - lam[0]
    norm_y = np.sum(cie1931_xyz(lam)[:, 1] * illuminant_spd(lam)) * dlam
    return float(1.0 / norm_y)


def _inv_pdf(pdf: torch.Tensor) -> torch.Tensor:
    return torch.where(pdf > 0, 1.0 / torch.clamp(pdf, min=1e-12), 0.0)


def spectrum_to_rgb(S, lam, pdf):
    """The Monte Carlo white-balanced linear sRGB of radiance samples S
    (..., K) at lam (..., K) drawn with ``pdf`` (..., K) -> (..., 3)."""
    wb = torch.as_tensor(_projection()[2], device=S.device)
    m = torch.as_tensor(XYZ_TO_SRGB, device=S.device)
    rgbW_lam = (cie1931_xyz(lam) @ m.T) * _radiance_norm() / wb[None, :]
    return torch.mean(S[..., None] * rgbW_lam * _inv_pdf(pdf)[..., None],
                      dim=-2)


def spectrum_to_mono(S, lam, pdf):
    """The luminance development (the ``mono`` colour mode): (..., 1)."""
    y = cie1931_xyz(lam)[..., 1]
    return torch.mean(S * y * _inv_pdf(pdf), dim=-1,
                      keepdim=True) * _radiance_norm()
