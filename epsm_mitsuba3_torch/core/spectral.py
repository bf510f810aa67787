"""The CIE half of the spectral substrate (counterpart of
``core/spectral.py`` :39-107): the CIE 1931 colour-matching functions as
multi-lobe Gaussian fits (Wyman et al. 2013), the 6504 K Planckian
illuminant that stands in for D65, and the white-balanced projection of
a spectrum onto linear sRGB that the scene loader uses for tabulated
``regular`` and ``irregular`` spectra.

All of it is numpy float64 on the host, as in the reference: the loader
calls it before any tensor exists.  Wavelength sampling and the
sigmoid-polynomial fit belong to the ``spectral`` integrator and are not
ported.
"""
from __future__ import annotations

import functools
import math

import numpy as np

LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0
N_QUAD = 32          # quadrature nodes of the projection

#: XYZ -> linear sRGB, rounded to float32 as the reference keeps it
XYZ_TO_SRGB = np.array([[3.240479, -1.537150, -0.498535],
                        [-0.969256, 1.875991, 0.041556],
                        [0.055648, -0.204043, 1.057311]], np.float32)


def _g(x, mu, s1, s2):
    t = (x - mu) * np.where(x < mu, 1.0 / s1, 1.0 / s2)
    return np.exp(-0.5 * t * t)


def cie1931_xyz(w):
    """CIE 1931 colour matching at wavelength(s) ``w`` [nm] -> (..., 3)."""
    x = (1.056 * _g(w, 599.8, 37.9, 31.0)
         + 0.362 * _g(w, 442.0, 16.0, 26.7)
         - 0.065 * _g(w, 501.1, 20.4, 26.2))
    y = (0.821 * _g(w, 568.8, 46.9, 40.5)
         + 0.286 * _g(w, 530.9, 16.3, 31.1))
    z = (1.217 * _g(w, 437.0, 11.8, 36.0)
         + 0.681 * _g(w, 459.0, 26.0, 13.8))
    return np.stack([x, y, z], -1)


def illuminant_spd(w):
    """The 6504 K Planckian radiance at ``w`` [nm], 1 at 560 nm."""
    lam = w * 1e-9
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    L = 1.0 / (lam ** 5 * np.expm1(h * c / (lam * kb * 6504.0)))
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
