"""Colour utilities (counterpart of ``core/spectrum.py``).

The port renders in RGB.  ``luminance``, ``srgb_to_linear``,
``linear_to_srgb`` and ``to_bitmap_u8`` (the logger's encoder) take a
tensor or a numpy array and return the same kind, computed in its dtype;
``blackbody_rgb`` is numpy, as the scene loader calls it before any
tensor exists.
"""
from __future__ import annotations

import numpy as np
import torch


def _elementwise(fn):
    """Run ``fn`` on a tensor; a numpy argument goes through a tensor
    view and comes back as a numpy array."""
    def call(c):
        if isinstance(c, torch.Tensor):
            return fn(c)
        return fn(torch.from_numpy(np.asarray(c))).numpy()
    call.__name__, call.__doc__ = fn.__name__, fn.__doc__
    return call


@_elementwise
def luminance(rgb):
    """ITU-R BT.709 luminance (include/mitsuba/core/spectrum.h:471)."""
    return rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160 \
        + rgb[..., 2] * 0.072169


@_elementwise
def srgb_to_linear(c):
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


@_elementwise
def linear_to_srgb(c):
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * c ** (1.0 / 2.4) - 0.055)


@_elementwise
def to_bitmap_u8(img):
    """HDR linear -> clipped sRGB uint8 (mi.util.convert_to_bitmap)."""
    return (linear_to_srgb(torch.clamp(img, 0.0, 1.0)) * 255.0
            + 0.5).to(torch.uint8)


# ---------------------------------------------------------------------------
# CIE 1931 colour matching (multi-lobe Gaussian fits of Wyman et al. 2013)
# and blackbody emission (spectra/blackbody.cpp for the RGB pipeline)
# ---------------------------------------------------------------------------

def _g(x, mu, s1, s2):
    t = (x - mu) * np.where(x < mu, 1.0 / s1, 1.0 / s2)
    return np.exp(-0.5 * t * t)


def cie1931_xyz(wavelength_nm):
    """Approximate CIE 1931 colour-matching functions (Wyman et al.)."""
    w = np.asarray(wavelength_nm, np.float64)
    x = (1.056 * _g(w, 599.8, 37.9, 31.0) + 0.362 * _g(w, 442.0, 16.0, 26.7)
         - 0.065 * _g(w, 501.1, 20.4, 26.2))
    y = 0.821 * _g(w, 568.8, 46.9, 40.5) + 0.286 * _g(w, 530.9, 16.3, 31.1)
    z = 1.217 * _g(w, 437.0, 11.8, 36.0) + 0.681 * _g(w, 459.0, 26.0, 13.8)
    return np.stack([x, y, z], -1)


def xyz_to_srgb_linear(xyz):
    M = np.array([[3.240479, -1.537150, -0.498535],
                  [-0.969256, 1.875991, 0.041556],
                  [0.055648, -0.204043, 1.057311]])
    return xyz @ M.T


def blackbody_rgb(temperature_k: float, normalize: bool = False):
    """Planck blackbody emission integrated against CIE -> linear sRGB,
    float32.  Radiance in W/(m^2 sr nm) integrated over 360-830 nm
    unless ``normalize``."""
    lam_nm = np.linspace(360.0, 830.0, 128)
    lam = lam_nm * 1e-9
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    # spectral radiance per nm
    L = (2 * h * c * c / lam ** 5 /
         np.expm1(h * c / (lam * kb * max(temperature_k, 1.0)))) * 1e-9
    xyz = (cie1931_xyz(lam_nm) * L[:, None]).sum(0) * (lam_nm[1] - lam_nm[0])
    rgb = np.maximum(xyz_to_srgb_linear(xyz), 0.0)
    if normalize and rgb.max() > 0:
        rgb = rgb / rgb.max()
    return rgb.astype(np.float32)
