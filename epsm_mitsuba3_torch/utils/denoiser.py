"""Image denoiser (counterpart of ``utils/denoiser.py``; the reference
wraps the OptiX denoiser, src/render/optixdenoiser.cpp): an
edge-avoiding à-trous wavelet filter (Dammertz et al. 2010), guided by
the ``aov`` integrator's normals and albedo, and with a per-pixel
variance (from ``moment``) the SVGF weighting (Schied et al. 2017).

Plain tensor code on the device of its input: shifts are
``torch.roll`` (the image wraps at its borders, as the reference's
``jnp.roll`` does).
"""
from __future__ import annotations

import torch

_KERNEL = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
_GAUSS3 = (0.25, 0.5, 0.25)


def _shift2(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    return torch.roll(img, (dy, dx), dims=(0, 1))


def _gauss3(x: torch.Tensor) -> torch.Tensor:
    """The 3 x 3 binomial blur (SVGF's variance prefilter)."""
    out = torch.zeros_like(x)
    for dy in range(-1, 2):
        for dx in range(-1, 2):
            out = out + _GAUSS3[dy + 1] * _GAUSS3[dx + 1] * _shift2(x, dy, dx)
    return out


def _as_tensor(x, like=None):
    if x is None:
        return None
    dev = None if like is None else like.device
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def denoise(color, normals=None, albedo=None, variance=None,
            iterations: int = 4, sigma_color: float = 0.45,
            sigma_normal: float = 0.35, sigma_albedo: float = 0.3,
            sigma_lum: float = 4.0) -> torch.Tensor:
    """``iterations`` à-trous passes (step 2^it) of a 5 x 5 B3-spline
    kernel over the (H, W, 3) ``color``, on ``color``'s device.

    ``normals`` / ``albedo``: optional (H, W, 3) guides.  ``variance``:
    optional per-pixel variance of the mean, (H, W, 3) or (H, W, 1); with
    it the colour weight is the luminance distance over the local noise
    level, and the variance is filtered alongside with squared weights."""
    out = _as_tensor(color)
    normals = _as_tensor(normals, out)
    albedo = _as_tensor(albedo, out)
    var = None
    if variance is not None:
        var = torch.mean(_as_tensor(variance, out), -1, keepdim=True)
    for it in range(iterations):
        step = 1 << it
        acc = torch.zeros_like(out)
        vacc = torch.zeros(out.shape[:2] + (1,), dtype=out.dtype,
                           device=out.device)
        wsum = torch.zeros_like(vacc)
        if var is not None:
            lum = torch.mean(out, -1, keepdim=True)
            noise = torch.sqrt(torch.clamp(_gauss3(var), min=0.0))
        for ky in range(5):
            for kx in range(5):
                dy, dx = (ky - 2) * step, (kx - 2) * step
                w = _KERNEL[ky] * _KERNEL[kx]
                q = _shift2(out, dy, dx)
                if var is None:
                    d2 = torch.sum((out - q) ** 2, -1, keepdim=True)
                    wgt = w * torch.exp(-d2 / (sigma_color ** 2 * (2.0 ** it)))
                else:
                    dl = torch.abs(lum - _shift2(lum, dy, dx))
                    wgt = w * torch.exp(-dl / (sigma_lum * noise + 1e-4))
                if normals is not None:
                    dn = torch.sum((normals - _shift2(normals, dy, dx)) ** 2,
                                   -1, keepdim=True)
                    wgt = wgt * torch.exp(-dn / (sigma_normal ** 2))
                if albedo is not None:
                    da = torch.sum((albedo - _shift2(albedo, dy, dx)) ** 2,
                                   -1, keepdim=True)
                    wgt = wgt * torch.exp(-da / (sigma_albedo ** 2))
                acc = acc + q * wgt
                wsum = wsum + wgt
                if var is not None:
                    vacc = vacc + _shift2(var, dy, dx) * wgt ** 2
        out = acc / torch.clamp(wsum, min=1e-8)
        if var is not None:
            var = vacc / torch.clamp(wsum ** 2, min=1e-12)
    return out


class Denoiser:
    """mi.OptixDenoiser-style callable around ``denoise``."""

    def __init__(self, iterations: int = 4):
        self.iterations = iterations

    def __call__(self, color, normals=None, albedo=None, variance=None):
        return denoise(color, normals, albedo, variance,
                       iterations=self.iterations)
