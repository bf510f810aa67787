"""Pearson's chi-square test of a sampling routine against its density
(counterpart of ``utils/chi2.py``, the reference's
src/python/python/chi2.py): the samples are histogrammed on a grid of
the domain, the density integrated numerically over each cell, and the
cells whose expectation is below 5 pooled into one, as the reference
does.

``sample_func(n)`` and ``pdf_func(points)`` are torch functions, which
may run on the GPU: the pdf is handed a float32 tensor of points on
``device`` (``None``: the GPU).  The histogram and the test run on the
host in numpy and scipy."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.device import resolve_device


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class SphericalDomain:
    """S^2 parameterised by (cos theta, phi): the area element is
    uniform."""

    def bounds(self):
        return np.array([[-1.0, 1.0], [-np.pi, np.pi]])

    def map_forward(self, d):
        return np.stack([d[..., 2], np.arctan2(d[..., 1], d[..., 0])], -1)

    def map_backward(self, p):
        ct = p[..., 0]
        st = np.sqrt(np.maximum(1 - ct * ct, 0))
        return np.stack([st * np.cos(p[..., 1]), st * np.sin(p[..., 1]), ct],
                        -1)


class PlanarDomain:
    """A rectangle of the plane, [0, 1]^2 unless ``bounds`` says."""

    def __init__(self, bounds=None):
        self._b = np.array([[0.0, 1.0], [0.0, 1.0]]) if bounds is None \
            else np.asarray(bounds)

    def bounds(self):
        return self._b

    def map_forward(self, p):
        return np.asarray(p)[..., :2]

    def map_backward(self, p):
        return np.asarray(p)


class ChiSquareTest:
    """The histogram of ``sample_count`` samples against the integrated
    density (chi2.py ``ChiSquareTest``) on res x 2 res cells, each
    integrated on ires x ires points.

    ``sample_func(n)``: (n, 3) or (n, 2) samples (a tensor or an array);
    ``pdf_func(points)``: the density at a float32 tensor of domain
    points, w.r.t. the domain's measure (solid angle on the sphere)."""

    def __init__(self, domain, sample_func: Callable, pdf_func: Callable,
                 sample_count: int = 1_000_000, res: int = 31,
                 ires: int = 8, significance_level: float = 0.01,
                 device=None):
        self.domain = domain
        self.sample_func = sample_func
        self.pdf_func = pdf_func
        self.sample_count = sample_count
        self.res_theta = res
        self.res_phi = 2 * res
        self.ires = ires
        self.significance_level = significance_level
        self.device = resolve_device(device)
        self.messages = ""

    def tabulate_histogram(self):
        p = self.domain.map_forward(_np(self.sample_func(self.sample_count)))
        b = self.domain.bounds()
        x = (p[..., 0] - b[0, 0]) / (b[0, 1] - b[0, 0])
        y = (p[..., 1] - b[1, 0]) / (b[1, 1] - b[1, 0])
        xi = np.clip((x * self.res_theta).astype(np.int64), 0,
                     self.res_theta - 1)
        yi = np.clip((y * self.res_phi).astype(np.int64), 0, self.res_phi - 1)
        hist = np.bincount(xi * self.res_phi + yi,
                           minlength=self.res_theta * self.res_phi)
        self.histogram = hist.reshape(self.res_theta, self.res_phi)

    def tabulate_pdf(self):
        b = self.domain.bounds()
        k = self.ires
        e0 = np.linspace(b[0, 0], b[0, 1], self.res_theta * k + 1)
        e1 = np.linspace(b[1, 0], b[1, 1], self.res_phi * k + 1)
        g0, g1 = np.meshgrid(0.5 * (e0[:-1] + e0[1:]),
                             0.5 * (e1[:-1] + e1[1:]), indexing="ij")
        pts = self.domain.map_backward(np.stack([g0, g1], -1))
        pdf = _np(self.pdf_func(torch.as_tensor(
            pts, dtype=torch.float32, device=self.device)))
        cell = (e0[1] - e0[0]) * (e1[1] - e1[0])
        pdf = pdf.reshape(self.res_theta, k, self.res_phi, k)
        self.pdf_table = pdf.sum((1, 3)) * cell * self.sample_count

    def run(self) -> bool:
        """True where the test passes at ``significance_level``; the
        statistic, the degrees of freedom and the p-value in
        ``messages``."""
        from scipy.stats import chi2 as chi2_dist
        self.tabulate_histogram()
        self.tabulate_pdf()
        obs = self.histogram.ravel().astype(np.float64)
        exp = self.pdf_table.ravel().astype(np.float64)
        small = exp < 5.0
        obs_m = np.concatenate([obs[~small], [obs[small].sum()]])
        exp_m = np.concatenate([exp[~small], [exp[small].sum()]])
        keep = exp_m > 0
        obs_m, exp_m = obs_m[keep], exp_m[keep]
        dof = len(obs_m) - 1
        chi2 = float(((obs_m - exp_m) ** 2 / exp_m).sum())
        self.p_value = float(chi2_dist.sf(chi2, dof))
        self.messages = f"chi2={chi2:.2f} dof={dof} p={self.p_value:.4f}"
        return self.p_value > self.significance_level
