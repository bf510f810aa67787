"""2-D distributions (counterpart of ``core/distr2d.py``, the reference's
include/mitsuba/core/distr_2d.h): a row marginal and per-row conditional
inverse CDFs of a (H, W) weight table.  The column of a lane is found by
bisecting its row's CDF (``bisect_rows``), which needs no (N, W) gather;
``models/emitters.py`` samples the envmap the same way."""
from __future__ import annotations

import math

import torch


def bisect_rows(table: torch.Tensor, row: torch.Tensor,
                u: torch.Tensor) -> torch.Tensor:
    """#{x : table[row, x] <= u} lane by lane, for a (H, W) table whose
    rows do not decrease: ceil(log2 W) + 1 gather steps into the flat
    table, the same count as a compare-sum over each lane's whole row."""
    w = table.shape[1]
    flat = table.detach().reshape(-1)
    base = row.long() * w
    lo = torch.zeros_like(base)
    hi = torch.full_like(base, w)
    for _ in range(math.ceil(math.log2(w)) + 1):
        live = lo < hi
        mid = (lo + hi) >> 1
        go_right = live & (flat[base + torch.clamp(mid, max=w - 1)] <= u)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(live & ~go_right, mid, hi)
    return lo


class Marginal2D:
    """Sample proportionally to a (H, W) weight table."""

    def __init__(self, weights: torch.Tensor):
        self.weights = torch.clamp(weights, min=0.0) + 1e-12
        row_cdf = torch.cumsum(torch.sum(self.weights, dim=1), dim=0)
        self.total = row_cdf[-1]
        self.row_cdf = row_cdf / self.total
        col = torch.cumsum(self.weights, dim=1)
        self.col_cdf = col / col[:, -1:]

    def sample(self, sample2: torch.Tensor):
        """(N, 2) uniforms -> ((N, 2) uv in [0, 1]^2, density wrt uv)."""
        h, w = self.weights.shape
        y = torch.clamp(torch.searchsorted(
            self.row_cdf.detach(), sample2[..., 1].contiguous(), right=True),
            0, h - 1)
        x = torch.clamp(bisect_rows(self.col_cdf, y, sample2[..., 0]),
                        0, w - 1)
        u = (x.to(sample2.dtype) + 0.5) / w
        v = (y.to(sample2.dtype) + 0.5) / h
        pdf = self.weights[y, x] / self.total * (h * w)
        return torch.stack([u, v], -1), pdf

    def pdf(self, uv: torch.Tensor) -> torch.Tensor:
        h, w = self.weights.shape
        x = torch.clamp((uv[..., 0] * w).to(torch.int32), 0, w - 1).long()
        y = torch.clamp((uv[..., 1] * h).to(torch.int32), 0, h - 1).long()
        return self.weights[y, x] / self.total * (h * w)


class Hierarchical2D(Marginal2D):
    """The reference's Hierarchical2D (a mip-chain warp) samples the same
    density as Marginal2D; here it is the same flat inverse CDF."""
