"""Cubic splines (counterpart of ``core/spline.py``, the reference's
include/mitsuba/core/spline.h): the cubic Hermite on [0, 1], the
Catmull-Rom interpolant through (nodes, values) and its integral.  Every
function takes tensors and answers on their device."""
from __future__ import annotations

import torch


def eval_spline(f0, f1, d0, d1, t):
    """Cubic Hermite on [0, 1] (spline.h ``eval_spline``)."""
    t2 = t * t
    t3 = t2 * t
    return ((2.0 * t3 - 3.0 * t2 + 1.0) * f0 + (-2.0 * t3 + 3.0 * t2) * f1
            + (t3 - 2.0 * t2 + t) * d0 + (t3 - t2) * d1)


def _segments(nodes, values, idx):
    """(x0, x1, f0, f1, d0, d1) of the intervals ``idx``: the Catmull-Rom
    derivatives, one-sided at the ends."""
    n = nodes.shape[0]
    x0, x1 = nodes[idx], nodes[idx + 1]
    f0, f1 = values[idx], values[idx + 1]
    w = x1 - x0
    lo = torch.clamp(idx - 1, min=0)
    hi = torch.clamp(idx + 2, max=n - 1)
    fm, fp, xm, xp = values[lo], values[hi], nodes[lo], nodes[hi]
    d0 = torch.where(idx > 0, w * (f1 - fm) / torch.clamp(x1 - xm, min=1e-12),
                     f1 - f0)
    d1 = torch.where(idx + 2 < n,
                     w * (fp - f0) / torch.clamp(xp - x0, min=1e-12), f1 - f0)
    return x0, x1, f0, f1, d0, d1


def eval_1d(nodes, values, x):
    """The Catmull-Rom spline through (nodes, values) at ``x`` (spline.h
    ``eval_1d``), on uniform or non-uniform nodes."""
    n = nodes.shape[0]
    idx = torch.clamp(torch.searchsorted(nodes, x, right=True) - 1, 0, n - 2)
    x0, x1, f0, f1, d0, d1 = _segments(nodes, values, idx)
    t = (x - x0) / torch.clamp(x1 - x0, min=1e-12)
    return eval_spline(f0, f1, d0, d1, torch.clamp(t, 0.0, 1.0))


def integrate_1d(nodes, values):
    """The integral of the Catmull-Rom interpolant from the first node to
    each node (spline.h ``integrate_1d``): (n,), 0 first."""
    idx = torch.arange(nodes.shape[0] - 1, device=nodes.device)
    x0, x1, f0, f1, d0, d1 = _segments(nodes, values, idx)
    seg = (x1 - x0) * (0.5 * (f0 + f1) + (1.0 / 12.0) * (d0 - d1))
    return torch.cat([torch.zeros(1, dtype=seg.dtype, device=seg.device),
                      torch.cumsum(seg, 0)])
