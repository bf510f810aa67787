"""1-D discrete distributions (counterpart of ``core/distr.py``, the
reference's include/mitsuba/core/distr_1d.h): a pmf table's CDF, and an
index drawn from it by binary search.  A CDF is shared (K,) or batched
(..., K) against the samples; values may carry a gradient (triangle areas
of moving vertices), the search itself is detached."""
from __future__ import annotations

import torch


def build_cdf(pmf: torch.Tensor):
    """(normalized cdf, total): cdf[i] = sum(pmf[:i+1]) / total."""
    cdf = torch.cumsum(pmf, dim=-1)
    total = cdf[..., -1:]
    safe_total = torch.where(total > 0.0, total, 1.0)
    return cdf / safe_total, total[..., 0]


def _below(cdf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """cdf[idx - 1], 0 where idx is 0, for a shared or a batched cdf."""
    prev = torch.clamp(idx - 1, min=0)
    if cdf.dim() == 1:
        lo = cdf[prev]
    else:
        lo = torch.gather(cdf, -1, prev[..., None])[..., 0]
    return torch.where(idx > 0, lo, 0.0)


def sample_discrete(cdf: torch.Tensor, u: torch.Tensor):
    """(index, its pmf) of #{i : cdf[i] <= u}, clipped to K - 1."""
    k = cdf.shape[-1]
    if cdf.dim() == 1:
        idx = torch.searchsorted(cdf.detach(), u.contiguous(), right=True)
        idx = torch.clamp(idx, 0, k - 1)
        pmf = cdf[idx] - _below(cdf, idx)
    else:
        idx = torch.searchsorted(cdf.detach().contiguous(),
                                 u[..., None].contiguous(), right=True)[..., 0]
        idx = torch.clamp(idx, 0, k - 1)
        pmf = torch.gather(cdf, -1, idx[..., None])[..., 0] - _below(cdf, idx)
    return idx.to(torch.int32), pmf


def sample_reuse(cdf: torch.Tensor, u: torch.Tensor):
    """(index, pmf, u rescaled to [0, 1) within the chosen bin), so that
    the sample can be reused downstream (distr_1d.h ``sample_reuse``)."""
    idx, pmf = sample_discrete(cdf, u)
    lo = _below(cdf, idx.long())
    u_rescaled = torch.clamp((u - lo) / torch.where(pmf > 0, pmf, 1.0),
                             0.0, 1.0 - 1e-7)
    return idx, pmf, u_rescaled
