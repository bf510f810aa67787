"""Small batched linear algebra (counterpart of ``ops/linalg.py``).

``inv_small`` inverts (N, n, n) systems for a small static n by an
unrolled Gauss-Jordan elimination with partial pivoting done by selects,
so every lane takes the same instructions: no per-lane control flow, and
no wait for the device.  A singular system gives a finite result (a
pivot with |p| <= 1e-20 is inverted to 0) where ``torch.linalg.inv``
raises on the whole batch, and checking a batch for that waits for the
device.
"""
from __future__ import annotations

import torch


def inv_small(M: torch.Tensor) -> torch.Tensor:
    """Invert (N, n, n) with a static n (<= ~12) by unrolled Gauss-Jordan
    with partial pivoting (``inv_small``, :14-54)."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device).expand(M.shape)
    aug = torch.cat([M, eye], dim=-1)
    rows = [aug[:, i, :] for i in range(n)]

    for col in range(n):
        # partial pivot: the row (>= col) of the largest |pivot| per lane
        piv_val = torch.abs(rows[col][:, col])
        piv_idx = torch.full_like(piv_val, col, dtype=torch.int32)
        for r in range(col + 1, n):
            cand = torch.abs(rows[r][:, col])
            better = cand > piv_val
            piv_val = torch.where(better, cand, piv_val)
            piv_idx = torch.where(better, r, piv_idx)
        # swap rows[col] <-> rows[piv_idx] by selects
        pivot_row = rows[col]
        for r in range(col + 1, n):
            sel = (piv_idx == r)[:, None]
            pivot_row = torch.where(sel, rows[r], pivot_row)
        for r in range(col + 1, n):
            sel = (piv_idx == r)[:, None]
            rows[r] = torch.where(sel, rows[col], rows[r])
        # normalise the pivot row
        p = pivot_row[:, col]
        ok = torch.abs(p) > 1e-20
        inv_p = torch.where(ok, 1.0 / torch.where(ok, p, 1.0), 0.0)
        pivot_row = pivot_row * inv_p[:, None]
        rows[col] = pivot_row
        # eliminate the column from every other row
        for r in range(n):
            if r != col:
                rows[r] = rows[r] - rows[r][:, col:col + 1] * pivot_row

    return torch.stack([rows[i][:, n:] for i in range(n)], dim=1)
