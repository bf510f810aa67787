"""Row gathers (counterpart of ``ops/gather.py``).

``take_rows(table, idx)`` is ``table[idx]`` through ``index_select``,
whose gradient accumulates with ``index_add_`` (atomic adds on the GPU).
The gradient of advanced indexing sorts the indices and sums each run of
equal indices in one thread: a million lanes gathering from a table of a
few dozen rows (the vertices of a Cornell box, the BSDF and emitter
tables) gives runs of tens of thousands, and that backward took 5.9 s of
a 6.1 s fwd+bwd pass on the H100 (``PERF.md`` §6).
"""
from __future__ import annotations

import torch


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an integer ``idx`` of any shape: rows of
    ``table`` (R, ...) -> (*idx.shape, ...)."""
    flat = torch.index_select(table, 0, idx.reshape(-1).long())
    return flat.reshape(*idx.shape, *table.shape[1:])
