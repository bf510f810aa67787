"""Samplers (counterpart of ``models/samplers.py``): the ``independent``
sampler, per-lane PCG32 streams seeded with TEA, bit-exact with the
reference.  Other sampler kinds raise."""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..core import rng as _rng


@dataclass(frozen=True)
class Sampler:
    rng: _rng.PCG32


def seed(seed_value, wavefront_size: int, kind: str = "independent",
         device=None) -> Sampler:
    """One PCG32 stream per lane of the wavefront (sampler.cpp:115-135)."""
    if kind != "independent":
        raise NotImplementedError(
            f"sampler '{kind}': the port has the independent sampler only")
    return Sampler(rng=_rng.seed_wavefront(0, seed_value, wavefront_size,
                                           device=device))


def next_1d(sampler: Sampler):
    """(sampler', x (N,)) uniform in [0, 1)."""
    r, x = _rng.pcg32_next_float32(sampler.rng)
    return replace(sampler, rng=r), x


def next_2d(sampler: Sampler):
    """(sampler', xy (N, 2)): two consecutive draws of the lane's stream."""
    r, x = _rng.pcg32_next_float32(sampler.rng)
    r, y = _rng.pcg32_next_float32(r)
    return replace(sampler, rng=r), torch.stack([x, y], dim=-1)
