"""The variant policy (counterpart of ``config.py``, the reference's
``mi.set_variant``, src/python/__init__.py:73-150).

A variant name is accepted for familiarity; what it selects is the
dtype policy.  A name ending in ``double`` (``cuda_ad_rgb_double``,
``llvm_ad_rgb_double``) makes ``load_dict`` (and every loader that goes
through ``scene_from_arrays``) cast each float leaf of the scene to
float64, and makes the samplers cast their draws to float64; the rest
follows by type promotion, so shading, films and gradients run in
float64.  The draws themselves are made in float32, bit for bit the
float32 variant's, and cast exactly.

Kernels K1-K3 keep float32: the BVH, its packed records and the rays
handed to the kernels are float32 (``ops/accel.py``), and the kernels
answer detached decisions (the hit primitive and a seed t, u, v).
``compute_surface_interaction`` re-derives t, u and v from the float64
vertices where a derivative can reach them.  Scene descriptions are
parsed in float32 before the cast, as in the reference, so a scene's
own numbers carry float32 precision.

Set the variant before building scenes; a scene keeps the dtype it was
built with.  ``config`` holds the current policy."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class _Config:
    dtype: torch.dtype = torch.float32
    variant: str = "cuda_ad_rgb"


config = _Config()


def set_variant(name: str = "cuda_ad_rgb") -> None:
    """Select the variant ``name``: float64 for a ``*_double`` name,
    float32 otherwise."""
    config.variant = name
    config.dtype = torch.float64 if name.endswith("double") \
        else torch.float32


def variant() -> str:
    return config.variant
