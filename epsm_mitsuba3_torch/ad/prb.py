"""Path replay renders (counterpart of ``ad/prb.py``), primal only: one
pass of the path tracer over a wavefront of ``W * H * spp`` lanes,
developed on the film.  The backward replay comes with the PRB slice."""
from __future__ import annotations

import torch

from ..integrators import common, path as P
from ..models import films, samplers as smp


def _film_fn(values, weight, sensor, spp):
    """Box-filter film of the pixel-major lanes (``_film_fn``)."""
    return films.accumulate_coalesced(values * weight, sensor.width,
                                      sensor.height, spp)


def render_prb(scene, seed: int = 0, sensor_idx: int = 0, spp: int = 16,
               max_depth: int = 6, rr_depth: int = 5) -> torch.Tensor:
    """One primal pass (``_make_render._primal``): (H, W, 3) image."""
    sensor = scene.sensors[sensor_idx]
    n = sensor.width * sensor.height * spp
    sampler = smp.seed(seed, n, kind=scene.static.sampler_kind,
                       device=scene.device)
    sampler, ray, weight, _ = common.sample_rays(sensor, sampler, spp)
    L, _ = P.sample_primal(scene, sampler, ray, max_depth, rr_depth)
    return _film_fn(L, weight, sensor, spp)
