"""Shared integrator machinery (counterpart of ``integrators/common.py``):
camera rays in the pixel-major lane order (lane = pixel * spp + s) and
the MIS power heuristic."""
from __future__ import annotations

import torch

from ..models import samplers as smp
from ..models import sensors as sns


def mis_weight(pdf_a: torch.Tensor, pdf_b: torch.Tensor) -> torch.Tensor:
    """Power heuristic (beta = 2) as 1 / (1 + (b/a)^2): squaring pdfs near
    the 1e20 emitter-sample floor would overflow float32."""
    r = pdf_b / torch.where(pdf_a > 0.0, pdf_a, 1.0)
    w = 1.0 / (1.0 + r * r)
    return torch.where(pdf_a > 0.0, w, 0.0)


def sample_rays(sensor: sns.Sensor, sampler: smp.Sampler, spp: int):
    """Wavefront of primary rays (common.py:291-422).

    Returns (sampler, ray, weight, pos (N, 2) film position in pixels)."""
    if sensor.rfilter != "box":
        raise NotImplementedError(
            f"rfilter '{sensor.rfilter}': the port has the box filter only")
    w, h = sensor.width, sensor.height
    device = sensor.to_world.device
    idx = torch.arange(w * h * spp, device=device) // spp
    pos_y = (idx // w).to(torch.float32)
    pos_x = (idx % w).to(torch.float32)

    sampler, jitter = smp.next_2d(sampler)
    pos_f = torch.stack([pos_x, pos_y], dim=-1) + jitter
    pos01 = torch.stack([pos_f[:, 0] * (1.0 / w), pos_f[:, 1] * (1.0 / h)],
                        dim=-1)

    ray, weight = sns.sample_ray_differential(sensor, pos01)
    # the box filter splats at the integer pixel position (common.py:418)
    return sampler, ray, weight, torch.stack([pos_x, pos_y], dim=-1)
