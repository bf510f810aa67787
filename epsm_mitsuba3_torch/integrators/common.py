"""Shared integrator machinery (counterpart of ``integrators/common.py``):
camera rays in the pixel-major lane order (lane = pixel * spp + s), the
film of a pass's lanes, the MIS power heuristic, which is detached as in
the reference, and ``detached``, the image of an integrator whose
reference stops the gradient of the whole scene."""
from __future__ import annotations

from typing import Optional

import torch

from ..models import films
from ..models import samplers as smp
from ..models import sensors as sns


def mis_weight(pdf_a: torch.Tensor, pdf_b: torch.Tensor) -> torch.Tensor:
    """Power heuristic (beta = 2) as 1 / (1 + (b/a)^2), detached: squaring
    pdfs near the 1e20 emitter-sample floor would overflow float32."""
    pdf_a, pdf_b = pdf_a.detach(), pdf_b.detach()
    r = pdf_b / torch.where(pdf_a > 0.0, pdf_a, 1.0)
    w = 1.0 / (1.0 + r * r)
    return torch.where(pdf_a > 0.0, w, 0.0)


def sample_rays(sensor: sns.Sensor, sampler: smp.Sampler, spp: int,
                lane_offset: Optional[int] = None):
    """Wavefront of primary rays (common.py:291-422).

    Returns (sampler, ray, weight, pos (N, 2) splat position in pixels):
    the pixel's corner for the box filter (common.py:418-420), the
    jittered position for every other filter.  A ``thinlens`` sensor
    draws a second 2-D sample for its aperture, whatever its radius.
    ``lane_offset``: the rays of the global lanes [off, off + n) for a
    sampler of n lanes (a shard of the wavefront); None: all
    ``W * H * spp`` lanes."""
    w, h = sensor.width, sensor.height
    device = sensor.to_world.device
    if lane_offset is None:
        gidx = torch.arange(w * h * spp, device=device)
    else:
        n = sampler.rng.state.shape[0]
        gidx = (torch.arange(n, device=device) + lane_offset) & smp.M32
    idx = gidx // spp
    pos_y = (idx // w).to(torch.float32)
    pos_x = (idx % w).to(torch.float32)

    sampler, jitter = smp.next_2d(sampler)
    pos_f = torch.stack([pos_x, pos_y], dim=-1) + jitter
    pos01 = torch.stack([pos_f[:, 0] * (1.0 / w), pos_f[:, 1] * (1.0 / h)],
                        dim=-1)
    aperture = None
    if sensor.kind == "thinlens":
        sampler, aperture = smp.next_2d(sampler)

    ray, weight = sns.sample_ray_differential(sensor, pos01, aperture)
    if sensor.rfilter == "box":
        return sampler, ray, weight, torch.stack([pos_x, pos_y], dim=-1)
    return sampler, ray, weight, pos_f


def camera(scene, seed: int, sensor_idx: int, spp: int):
    """The pass's sampler (the scene's kind, advanced past the camera
    draws), camera rays, film weights and splat positions: (sensor, the
    lane count n, sampler, ray, weight, pos), the same for a render's
    forward and its replay (JAX ad/prb.py:744-746)."""
    sensor = scene.sensors[sensor_idx]
    n = sensor.width * sensor.height * spp
    sampler = smp.seed(seed, n, kind=scene.static.sampler_kind, spp=spp,
                       device=scene.device)
    sampler, ray, weight, pos = sample_rays(sensor, sampler, spp)
    return sensor, n, sampler, ray, weight, pos


def film(sensor: sns.Sensor, value: torch.Tensor, pos: torch.Tensor,
         spp: int) -> torch.Tensor:
    """The developed image of the pixel-major lanes' ``value``: the box
    filter's per-pixel mean, any other filter's general scatter
    (``films.splat``) at ``pos``, as the reference's ``direct`` and EPSM
    primals develop theirs."""
    if sensor.rfilter == "box":
        return films.accumulate_coalesced(value, sensor.width,
                                          sensor.height, spp)
    data, w = films.splat(pos, value, sensor.width, sensor.height,
                          sensor.rfilter)
    return films.develop(data, w)


class _Detached(torch.autograd.Function):
    """The image ``fn()`` of a scene whose leaves require grad, computed
    without a graph, and a zero gradient for each leaf."""

    @staticmethod
    def forward(ctx, fn, *leaves):
        ctx.leaves = [(v.shape, v.dtype, v.device) for v in leaves]
        return fn()

    @staticmethod
    def backward(ctx, g_img):
        return (None, *(torch.zeros(s, dtype=d, device=v)
                        for s, d, v in ctx.leaves))


def detached(scene, fn):
    """``fn()``, the image of an integrator whose reference stops the
    gradient of the whole scene (``direct``, ``moment``, ``ptracer``, the
    spectral family): where grad mode is on and a leaf of ``scene``
    requires grad, the image is attached to those leaves with a zero
    gradient each, so that ``torch.autograd.grad`` returns zeros rather
    than raising; it is computed without a graph either way."""
    leaves = [v for v in scene.leaves().values() if v.requires_grad]
    if torch.is_grad_enabled() and leaves:
        return _Detached.apply(fn, *leaves)
    with torch.no_grad():
        return fn()
