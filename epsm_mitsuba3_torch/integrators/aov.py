"""Utility integrators (counterpart of ``integrators/aov.py``;
src/integrators/{depth,aov,moment,stokes}.cpp): the depth, the shading
normals, the multi-channel AOV image, the first and second moments, and
the RGB stand-in of the Stokes integrator.

Each films through ``accumulate_coalesced`` (the per-pixel mean)
whatever the sensor's filter, as the reference does (:23, :76, :96).
``render_depth`` and ``render_normals`` seed the independent sampler
(:18, :31); ``render_aov``, ``render_moment`` and ``render_stokes`` the
scene's kind (:50, :90, :113).  The radiance of ``render_aov``,
``render_moment`` and ``render_stokes`` is ``path.sample_primal``'s at
rr_depth 5, detached as the reference's (JAX ``integrators/path.py:245``
stops the scene and the rays).

Gradients are the reference's autodiff: the depth, normal, position, uv
and albedo channels carry theirs through the surface interaction (the
vertices, the sensor pose, the reflectances); the radiance channel
carries none, and ``render_moment`` gives every scene leaf a zero
gradient.  Ray queries: one closest hit for the camera rays of
``render_depth``, ``render_normals`` and ``render_aov``, and
``sample_primal``'s closest and any hit a bounce.
"""
from __future__ import annotations

import torch

from ..models import bsdf as B
from ..models import films
from ..models import samplers as smp
from . import common
from . import path as P

#: the channels ``render_aov`` knows
AOV_CHANNELS = ("depth", "sh_normal", "ng_normal", "position", "uv",
                "albedo", "alpha")
#: ``render_aov``'s channels where the integrator names none
DEFAULT_AOVS = ("depth", "sh_normal", "position", "albedo")


def _camera(scene, seed, sensor_idx, spp, scene_kind):
    """(sensor, sampler, ray, weight): the independent sampler, or the
    scene's kind with ``scene_kind``, advanced past the camera draws."""
    sensor = scene.sensors[sensor_idx]
    n = sensor.width * sensor.height * spp
    if scene_kind:
        sampler = smp.seed(seed, n, kind=scene.static.sampler_kind, spp=spp,
                           device=scene.device)
    else:
        sampler = smp.seed(seed, n, device=scene.device)
    sampler, ray, weight, _ = common.sample_rays(sensor, sampler, spp)
    return sensor, sampler, ray, weight


def _film(sensor, vals, spp):
    return films.accumulate_coalesced(vals, sensor.width, sensor.height, spp)


def _radiance(scene, sampler, ray, max_depth):
    """``sample_primal``'s radiance at rr_depth 5, detached."""
    with torch.no_grad():
        L, _ = P.sample_primal(scene, sampler, ray, max_depth, 5)
    return L


def render_depth(scene, seed: int = 0, sensor_idx: int = 0, spp: int = 4):
    """The distance to the first hit, 0 on a miss, in three equal
    channels: (H, W, 3) (:13-24)."""
    sensor, _, ray, _ = _camera(scene, seed, sensor_idx, spp, False)
    si = scene.ray_intersect(ray)
    depth = torch.where(si.valid, si.t, 0.0)
    return _film(sensor, torch.stack([depth, depth, depth], -1), spp)


def render_normals(scene, seed: int = 0, sensor_idx: int = 0, spp: int = 4):
    """The shading normal at the first hit, 0 on a miss: (H, W, 3)
    (:27-36)."""
    sensor, _, ray, _ = _camera(scene, seed, sensor_idx, spp, False)
    si = scene.ray_intersect(ray)
    return _film(sensor, torch.where(si.valid[..., None], si.sh_n, 0.0), spp)


def _channel(scene, si, name):
    """AOV ``name`` of the first hit ``si``, 0 on a miss."""
    valid = si.valid[..., None]
    if name == "depth":
        return torch.where(si.valid, si.t, 0.0)[..., None]
    if name == "sh_normal":
        return torch.where(valid, si.sh_n, 0.0)
    if name == "ng_normal":
        return torch.where(valid, si.n, 0.0)
    if name == "position":
        return torch.where(valid, si.p, 0.0)
    if name == "uv":
        return torch.where(valid, si.uv, 0.0)
    if name == "albedo":
        # the gathered reflectance after the texture lookup (:68-70); the
        # reference passes no vertex colour there, so a mesh_attribute
        # slot reads its placeholder texel, 0
        p = B.gather_params(scene.bsdfs, si.bsdf_index, ("reflectance",))
        p = B._apply_textures(p, scene.bsdfs, si.bsdf_index, si.uv,
                              scene.bsdf_textures(),
                              torch.zeros_like(si.p))
        return torch.where(valid, p["reflectance"], 0.0)
    if name == "alpha":
        return si.valid.to(si.p.dtype)[..., None]
    raise ValueError(f"unknown AOV '{name}'")


def render_aov(scene, seed: int = 0, sensor_idx: int = 0, spp: int = 4,
               aovs=DEFAULT_AOVS, max_depth: int = 2):
    """The radiance (3 channels), then each channel of ``aovs`` (names of
    ``AOV_CHANNELS``, of 1 to 3 channels each; any other raises),
    concatenated (:39-77)."""
    sensor, sampler, ray, weight = _camera(scene, seed, sensor_idx, spp,
                                           True)
    si = scene.ray_intersect(ray)
    L = _radiance(scene, sampler, ray, max_depth)
    chans = [L * weight.detach()] + [_channel(scene, si, a) for a in aovs]
    return _film(sensor, torch.cat(chans, -1), spp)


def _moments(scene, seed, sensor_idx, spp, max_depth, stokes):
    sensor, sampler, ray, weight = _camera(scene, seed, sensor_idx, spp,
                                           True)
    v = _radiance(scene, sampler, ray, max_depth) * weight
    if stokes:
        zeros = torch.zeros_like(v)
        vals = torch.cat([v, v, zeros, zeros, zeros], -1)
    else:
        vals = torch.cat([v, v * v], -1)
    return _film(sensor, vals, spp)


def render_moment(scene, seed: int = 0, sensor_idx: int = 0, spp: int = 4,
                  max_depth: int = 4):
    """The per-pixel mean radiance and its per-channel second moment
    (the basis of the Z-test, ``utils/image.py``): (H, W, 6) (:80-98).
    Every scene leaf that requires grad gets a zero gradient."""
    return common.detached(scene, lambda: _moments(
        scene, seed, sensor_idx, spp, max_depth, False))


def render_stokes(scene, seed: int = 0, sensor_idx: int = 0, spp: int = 4,
                  max_depth: int = 4):
    """The RGB pipeline's Stokes stand-in (:101-120): the radiance, then
    S0 = the radiance again and S1..S3 = 0 in RGB: (H, W, 15).  As in the
    reference it is not on ``render``'s dispatch: the ``stokes``
    integrator type goes to the polarized renderer
    (``integrators/polarized.py``)."""
    return common.detached(scene, lambda: _moments(
        scene, seed, sensor_idx, spp, max_depth, True))
