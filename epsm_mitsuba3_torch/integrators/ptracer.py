"""Particle tracer (counterpart of ``integrators/ptracer.py``;
src/integrators/ptracer.cpp): light paths traced from the area emitters,
every vertex connected to the camera and added into the pixel it
projects to.

The reference's choices are kept as they are (:53-137):

- ``sensor_connect`` projects through a pinhole whatever the sensor's
  kind (:25-50);
- one uniform pair ``s_pick`` picks the emitter row and also drives the
  area sample (:62-71);
- the emission direction is cosine-distributed about the light's normal,
  and the particle's weight ``beta = radiance / pdf_pos * pi`` (:73-80);
- the emitter vertex is added where it faces the camera (:95-103);
- ``max_depth - 1`` particle bounces (:110);
- each camera connection casts its own shadow ray from ``p + 1e-4 d`` to
  ``dist * (1 - 1e-3)`` and adds into the pixel ``floor(uv * size)`` with
  no filter (:84-93);
- the image is divided by spp (:136).

The film is one scatter-add (``index_add_``) a connection: on the GPU its
float atomics vary in the last bits from run to run, as ``films.splat``'s
do.  Ray queries: one any hit for the emitter vertices' connections, then
a closest hit and an any hit a bounce; lanes with no work carry
zero-extent rays.  The reference stops the gradient of the whole scene
(:55): every leaf's gradient is zero (``common.detached``).

A light that is not an area light has no triangle to emit from: a lane
that picks its row starts on face 0 with ``pdf_pos`` clamped to 1e-12,
so its particle weighs ~1e-12 of the row's radiance column.  The
reference does the same; its image is finite (such a light adds no
light of its own), so the port copies it (``ROADMAP.md`` queue 3).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import math as m
from ..core import warp
from ..models import bsdf as B
from ..models import emitters as E
from ..models import samplers as smp
from ..models.records import Ray
from ..models.sensors import Sensor, _tan_half
from . import common


def sensor_connect(sensor: Sensor, p: torch.Tensor):
    """Project world points ``p`` (N, 3) onto the film of a pinhole at
    ``sensor``'s pose (the inverse of perspective.cpp's
    ``sample_direction``).  Returns (uv01 (N, 2), the direction to the
    camera (N, 3), the distance (N,), the importance
    ``1 / (A_plane cos^3)`` (N,), valid (N,))."""
    R = sensor.to_world[:3, :3]
    o = sensor.to_world[:3, 3]
    rel = p - o
    p_cam = rel @ R                                   # R^T (p - o)
    z = p_cam[..., 2]
    valid = z > sensor.near
    tan_half = np.float32(_tan_half(sensor.fov_x))
    aspect = sensor.width / sensor.height
    u = 0.5 * (1.0 - p_cam[..., 0] / (z * float(tan_half)))
    v = 0.5 * (1.0 - p_cam[..., 1] * aspect / (z * float(tan_half)))
    valid = valid & (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
    dist = torch.sqrt(m.squared_norm(rel))
    d = -rel / torch.clamp(dist, min=1e-12)[..., None]
    cos_t = torch.clamp(m.dot(-d, R[:, 2]), min=1e-6)
    a_plane = float(np.float32(4.0) * tan_half * tan_half
                    / np.float32(aspect))
    we = 1.0 / (a_plane * cos_t ** 3)
    return torch.stack([u, v], -1), d, dist, we, valid


def _splat(scene, sensor, img_flat, contrib, p_src, active):
    """Add ``contrib`` (N, 3) of the lanes that see the camera from
    ``p_src`` unoccluded into their pixels (:84-93)."""
    w_, h_ = sensor.width, sensor.height
    uv, d, dist, _, ok = sensor_connect(sensor, p_src)
    ok = ok & active
    # lanes with no connection carry zero-extent shadow rays
    occ = scene.ray_test(Ray.make(p_src + d * 1e-4, d,
                                  maxt=torch.where(ok, dist * (1 - 1e-3),
                                                   0.0)))
    ok = ok & ~occ
    px = torch.clamp((uv[:, 0] * w_).to(torch.int32), 0, w_ - 1)
    py = torch.clamp((uv[:, 1] * h_).to(torch.int32), 0, h_ - 1)
    idx = (py * w_ + px).long()
    return img_flat.index_add_(0, idx, torch.where(ok[:, None], contrib,
                                                   0.0))


def _trace(scene, seed, sensor_idx, spp, max_depth):
    sensor = scene.sensors[sensor_idx]
    w_, h_ = sensor.width, sensor.height
    n = w_ * h_ * spp
    dev = scene.device
    sampler = smp.seed(seed, n, device=dev)

    # emitter rays: a row by s_pick, a point on its triangles by s_pick too
    sampler, s_pick = smp.next_2d(sampler)
    sampler, s_dir = smp.next_2d(sampler)
    n_em = scene.emitters["kind"].shape[0]
    em_idx = torch.clamp((s_pick[:, 0] * n_em).to(torch.int32), 0, n_em - 1)
    cdf, total_area = E.area_emitter_data(scene.vertices, scene.faces,
                                          scene.em_faces)
    ds, _ = E._area_sample(
        E._Rows(scene.emitters, em_idx), torch.zeros((n, 3), device=dev),
        s_pick, em_idx, scene.vertices, scene.faces, scene.em_faces, cdf,
        total_area)
    local = warp.square_to_cosine_hemisphere(s_dir)
    s_f, t_f = m.coordinate_system(ds.n)
    d0 = m.to_world(ds.n, s_f, t_f, local)
    pdf_pos = 1.0 / torch.clamp(total_area[em_idx.long()] * n_em, min=1e-12)
    radiance = scene.emitters["radiance"][em_idx.long()]
    beta = radiance / torch.clamp(pdf_pos, min=1e-12)[..., None] * math.pi

    img_flat = torch.zeros((h_ * w_, 3), dtype=beta.dtype, device=dev)

    # the emitter vertices the camera sees (:95-103)
    _, d_cam, dist_cam, we, ok0 = sensor_connect(sensor, ds.p)
    facing = m.dot(-d_cam * -1.0, ds.n) > 0
    img_flat = _splat(
        scene, sensor, img_flat,
        radiance * we[..., None] / torch.clamp(dist_cam, min=1e-6)[..., None]
        ** 2 * torch.clamp(m.dot(d_cam, ds.n), min=0.0)[..., None]
        / torch.clamp(pdf_pos, min=1e-12)[..., None],
        ds.p, ok0 & facing)

    # the particle's bounces (:105-134)
    ray_o, ray_d = ds.p + d0 * 1e-4, d0
    active = torch.ones(n, dtype=torch.bool, device=dev)
    kinds, textures = scene.static.bsdf_kinds, scene.bsdf_textures()
    for _ in range(max_depth - 1):
        ray = Ray.make(ray_o, ray_d,
                       maxt=torch.where(active, float("inf"), 0.0))
        si = scene.ray_intersect(ray)
        active = active & si.valid
        _, d_c, dist_c, we_c, okc = sensor_connect(sensor, si.p)
        f_val, _ = B.eval_pdf(scene.bsdfs, kinds, si.bsdf_index, si.wi,
                              si.to_local(d_c), active, uv=si.uv,
                              textures=textures, vcolor=si.vcolor)
        contrib = beta * f_val * (
            we_c / torch.clamp(dist_c, min=1e-6) ** 2)[..., None]
        img_flat = _splat(scene, sensor, img_flat, contrib, si.p,
                          active & okc)

        sampler, s1 = smp.next_1d(sampler)
        sampler, s2 = smp.next_2d(sampler)
        bs, bsdf_w, ok = B.sample(scene.bsdfs, kinds, si.bsdf_index, si.wi,
                                  s1, s2, active, uv=si.uv,
                                  textures=textures, vcolor=si.vcolor)
        beta = beta * torch.where(ok[..., None], bsdf_w, 0.0)
        nray = si.spawn_ray(si.to_world(bs.wo))
        ray_o, ray_d = nray.o, nray.d
        active = active & ok & (torch.amax(beta, -1) > 0)

    return img_flat.reshape(h_, w_, 3) / spp


def render_ptracer(scene, seed: int = 0, sensor_idx: int = 0, spp: int = 16,
                   max_depth: int = 6) -> torch.Tensor:
    """One pass of the particle tracer: the (H, W, 3) image of ``spp``
    light paths a pixel, each of ``max_depth - 1`` bounces (:53-137)."""
    return common.detached(scene, lambda: _trace(scene, seed, sensor_idx,
                                                 spp, max_depth))
