"""Spectral path tracing (counterpart of ``integrators/spectral.py``): the
``spectral``, ``spectral_mono`` and ``spectral_spec`` integrators, the
spectral and mono halves of the reference's variant axis.

Each lane draws one uniform after its camera draws and expands it into K
stratified-shifted wavelengths (``core/spectral.py``
``sample_wavelengths``); throughput and radiance are (N, K).  The scene
stays RGB: at every bounce the RGB emission reaching the vertex (the
emitter hit and the NEE term, summed) and the BSDF weight are lifted to
spectra by the sigmoid-polynomial fit (``fit_reflectance``, twice a
bounce on every lane), the emission times the illuminant.  The bounce
reuses the path tracer's own ``_emitter_hit_le`` and ``_nee``
(``integrators/path.py``), so NEE, MIS and Russian roulette are the RGB
path's.  Ray queries: one closest hit and one any hit a bounce, lanes
with no work on zero-extent rays.

Development (:193-212): 'rgb' the CIE 1931 white-balanced linear sRGB,
'mono' the luminance (H, W, 1), 'spec' the specfilm's ``n_bins``
wavelength bins (H, W, n_bins); 'mono' and 'spec' weight by the ray
weight's first channel.  The box filter films by the per-pixel mean,
every other filter through ``splat_coalesced`` and ``develop``.  The
sampler is the scene's kind seeded with the plain ``seed``.  The
reference stops the gradient of the scene (:153): every leaf's gradient
is zero (``common.detached``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import spectral as sp
from ..models import bsdf as B
from ..models import films
from ..models import samplers as smp
from ..models.records import Ray, RayFlags
from ..ops import intersect as I
from . import common
from . import path as P

#: the integrator types and their development modes
MODES = {"spectral": "rgb", "spectral_mono": "mono", "spectral_spec": "spec"}


@dataclass(frozen=True)
class SpecState:
    sampler: smp.Sampler
    ray_o: torch.Tensor            # (N, 3)
    ray_d: torch.Tensor            # (N, 3)
    depth: torch.Tensor            # (N,) int32
    L: torch.Tensor                # (N, K) spectral radiance samples
    beta: torch.Tensor             # (N, K) spectral throughput
    eta: torch.Tensor              # (N,)
    active: torch.Tensor           # (N,) bool
    prev_p: torch.Tensor           # (N, 3)
    prev_bsdf_pdf: torch.Tensor    # (N,)
    prev_bsdf_delta: torch.Tensor  # (N,) bool


def _lift_emission(rgb, lam):
    """RGB radiance -> spectral samples, 0 where the RGB is 0 (the fit of
    black is clipped to 1e-4, which must not emit)."""
    nonzero = torch.amax(rgb, -1, keepdim=True) > 1e-7
    return torch.where(nonzero, sp.emission_to_spectrum(rgb, lam), 0.0)


def _lift_reflectance(rgb, lam):
    nonzero = torch.amax(rgb, -1, keepdim=True) > 1e-7
    return torch.where(nonzero, sp.reflectance_to_spectrum(rgb, lam), 0.0)


def _bounce_spectral(scene, st: SpecState, lam, max_depth: int,
                     rr_depth: int) -> SpecState:
    """One spectral bounce of the whole wavefront (:70-133)."""
    ray = Ray.make(st.ray_o, st.ray_d,
                   maxt=torch.where(st.active, float("inf"), 0.0))
    pi = scene.ray_intersect_preliminary(ray)
    pi = pi.replace(valid=pi.valid & st.active)
    si = I.compute_surface_interaction(scene, ray, pi, RayFlags.All)

    le_rgb = P._emitter_hit_le(scene, si, st.ray_d, st.prev_p,
                               st.prev_bsdf_pdf, st.prev_bsdf_delta,
                               st.active)
    bsdf_flags = B.flags_of(scene.bsdfs, si.bsdf_index)
    active_next = (st.depth + 1 < max_depth) & si.valid & st.active
    active_em = active_next & B.has_flag(bsdf_flags, B.BSDFFlags.Smooth)
    sampler, _, lr_dir_rgb, _, _ = P._nee(scene, si, st.sampler, active_em)

    # one lift covers the emitter hit and the NEE term: both are radiance
    contrib = _lift_emission(le_rgb + lr_dir_rgb, lam)
    L = st.L + torch.where(st.active[..., None], st.beta * contrib, 0.0)

    sampler, s1 = smp.next_1d(sampler)
    sampler, s2 = smp.next_2d(sampler)
    bs, bsdf_weight, ok = B.sample(
        scene.bsdfs, scene.static.bsdf_kinds, si.bsdf_index, si.wi, s1, s2,
        active_next, uv=si.uv, textures=scene.bsdf_textures(),
        vcolor=si.vcolor)
    new_ray = si.spawn_ray(si.to_world(bs.wo))
    eta = st.eta * torch.where(ok, bs.eta, 1.0)
    beta = st.beta * _lift_reflectance(
        torch.where(ok[..., None], bsdf_weight, 0.0), lam)

    beta_max = torch.amax(beta, dim=-1)
    active_next = active_next & (beta_max != 0.0)
    rr_prob = torch.clamp(beta_max * eta * eta, max=0.95)
    rr_active = st.depth >= rr_depth
    beta = torch.where(rr_active[..., None],
                       beta / torch.clamp(rr_prob, min=1e-8)[..., None], beta)
    sampler, rr_u = smp.next_1d(sampler)
    active_next = active_next & (~rr_active | (rr_u < rr_prob))
    return SpecState(
        sampler=sampler, ray_o=new_ray.o, ray_d=new_ray.d,
        depth=st.depth + si.valid.to(st.depth.dtype), L=L, beta=beta,
        eta=eta, active=active_next, prev_p=si.p, prev_bsdf_pdf=bs.pdf,
        prev_bsdf_delta=B.has_flag(bs.sampled_type, B.BSDFFlags.Delta))


@torch.no_grad()
def sample_spectral(scene, sampler, ray: Ray, lam: torch.Tensor,
                    max_depth: int, rr_depth: int = 5):
    """Spectral radiance samples of the camera rays at the wavelengths
    ``lam`` (N, K): (S (N, K), depth > 0 (N,)) (:136-159), detached."""
    n, k = lam.shape
    dtype, dev = ray.o.dtype, ray.o.device
    st = SpecState(
        sampler=sampler, ray_o=ray.o, ray_d=ray.d,
        depth=torch.zeros(n, dtype=torch.int32, device=dev),
        L=torch.zeros((n, k), dtype=dtype, device=dev),
        beta=torch.ones((n, k), dtype=dtype, device=dev),
        eta=torch.ones(n, dtype=dtype, device=dev),
        active=torch.ones(n, dtype=torch.bool, device=dev),
        prev_p=ray.o, prev_bsdf_pdf=torch.ones(n, dtype=dtype, device=dev),
        prev_bsdf_delta=torch.ones(n, dtype=torch.bool, device=dev))
    for _ in range(max_depth):
        st = _bounce_spectral(scene, st, lam, max_depth, rr_depth)
    return st.L, st.depth > 0


def _bin_spectrum(S, lam, pdf, n_bins: int):
    """The specfilm's binning (src/films/specfilm.cpp): the Monte Carlo
    mean spectral radiance in ``n_bins`` equal bins over the visible
    range.  S, lam, pdf (N, K) -> (N, n_bins)."""
    width = (sp.LAMBDA_MAX - sp.LAMBDA_MIN) / n_bins
    b = torch.clamp(((lam - sp.LAMBDA_MIN) / width).to(torch.int64), 0,
                    n_bins - 1)
    w = sp._inv_pdf(pdf) / width
    out = torch.zeros(S.shape[:-1] + (n_bins,), dtype=S.dtype,
                      device=S.device)
    return out.scatter_add_(-1, b, S * w) / S.shape[-1]


def _render(scene, seed, sensor_idx, spp, max_depth, rr_depth, k, mode,
            n_bins):
    sensor, _, sampler, ray, weight, pos = common.camera(
        scene, seed, sensor_idx, spp)
    sampler, u_lam = smp.next_1d(sampler)
    lam, pdf = sp.sample_wavelengths(u_lam, k)
    S, _ = sample_spectral(scene, sampler, ray, lam, max_depth, rr_depth)
    if mode == "rgb":
        value = sp.spectrum_to_rgb(S, lam, pdf)
    elif mode == "mono":
        value = sp.spectrum_to_mono(S, lam, pdf)
    else:
        value = _bin_spectrum(S, lam, pdf, n_bins)
    # the sensors' weights are achromatic: 'mono' and 'spec' take the
    # first channel
    value = value * (weight if mode == "rgb" else weight[..., :1])
    if sensor.rfilter == "box":
        return films.accumulate_coalesced(value, sensor.width,
                                          sensor.height, spp)
    data, w = films.splat_coalesced(pos - torch.floor(pos), value,
                                    sensor.width, sensor.height, spp,
                                    sensor.rfilter)
    return films.develop(data, w)


def render_spectral(scene, seed: int = 0, sensor_idx: int = 0,
                    spp: int = 16, max_depth: int = 6, rr_depth: int = 5,
                    k: int = 4, mode: str = "rgb", n_bins: int = 16
                    ) -> torch.Tensor:
    """One pass of spectral path tracing developed by ``mode``: 'rgb'
    (H, W, 3), 'mono' (H, W, 1) or 'spec' (H, W, n_bins), with ``k``
    wavelengths a lane (:176-212)."""
    if mode not in MODES.values():
        raise ValueError(f"unknown spectral development mode {mode!r}")
    return common.detached(scene, lambda: _render(
        scene, seed, sensor_idx, spp, max_depth, rr_depth, k, mode, n_bins))
