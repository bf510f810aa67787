"""Polarized path transport: Stokes vectors and a Mueller throughput
(counterpart of ``integrators/polarized.py``; the reference's
``*_polarized`` variants and src/integrators/stokes.cpp).

The wavefront carries a Mueller throughput ``T`` (N, 4, 4, 3), the
ordered product M_1 M_2 ... of the scattering matrices along the camera
path, and adds ``T S_emit`` for each light it reaches.  The scalar
pipeline (``models/bsdf.py``) stays the authority on energy: every
physical Mueller matrix is rescaled so that its unpolarized response
M[0, 0] is the scalar BSDF's weight, so S0 is the unpolarized estimator
and only the polarization's ratios and phases come from the matrices.

The matrices:

- conductor and roughconductor: the complex-IOR specular reflection
  (conductor.cpp's polarized branch);
- dielectric, thindielectric, roughdielectric: the real-IOR reflection
  (with the phase of total internal reflection) and the transmission
  amplitudes;
- polarizer, retarder, circular: the ideal elements, rotated by the
  slot's ``pol_theta`` (src/bsdfs/{polarizer,retarder,circular}.cpp);
- measured_polarized: the pBSDF table's matrix, its measurement frames
  rotated into the pipeline's bases (measured_polarized.cpp:243-299);
- every other kind: the ideal depolarizer, as in the reference.

Each bounce issues one closest-hit query (K1 on a scene of at most
``ops/accel.py`` ``BRUTE_FORCE_MAX_TRIS`` triangles, K2 on a BVH scene)
and one shadow-ray query (K1's any hit, K3), through ``path._nee``.  The
render is primal only: the reference stops the gradient of the scene
(``jax.lax.stop_gradient``, :297), here ``common.detached``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import math as m
from ..core import mueller as mu
from ..models import bsdf as B
from ..models import films
from ..models import measured_polarized as mp_mod
from ..models import samplers as smp
from ..models.records import Ray
from . import common
from . import path as P

#: the table columns ``physical_mueller`` reads
_FIELDS = ("kind", "eta", "eta_c", "k_c", "specular_transmittance",
           "pol_theta", "pol_delta", "reflectance_tex")


def _safe_basis(forward: torch.Tensor, candidate: torch.Tensor):
    """``candidate`` projected perpendicular to ``forward`` and normalized;
    the implicit Stokes basis where that is degenerate (:46-54)."""
    perp = candidate - m.dot(candidate, forward, keepdim=True) * forward
    ok = m.dot(perp, perp) > 1e-12
    perp = torch.where(ok[..., None], perp, mu.stokes_basis(forward))
    return m.normalize(perp)


def _fresnel_mueller_world(h_w, wi_w, wo_w, cos_i, eta_re, eta_im,
                           transmission=None, eta_t=None):
    """The Mueller matrix of a specular event in the world's implicit
    Stokes bases, for light arriving along -wo_w and leaving along +wi_w
    (:57-78): reflection at the complex relative IOR (eta_re, eta_im)
    about the normal ``h_w``, transmission at ``eta_t`` on the lanes of
    ``transmission``."""
    M = mu.specular_reflection(cos_i[..., None], eta_re, eta_im)
    if transmission is not None:
        Mt = mu.specular_transmission(cos_i[..., None], eta_t)
        M = torch.where(transmission[..., None, None, None], Mt, M)
    in_fwd, out_fwd = -wo_w, wi_w
    s_in = _safe_basis(in_fwd, m.cross(h_w, -wo_w))
    s_out = _safe_basis(out_fwd, m.cross(h_w, wi_w))
    return mu.rotate_mueller_basis(
        M, in_fwd, s_in, mu.stokes_basis(in_fwd),
        out_fwd, s_out, mu.stokes_basis(out_fwd))


def physical_mueller(scene, si, wo_local, hf):
    """Each lane's physical Mueller matrix (N, 4, 4, 3) in the world's
    implicit bases and its unpolarized response M[0, 0] (N, 3) (:81-177).
    ``hf``: the sampled microfacet normal (local), zero where there is
    none (NEE, delta lobes), where the half vector is rebuilt.  Kinds
    without a polarized model are the ideal depolarizer (M00 = 1)."""
    kinds = scene.static.bsdf_kinds
    p = B.gather_params(scene.bsdfs, si.bsdf_index, _FIELDS)
    n = si.p.shape[0]
    wi_loc = si.wi
    wi_w = si.to_world(wi_loc)
    wo_w = si.to_world(wo_local)
    kind = p["kind"]
    M = mu.depolarizer(torch.ones((n, 3), dtype=si.p.dtype,
                                  device=si.p.device))

    cond_kinds = (B.KIND_CONDUCTOR, B.KIND_ROUGHCONDUCTOR)
    diel_kinds = (B.KIND_DIELECTRIC, B.KIND_THINDIELECTRIC,
                  B.KIND_ROUGHDIELECTRIC)
    if any(k in kinds for k in cond_kinds + diel_kinds):
        is_cond = (kind == cond_kinds[0]) | (kind == cond_kinds[1])
        is_diel = ((kind == diel_kinds[0]) | (kind == diel_kinds[1])
                   | (kind == diel_kinds[2]))
        # transmission: the two directions on opposite sides
        transmission = is_diel & (wi_loc[..., 2] * wo_local[..., 2] < 0.0)
        eta_s = p["eta"]
        eta_rel = torch.where(wi_loc[..., 2] >= 0.0, eta_s, 1.0 / eta_s)
        # the half vector: the sampled microfacet normal, else rebuilt
        # (reflection wi + wo, refraction wi + eta wo)
        h_refl = wi_loc + wo_local
        h_refr = wi_loc + eta_rel[..., None] * wo_local
        h = torch.where(transmission[..., None], h_refr, h_refl)
        h = torch.where(m.dot(hf, hf)[..., None] > 1e-12, hf,
                        m.normalize(h, 1e-12))
        h = h * torch.sign(h[..., 2:3] * torch.sign(wi_loc[..., 2:3])
                           + 1e-20)
        cos_i = torch.abs(m.dot(wi_loc, h))
        eta3 = eta_rel[..., None].expand(n, 3)
        eta_re = torch.where(is_cond[..., None], p["eta_c"], eta3)
        eta_im = torch.where(is_cond[..., None], p["k_c"], 0.0)
        Mf = _fresnel_mueller_world(si.to_world(h), wi_w, wo_w, cos_i,
                                    eta_re, eta_im,
                                    transmission=transmission, eta_t=eta3)
        M = torch.where((is_cond | is_diel)[..., None, None, None], Mf, M)

    pol_kinds = (B.KIND_POLARIZER, B.KIND_RETARDER, B.KIND_CIRCULAR)
    if any(k in kinds for k in pol_kinds):
        trans = p["specular_transmittance"]
        # straight through: light arrives along -wo_w (= wi_w on the null
        # lobe) and leaves along wi_w; the element's reference axis is the
        # surface's local x axis
        fwd = wi_w
        x_loc = torch.zeros_like(wi_loc)
        x_loc[..., 0] = 1.0
        x_w = _safe_basis(fwd, si.to_world(x_loc))
        Mp = mu.rotated_element(p["pol_theta"], mu.linear_polarizer(trans))
        Mr = (mu.rotated_element(p["pol_theta"], mu.linear_retarder(
            p["pol_delta"][..., None])) * trans[..., None, None, :])
        Mc = mu.circular_polarizer(trans)
        Me = torch.where((kind == B.KIND_POLARIZER)[..., None, None, None],
                         Mp, torch.where(
                             (kind == B.KIND_RETARDER)[..., None, None, None],
                             Mr, Mc))
        Me = mu.rotate_mueller_basis_collinear(Me, fwd, x_w,
                                               mu.stokes_basis(fwd))
        is_pol = ((kind == pol_kinds[0]) | (kind == pol_kinds[1])
                  | (kind == pol_kinds[2]))
        M = torch.where(is_pol[..., None, None, None], Me, M)

    if B.KIND_MEASURED_POLARIZED in kinds:
        # the table's Mueller matrix, its measurement frames rotated to
        # the world's implicit bases
        is_mp = kind == B.KIND_MEASURED_POLARIZED
        in_fwd, out_fwd = -wo_w, wi_w
        for i, tex in scene.bsdf_textures().items():
            if tex.kind != "pbsdf":
                continue
            Mt, xo_hat, xi_hat, ok = mp_mod.eval_mueller_frames(
                tex, wi_loc, wo_local)
            Mt = mu.rotate_mueller_basis(
                Mt, in_fwd, si.to_world(xo_hat), mu.stokes_basis(in_fwd),
                out_fwd, si.to_world(xi_hat), mu.stokes_basis(out_fwd))
            sel = is_mp & (p["reflectance_tex"] == i) & ok
            M = torch.where(sel[..., None, None, None], Mt, M)

    return M, M[..., 0, 0, :]


def mueller_weight(scene, si, wo_local, w_rgb, hf, active):
    """The Mueller weight of the sampled direction: the physical matrix
    rescaled so that M[0, 0] is the scalar weight ``w_rgb`` (:180-188);
    0 off ``active``."""
    M, m00 = physical_mueller(scene, si, wo_local, hf)
    M = M * (w_rgb / torch.clamp(m00, min=1e-12))[..., None, None, :]
    return torch.where(active[..., None, None, None], M, 0.0)


def stokes_column(scene, si, wo_local, lr_rgb, active):
    """The Stokes contribution (N, 4, 3) of unpolarized light arriving
    along ``wo_local`` with scalar contribution ``lr_rgb``: the first
    column of the M00-normalized physical matrix (:191-199)."""
    M, m00 = physical_mueller(scene, si, wo_local, torch.zeros_like(si.p))
    col = M[..., :, 0, :] / torch.clamp(m00[..., None, :], min=1e-12)
    col = col * lr_rgb[..., None, :]
    return torch.where(active[..., None, None], col, 0.0)


@dataclass(frozen=True)
class PolState:
    sampler: smp.Sampler
    ray_o: torch.Tensor            # (N, 3)
    ray_d: torch.Tensor            # (N, 3)
    depth: torch.Tensor            # (N,) int32
    S: torch.Tensor                # (N, 4, 3) Stokes so far
    T: torch.Tensor                # (N, 4, 4, 3) Mueller throughput
    eta: torch.Tensor              # (N,)
    active: torch.Tensor           # (N,) bool
    prev_p: torch.Tensor           # (N, 3)
    prev_bsdf_pdf: torch.Tensor    # (N,)
    prev_bsdf_delta: torch.Tensor  # (N,) bool


def _pol_bounce(scene, st: PolState, max_depth: int,
                rr_depth: int) -> PolState:
    """One polarized bounce of the wavefront (:216-276): the emission at
    the hit through T, NEE through T and the hit's Stokes column, then
    BSDF sampling, T times the Mueller weight, and Russian roulette on
    |T00|.  The sampler draws as ``path``'s bounce does."""
    _, si, le, active_next, active_em = P.hit_unweighted(scene, st,
                                                         max_depth)
    # emission at the hit, unpolarized: T (le, 0, 0, 0) = T[:, :, 0] le
    dS = st.T[..., :, 0, :] * le[..., None, :]
    S = st.S + torch.where(st.active[..., None, None], dS, 0.0)

    sampler, ds, lr_dir, active_em, _ = P._nee(scene, si, st.sampler,
                                               active_em)
    col = stokes_column(scene, si, si.to_local(ds.d), lr_dir, active_em)
    S = S + mu.matvec(st.T, col)

    sampler, s1 = smp.next_1d(sampler)
    sampler, s2 = smp.next_2d(sampler)
    bs, bsdf_weight, ok = B.sample(
        scene.bsdfs, scene.static.bsdf_kinds, si.bsdf_index, si.wi, s1, s2,
        active_next, uv=si.uv, textures=scene.bsdf_textures(),
        vcolor=si.vcolor)
    Mw = mueller_weight(scene, si, bs.wo,
                        torch.where(ok[..., None], bsdf_weight, 0.0), bs.hf,
                        active_next & ok)
    T = mu.matmul(st.T, Mw)

    new_ray = si.spawn_ray(si.to_world(bs.wo))
    eta = st.eta * torch.where(ok, bs.eta, 1.0)
    beta_max = torch.amax(torch.abs(T[..., 0, 0, :]), dim=-1)
    active_next = active_next & (beta_max != 0.0)
    rr_prob = torch.clamp(beta_max * eta * eta, max=0.95)
    rr_active = st.depth >= rr_depth
    T = torch.where(rr_active[..., None, None, None],
                    T / torch.clamp(rr_prob, min=1e-8)[..., None, None, None],
                    T)
    sampler, rr_u = smp.next_1d(sampler)
    active_next = active_next & (~rr_active | (rr_u < rr_prob))
    return PolState(
        sampler=sampler, ray_o=new_ray.o, ray_d=new_ray.d,
        depth=st.depth + si.valid.to(st.depth.dtype), S=S, T=T, eta=eta,
        active=active_next, prev_p=si.p, prev_bsdf_pdf=bs.pdf,
        prev_bsdf_delta=B.has_flag(bs.sampled_type, B.BSDFFlags.Delta))


def sample_stokes(scene, sampler, ray: Ray, max_depth: int,
                  rr_depth: int = 5) -> torch.Tensor:
    """The polarized radiance estimate: Stokes (N, 4, 3) in the implicit
    basis of each camera ray's -d (:279-303)."""
    n = ray.o.shape[0]
    dtype, device = ray.o.dtype, ray.o.device
    st = PolState(
        sampler=sampler, ray_o=ray.o, ray_d=ray.d,
        depth=torch.zeros(n, dtype=torch.int32, device=device),
        S=torch.zeros((n, 4, 3), dtype=dtype, device=device),
        T=mu.identity((n,), 3, dtype, device),
        eta=torch.ones(n, dtype=dtype, device=device),
        active=torch.ones(n, dtype=torch.bool, device=device),
        prev_p=ray.o,
        prev_bsdf_pdf=torch.ones(n, dtype=dtype, device=device),
        prev_bsdf_delta=torch.ones(n, dtype=torch.bool, device=device))
    for _ in range(max_depth):
        st = _pol_bounce(scene, st, max_depth, rr_depth)
    return st.S


def _render(scene, seed, sensor_idx, spp, max_depth):
    sensor, n, sampler, ray, weight, _ = common.camera(scene, seed,
                                                       sensor_idx, spp)
    S = sample_stokes(scene, sampler, ray, max_depth, 5)
    # into the sensor's frame: from the implicit basis of -d to the
    # camera's x axis projected perpendicular to it
    fwd = -ray.d
    tgt = _safe_basis(fwd, sensor.to_world[:3, 0].expand(fwd.shape))
    S = mu.matvec(mu.rotate_stokes_basis(fwd, mu.stokes_basis(fwd), tgt), S)
    S = S * weight[..., None, :]
    vals = torch.cat([S[:, 0, :], S.reshape(n, 12)], dim=-1)
    return films.accumulate_coalesced(vals, sensor.width, sensor.height, spp)


def render_stokes(scene, seed: int = 0, sensor_idx: int = 0, spp: int = 4,
                  max_depth: int = 4) -> torch.Tensor:
    """The Stokes integrator with polarized transport (stokes.cpp in a
    ``*_polarized`` variant; :306-335): (H, W, 3 + 12), the developed RGB
    (= S0), then S0, S1, S2 and S3, each RGB.  The arriving Stokes vector
    is turned from the implicit basis of -d into the sensor's horizontal
    axis.  Every pixel is the mean of its lanes, whatever the filter.
    Every scene leaf that requires grad gets a zero gradient."""
    return common.detached(scene, lambda: _render(
        scene, seed, sensor_idx, spp, max_depth))
