"""EPSM manifold integrators, ``manifold`` and ``manifold_caustic``
(counterpart of ``integrators/epsm.py``).

- ``render_epsm``: the primal render and two zero "position" channels,
  an (H, W, 5) image, as a ``torch.autograd.Function`` whose backward is
  ``render_backward``.
- ``sample_path_logged``: the path tracer, recording each bounce's
  manifold data for up to ``K_LOG`` bounces.
- ``calc_grad``: the extended-path-space-manifold constraint system.
  Every constraint row pair is a closed-form residual (``_residual``);
  its Jacobians come from reverse passes over the sum across lanes
  (``_row_jacobians_all``), and the block systems are solved with
  ``ops/linalg.py`` ``inv_small``.
- ``render_backward``: image-position gradients -> ray-direction
  gradients by ray differentials, their derivative through the first
  hit, ``calc_grad``, then injection into vertex positions and normals,
  the emitter geometry and the GGX roughness ``alpha`` by scatter over
  the logged hit topology; the colour channels' adjoint goes through the
  PRB replay (``ad/prb.py`` ``prb_backward``).

Lanes are independent: the Jacobian of a per-lane function is the
gradient of its sum across lanes, one reverse pass an output component.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch

from ..core import math as m
from ..core import warp
from ..integrators import common, path as P
from ..models import bsdf as B
from ..models import films, samplers as smp
from ..models.records import Ray, RayFlags
from ..ops import cuda_traverse as CT
from ..ops import intersect as I
from ..ops.linalg import inv_small

K_LOG = 5  # logged bounces (epsm.py:648 ``iteration < 5``)


def _mat_vec(A: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """sum_r A[n, r] rows[n, ..., r, c] over r: the batched row-vector
    products of ``calc_grad``, in float32 by elementwise products (no
    matmul, so no TF32 whatever the global settings)."""
    return torch.sum(A[..., :, None] * rows, dim=-2)


# ---------------------------------------------------------------------------
# the reference constraint's local frame (epsm.py:746-756)
# ---------------------------------------------------------------------------

def _constraint_frame(n):
    """Rows (tangent, bitangent, normal); tangent = normalize([0,-nz,ny])."""
    nn = n * m.safe_rsqrt(m.squared_norm(n))[..., None]
    t = torch.stack([torch.zeros_like(nn[..., 0]), -nn[..., 2], nn[..., 1]],
                    dim=-1)
    t = t * m.safe_rsqrt(torch.clamp(m.squared_norm(t), min=1e-12))[..., None]
    b = m.cross(nn, t)
    return t, b, nn


def to_constraint_local(n, v):
    t, b, nn = _constraint_frame(n)
    return torch.stack([m.dot(v, t), m.dot(v, b), m.dot(v, nn)], dim=-1)


# ---------------------------------------------------------------------------
# Pass 1: logged path sampling
# ---------------------------------------------------------------------------

class PathLog(NamedTuple):
    """Per-bounce logs, leading dims (K, N) (epsm.py:648-654, with the hit
    topology that lets the injection scatter instead of re-trace)."""
    active: torch.Tensor        # (K, N) active & si.valid
    bsdf_flags: torch.Tensor    # (K, N) int32
    bsdf_index: torch.Tensor    # (K, N)
    ismesh: torch.Tensor        # (K, N)
    light: torch.Tensor         # (K, N, 3) NEE sampled position ds.p
    active_em: torch.Tensor     # (K, N)
    p0: torch.Tensor            # (K, N, 3)
    p1: torch.Tensor
    p2: torch.Tensor
    p: torch.Tensor
    b0: torch.Tensor            # (K, N)
    b1: torch.Tensor
    normal: torch.Tensor        # (K, N, 3) shading normal
    n0: torch.Tensor            # (K, N, 3)
    n1: torch.Tensor
    n2: torch.Tensor
    eta: torch.Tensor           # (K, N)
    hf: torch.Tensor            # (K, N, 3) microfacet normal, constraint frame
    prim_index: torch.Tensor    # (K, N)
    lr_dir: torch.Tensor        # (K, N, 3) NEE contribution
    em_prim: torch.Tensor       # (K, N) NEE shadow-ray hit triangle
    em_b0: torch.Tensor         # (K, N)
    em_b1: torch.Tensor
    em_hit_valid: torch.Tensor  # (K, N)
    em_dist_ratio: torch.Tensor  # (K, N) |hit - ds.p| / |si.p - ds.p|
    wi_local: torch.Tensor      # (K, N, 3)
    s2_bsdf: torch.Tensor       # (K, N, 2) the BSDF sample's randoms


def sample_path_logged(scene, sampler, ray: Ray, max_depth: int,
                       rr_depth: int):
    """The primal trace recording manifold data (epsm.py:503-742), drawing
    from the sampler as the reference does, the detached and then the
    attached BSDF draws included (epsm.py:633-643).  Each bounce queries
    the closest hit, the shadow ray and the closest hit along the NEE
    direction (its hit topology), all with maxt inf as in the reference.
    Detached.  Returns (L, valid, PathLog)."""
    with torch.no_grad():
        return _sample_path_logged(scene, sampler, ray, max_depth, rr_depth)


def _sample_path_logged(scene, sampler, ray, max_depth, rr_depth):
    n = ray.o.shape[0]
    st = P.init_state(sampler, ray, n)
    kinds = scene.static.bsdf_kinds
    k_log = min(max_depth, K_LOG)
    logs = []
    for it in range(max_depth):
        ray_b = Ray.make(st.ray_o, st.ray_d)
        pi = scene.ray_intersect_preliminary(ray_b)
        pi = pi.replace(valid=pi.valid & st.active)
        si = I.compute_surface_interaction(scene, ray_b, pi, RayFlags.All)

        le = st.beta * P._emitter_hit_le(
            scene, si, st.ray_d, st.prev_p, st.prev_bsdf_pdf,
            st.prev_bsdf_delta, st.active)

        bsdf_flags = B.flags_of(scene.bsdfs, si.bsdf_index)
        active_next = (st.depth + 1 < max_depth) & si.valid & st.active
        active_em = active_next & B.has_flag(bsdf_flags, B.BSDFFlags.Smooth)

        smp_, ds, lr_dir, active_em2, _ = P._nee(scene, si, st.sampler,
                                                  active_em)
        lr_dir = st.beta * lr_dir

        # the NEE direction's hit topology (the ray_direct FollowShape
        # analog, epsm.py:609-627)
        pi_dir = scene.ray_intersect_preliminary(si.spawn_ray(ds.d))
        f_dir = scene.faces[pi_dir.prim_index.long()].long()
        u_d, v_d = pi_dir.prim_uv[:, 0], pi_dir.prim_uv[:, 1]
        b0d = 1.0 - u_d - v_d
        hp = (scene.vertices[f_dir[:, 0]] * b0d[:, None]
              + scene.vertices[f_dir[:, 1]] * u_d[:, None]
              + scene.vertices[f_dir[:, 2]] * v_d[:, None])
        denom = torch.clamp(torch.sqrt(m.squared_norm(ds.p - si.p)),
                            min=1e-12)
        dis_ratio = torch.sqrt(m.squared_norm(ds.p - hp)) / denom
        dis_ratio = torch.where(dis_ratio < 0.01, 0.0, dis_ratio)

        # detached + attached BSDF sampling: two draws (epsm.py:633-643)
        smp_, _ = smp.next_1d(smp_)
        smp_, _ = smp.next_2d(smp_)
        smp_, s1 = smp.next_1d(smp_)
        smp_, s2 = smp.next_2d(smp_)
        bs, bsdf_weight, ok = B.sample(scene.bsdfs, kinds, si.bsdf_index,
                                       si.wi, s1, s2, active_next)

        L = st.L + torch.where(st.active[..., None], le + lr_dir, 0.0)
        new_ray = si.spawn_ray(si.to_world(bs.wo))
        eta = st.eta * torch.where(ok, bs.eta, 1.0)
        beta = st.beta * torch.where(ok[..., None], bsdf_weight, 0.0)
        beta_max = torch.amax(beta, dim=-1)
        active_next = active_next & (beta_max != 0.0)
        rr_prob = torch.clamp(beta_max * eta * eta, max=0.95)
        rr_active = st.depth >= rr_depth
        beta = torch.where(rr_active[..., None],
                           beta / torch.clamp(rr_prob, min=1e-8)[..., None],
                           beta)
        smp_, rr_u = smp.next_1d(smp_)
        active_next = active_next & (~rr_active | (rr_u < rr_prob))
        st_next = P.LoopState(
            sampler=smp_, ray_o=new_ray.o, ray_d=new_ray.d,
            depth=st.depth + si.valid.to(st.depth.dtype), L=L, beta=beta,
            eta=eta, active=active_next, prev_p=si.p, prev_bsdf_pdf=bs.pdf,
            prev_bsdf_delta=B.has_flag(bs.sampled_type, B.BSDFFlags.Delta))
        if it < k_log:
            # the half vector in the constraint frame of the logged normal
            hf_con = to_constraint_local(si.sh_n, si.to_world(bs.hf))
            logs.append(PathLog(
                active=st.active & si.valid, bsdf_flags=bsdf_flags,
                bsdf_index=si.bsdf_index, ismesh=si.ismesh, light=ds.p,
                active_em=active_em2, p0=si.p0, p1=si.p1, p2=si.p2,
                p=si.p, b0=si.b0, b1=si.b1, normal=si.sh_n, n0=si.n0,
                n1=si.n1, n2=si.n2, eta=bs.eta, hf=hf_con,
                prim_index=si.prim_index, lr_dir=lr_dir,
                em_prim=pi_dir.prim_index, em_b0=b0d, em_b1=u_d,
                em_hit_valid=pi_dir.valid, em_dist_ratio=dis_ratio,
                wi_local=si.wi, s2_bsdf=s2))
        st = st_next
    log = PathLog(*(torch.stack(f) for f in zip(*logs)))
    return st.L, st.depth > 0, log


# ---------------------------------------------------------------------------
# Constraint residuals and their Jacobians
# ---------------------------------------------------------------------------

def _interp(Pm, uv):
    return (Pm[:, 0] * uv[:, 0:1] + Pm[:, 1] * uv[:, 1:2]
            + Pm[:, 2] * (1.0 - uv[:, 0:1] - uv[:, 1:2]))


def _residual(uv_prev, uv_cur, uv_next, P_prev, P_cur, P_next, dn, light,
              n012_cur, eta_cur, use_light: bool, detach_frame: bool,
              position_row: bool):
    """Closed-form half-vector residual of one bounce on (M, ...) lanes
    (epsm.py:809-821): (M, 2).

    ``dn`` is a zero input whose Jacobian equals dc/dn for the independent
    interpolated-normal parameter (the reference's ``add(n)``); the uv
    Jacobians include the path through the interpolated normal.
    ``position_row``: the caustic ``wo2 - detach(wo2)`` row (epsm.py:1028),
    the Jacobian of wo2 alone."""
    point_prev = _interp(P_prev, uv_prev)
    point_cur = _interp(P_cur, uv_cur)
    point_next = light if use_light else _interp(P_next, uv_next)

    wi = point_prev - point_cur
    wo = point_next - point_cur
    wi = wi * m.safe_rsqrt(m.squared_norm(wi))[:, None]
    wo = wo * m.safe_rsqrt(m.squared_norm(wo))[:, None]

    nvec = _interp(n012_cur, uv_cur) + dn
    if detach_frame:
        nvec = nvec.detach()
    t, b, nn = _constraint_frame(nvec)
    wi2 = torch.stack([m.dot(wi, t), m.dot(wi, b), m.dot(wi, nn)], dim=-1)
    wo2 = torch.stack([m.dot(wo, t), m.dot(wo, b), m.dot(wo, nn)], dim=-1)
    if position_row:
        return wo2[:, :2]
    res = wi2 + wo2 * eta_cur[:, None]
    res = res * m.safe_rsqrt(m.squared_norm(res))[:, None]
    return res[:, :2]


_JAC_ARGS = ("uv_prev", "uv_cur", "uv_next", "P_prev", "P_cur", "P_next",
             "dn", "light")


def _row_jacobians_all(logs: PathLog, cam, use_light: bool,
                       detach_frame: bool, position_row: bool):
    """Jacobians of all K bounces' residuals over the K * N stacked lanes
    (``_row_jacobians_all``, :260-316): two reverse passes, one a residual
    component, over the sum across lanes.  Returns a dict of (K, N, 2,
    ...) tensors.

    The camera vertex (bounce 0's previous point) is a degenerate
    triangle with all three vertices at the camera, at uv 0.3."""
    K, N = logs.b0.shape
    uv = torch.stack([logs.b0, logs.b1], -1)                    # (K, N, 2)
    Pt = torch.stack([logs.p0, logs.p1, logs.p2], 2)            # (K, N, 3, 3)
    cam_tri = cam.expand(N, 3)
    cam_P = torch.stack([cam_tri, cam_tri, cam_tri], 1)[None]
    uv_prev = torch.cat([torch.full((1, N, 2), 0.3, dtype=uv.dtype,
                                    device=uv.device), uv[:-1]], 0)
    P_prev = torch.cat([cam_P, Pt[:-1]], 0)
    uv_next = torch.cat([uv[1:], torch.zeros_like(uv[:1])], 0)
    P_next = torch.cat([Pt[1:], torch.zeros_like(Pt[:1])], 0)
    n012 = torch.stack([logs.n0, logs.n1, logs.n2], 2)

    def flat(x):
        return x.reshape((K * N,) + x.shape[2:]).detach()

    args = [flat(uv_prev), flat(uv), flat(uv_next), flat(P_prev), flat(Pt),
            flat(P_next), torch.zeros((K * N, 3), dtype=uv.dtype,
                                      device=uv.device), flat(logs.light)]
    args = [a.clone().requires_grad_(True) for a in args]
    with torch.enable_grad():
        res = _residual(*args, flat(n012), logs.eta.reshape(-1), use_light,
                        detach_frame, position_row)
        rows = []
        for r in range(2):
            g = torch.autograd.grad(res[:, r].sum(), args, retain_graph=r == 0,
                                    allow_unused=True)
            rows.append([torch.zeros_like(a) if gi is None else gi
                         for a, gi in zip(args, g)])
    out = {name: torch.stack([rows[0][i], rows[1][i]], 1).reshape(
        (K, N, 2) + args[i].shape[1:]) for i, name in enumerate(_JAC_ARGS)}
    j_m = torch.zeros((K, N, 2, 3), dtype=uv.dtype, device=uv.device)
    if (not use_light) and (not position_row):
        # hf enters as ``res - m``: d/dm = -I (epsm.py:883)
        j_m[..., 0, 0] = -1.0
        j_m[..., 1, 1] = -1.0
    out["m_hf"] = j_m
    out["point_next"] = torch.sum(out["P_next"], dim=3)
    return out


def _slice_jacs(jall, k):
    return {key: v[k] for key, v in jall.items()}


# ---------------------------------------------------------------------------
# calc_grad: the manifold solve
# ---------------------------------------------------------------------------

class _ParamBank:
    """The reference's param_list / param_grad_list (epsm.py:764-769): for
    each of the 5K parameters (p0, p1, p2, n, m of every bounce; index
    5k + j) a (N, 2K, 3) bank of constraint-row Jacobians, held as one
    (N, 5K, 2K, 3) tensor, and its accumulated dL/dtheta (N, 5K, 3).  A
    parameter whose rows were never written holds zeros and so adds
    nothing, as a parameter the reference has not added yet."""

    def __init__(self, K: int, N: int, dtype, device):
        self.K = K
        self.rows = torch.zeros((N, 5 * K, 2 * K, 3), dtype=dtype,
                                device=device)
        self.grads = torch.zeros((N, 5 * K, 3), dtype=dtype, device=device)

    def set_rows(self, idx, k, jacs, mask=None):
        """Row pair of bounce k of parameter ``idx`` from (N, 2, 3)
        Jacobians, on the lanes of ``mask`` (all when None)."""
        old = self.rows[:, idx, 2 * k:2 * k + 2]
        self.rows[:, idx, 2 * k:2 * k + 2] = (
            jacs if mask is None else torch.where(mask[:, None, None], jacs,
                                                  old))

    def zero_rows_masked(self, k, mask):
        old = self.rows[:, :, 2 * k:2 * k + 2]
        self.rows[:, :, 2 * k:2 * k + 2] = torch.where(
            mask[:, None, None, None], 0.0, old)

    def chain_all(self, A, n_sys, mask):
        """grads += mask * (-A . rows[:, :, :n_sys]) (epsm.py:849-857)."""
        g = torch.nan_to_num(-_mat_vec(A[:, None], self.rows[:, :, :n_sys]))
        self.grads += torch.where(mask[:, None, None], g, 0.0)


def _write_C_rows(C, k, jac, K):
    """Row pair 2k..2k+1; the uv of bounce j (0-based) at columns
    2j+2..2j+3, the reference layout where the solve slices columns
    2:2id+2."""
    r = 2 * k
    if k > 0:
        C[:, r:r + 2, 2 * k:2 * k + 2] = jac["uv_prev"]
    C[:, r:r + 2, 2 * k + 2:2 * k + 4] = jac["uv_cur"]
    if k + 1 < K:
        C[:, r:r + 2, 2 * k + 4:2 * k + 6] = jac["uv_next"]


def _write_C_rows_masked(C, row_k, jac_row, col_k, K, mask):
    """Caustic substitution: row pair ``row_k`` replaced, on the lanes of
    ``mask``, by the position row of bounce ``col_k`` (epsm.py:1053-1056)."""
    r = 2 * row_k
    block = torch.zeros_like(C[:, r:r + 2])
    block[:, :, 2 * col_k + 2:2 * col_k + 4] = jac_row["uv_cur"]
    if col_k + 1 < K:
        block[:, :, 2 * col_k + 4:2 * col_k + 6] = jac_row["uv_next"]
    C[:, r:r + 2] = torch.where(mask[:, None, None], block, C[:, r:r + 2])


def calc_grad(logs: PathLog, dlduv1, dldp1, cam, caustic: bool):
    """ManifoldIntegrator.calc_grad (epsm.py:745-946) and its caustic form
    (:951-1200).

    dlduv1: (N, 2K), only the first two entries nonzero (dL/db0, dL/db1 at
    the first hit); dldp1: (N, 3) dL/dp at the first hit.  Returns
    (path_grad (K, 5, N, 3): [p0, p1, p2, n, m (constraint frame)] a
    bounce, light_grad (K, N, 3), diffuse_grad (K, N, 3)), each with the
    reference's outlier clamp |g| > 0.1 -> 0.  The reference's ``Lt``
    argument is never read in its body (epsm.py:275, :296, :540)."""
    with torch.no_grad():
        return _calc_grad(logs, dlduv1, dldp1, cam, caustic)


def _calc_grad(logs, dlduv1, dldp1, cam, caustic):
    K, N = logs.b0.shape
    f32, dev = logs.b0.dtype, logs.b0.device

    isdiffuse = B.has_flag(logs.bsdf_flags, B.BSDFFlags.Diffuse)
    isnull = B.has_flag(logs.bsdf_flags, B.BSDFFlags.Null)
    hasdiffuse = torch.cumsum(isdiffuse.to(f32), dim=0)  # incl. current
    valid_chain = (torch.cumprod((logs.ismesh > 0).to(f32), dim=0)
                   * (hasdiffuse < 2)) > 0
    bounce_ids = torch.arange(1, K + 1, dtype=f32, device=dev)[:, None]
    diffuse_pos = torch.where(
        torch.any(isdiffuse, 0),
        torch.amax(torch.where(isdiffuse, bounce_ids, 0.0), dim=0), 0.0)

    if caustic:
        # caustic zeroes dldp and dlduv for non-diffuse first hits
        # (epsm.py:998-999)
        dlduv1 = torch.where(isdiffuse[0][:, None], dlduv1, 0.0)
    dldp_first = torch.where(isdiffuse[0][:, None], dldp1, 0.0)

    # caustic detaches the frame in the light-row section (epsm.py:1022)
    # and keeps it attached in the bsdf-row section (epsm.py:1111)
    jl = _row_jacobians_all(logs, cam, True, caustic, False)
    jb = _row_jacobians_all(logs, cam, False, False, False)
    jac_light = [_slice_jacs(jl, k) for k in range(K)]
    jac_bsdf = [_slice_jacs(jb, k) for k in range(K)]
    del jl, jb
    if caustic:
        jpl = _row_jacobians_all(logs, cam, True, True, True)
        jpb = _row_jacobians_all(logs, cam, False, False, True)
        jac_pos_l = [_slice_jacs(jpl, k) for k in range(K)]
        jac_pos_b = [_slice_jacs(jpb, k) for k in range(K)]
        del jpl, jpb

    bank = _ParamBank(K, N, f32, dev)
    light_grad = torch.zeros((K, N, 3), dtype=f32, device=dev)
    diffuse_grad = torch.zeros((K, N, 3), dtype=f32, device=dev)
    diffuse_grad[0] = dldp_first

    def write_param_rows(k, jac):
        """Bounce k's row pair of every parameter it touches."""
        if k > 0:
            for v in range(3):
                bank.set_rows(5 * (k - 1) + v, k, jac["P_prev"][:, :, v, :])
        for v in range(3):
            bank.set_rows(5 * k + v, k, jac["P_cur"][:, :, v, :])
        if k + 1 < K:
            for v in range(3):
                bank.set_rows(5 * (k + 1) + v, k, jac["P_next"][:, :, v, :])
        bank.set_rows(5 * k + 3, k, jac["dn"])
        bank.set_rows(5 * k + 4, k, jac["m_hf"])

    def caustic_sub(C, jac_pos, k, local_rows, local_key):
        """Replace the rows of diffuse vertices j <= k+1 by the position
        rows of the current bounce (epsm.py:1051-1066), in C, the bank and
        the solve-local rows (light or next point)."""
        jp = jac_pos[k]
        for j in range(1, k + 2):
            mask = diffuse_pos == j
            _write_C_rows_masked(C, j - 1, jp, k, K, mask)
            bank.zero_rows_masked(j - 1, mask)
            for v in range(3):
                bank.set_rows(5 * k + v, j - 1, jp["P_cur"][:, :, v, :], mask)
            if k + 1 < K:
                for v in range(3):
                    bank.set_rows(5 * (k + 1) + v, j - 1,
                                  jp["P_next"][:, :, v, :], mask)
            r = 2 * (j - 1)
            local_rows[:, r:r + 2] = torch.where(
                mask[:, None, None], jp[local_key], local_rows[:, r:r + 2])

    # columns as the reference: the uv of bounce j (1-based) at columns
    # 2j..2j+1, so width 2(K+1) (path_info[0] is the camera entry)
    C = torch.zeros((N, 2 * K + 2, 2 * K + 2), dtype=f32, device=dev)
    eyeK = torch.eye(2 * K, dtype=f32, device=dev)

    def solve(n_sys, bad):
        cur = C[:, :n_sys, 2:2 + n_sys]
        cur = torch.where(bad[:, None, None], eyeK[:n_sys, :n_sys], cur)
        return _mat_vec(dlduv1[:, :n_sys], inv_small(cur))

    for k in range(K):
        n_sys = 2 * (k + 1)
        nolight = ~logs.active_em[k]
        act_k = logs.active[k]

        # ============ light-row solve (epsm.py:803-866) ============
        _write_C_rows(C, k, jac_light[k], K)
        write_param_rows(k, jac_light[k])
        # the light point's rows are solve-local (param_light_grad, :808)
        light_rows = torch.zeros((N, 2 * K, 3), dtype=f32, device=dev)
        light_rows[:, 2 * k:2 * k + 2] = jac_light[k]["light"]
        if caustic:
            caustic_sub(C, jac_pos_l, k, light_rows, "light")

        bad = (~valid_chain[k]) | (~act_k) | nolight
        A = solve(n_sys, bad)
        mask_l = (~bad) & (hasdiffuse[k] == 0)
        bank.chain_all(A, n_sys, mask_l)
        g_light = -_mat_vec(A, light_rows[:, :n_sys])
        light_grad[k] = torch.where(mask_l[:, None],
                                    torch.nan_to_num(g_light), 0.0)

        # ============ bsdf-row solve (epsm.py:868-930) ============
        if k + 1 < K:
            _write_C_rows(C, k, jac_bsdf[k], K)
            write_param_rows(k, jac_bsdf[k])
            # the next point's rows are solve-local (param_diffuse_grad)
            point_rows = torch.zeros((N, 2 * K, 3), dtype=f32, device=dev)
            point_rows[:, 2 * k:2 * k + 2] = jac_bsdf[k]["point_next"]
            if caustic:
                caustic_sub(C, jac_pos_b, k, point_rows, "point_next")

            bad_b = (~valid_chain[k]) | (~logs.active[k + 1])
            A = solve(n_sys, bad_b)
            next_diffuse = isdiffuse[k + 1]
            if caustic:
                mask_b = (~bad_b) & next_diffuse
                mask_dp = (~bad_b) & (next_diffuse | isnull[k + 1])
            else:
                mask_b = (~bad_b) & next_diffuse & (hasdiffuse[k] == 0)
                mask_dp = mask_b
            bank.chain_all(A, n_sys, mask_b)
            g_dp = -_mat_vec(A, point_rows[:, :n_sys])
            diffuse_grad[k + 1] += torch.where(mask_dp[:, None],
                                               torch.nan_to_num(g_dp), 0.0)

    # per-bounce parameter grads and the outlier clamp (epsm.py:932-944)
    def clamp(g):
        return torch.where(torch.abs(g) > 0.1, 0.0, g)

    path_grad = bank.grads.reshape(N, K, 5, 3).permute(1, 2, 0, 3)
    return clamp(path_grad), clamp(light_grad), clamp(diffuse_grad)


# ---------------------------------------------------------------------------
# Gradient injection (the pass-2 analog, epsm.py:282-297, 555-645)
# ---------------------------------------------------------------------------

def _inject_alpha(scene, logs: PathLog, k: int, gm, g_alpha):
    """Bounce k's half-vector grad ``gm`` (N, 3, constraint frame) onto
    ``g_alpha`` (B,) through the reverse pass of the attached GGX
    re-sample of the logged ``wi`` and randoms (``inject_gradients``,
    :681-704), on the glossy bounces' BSDF slots."""
    act = logs.active[k]
    gm = torch.where(act[:, None], gm, 0.0)
    # constraint frame -> world -> the logged hit's shading frame
    t, b_, nn = _constraint_frame(logs.normal[k])
    gm_world = t * gm[:, 0:1] + b_ * gm[:, 1:2] + nn * gm[:, 2:3]
    sh_s, sh_t = m.coordinate_system(logs.normal[k])
    gm_local = torch.stack([m.dot(gm_world, sh_s), m.dot(gm_world, sh_t),
                            m.dot(gm_world, logs.normal[k])], -1)
    slot = torch.clamp(logs.bsdf_index[k], min=0).long()
    with torch.enable_grad():
        alpha_n = scene.bsdfs["alpha"].detach()[slot].requires_grad_(True)
        hf = warp.ggx_visible_normal_sample(logs.wi_local[k],
                                            logs.s2_bsdf[k], alpha_n,
                                            alpha_n)
        (galpha,) = torch.autograd.grad(hf, alpha_n, gm_local)
    is_rough = B.has_flag(logs.bsdf_flags[k], B.BSDFFlags.Glossy)
    g_alpha.index_add_(0, slot, torch.where(act & is_rough,
                                            torch.nan_to_num(galpha), 0.0))


def inject_gradients(scene, logs: PathLog, path_grad, light_grad,
                     diffuse_grad, grads: Dict[str, torch.Tensor]):
    """Accumulate the manifold gradients into the scene's vertex and
    normal cotangents by scatter (``inject_gradients``, :625-729):

    - si.p0/p1/p2 * path_grad onto the hit face's vertices;
    - the diffuse receiver point (detached barycentrics) b_k * g;
    - the shading-normal grad onto the vertex normals, through the VJP of
      normalize(interp);
    - the half-vector grad onto the roughness ``alpha`` of glossy bounces'
      BSDF slots, through the reverse pass of the attached GGX re-sample
      (epsm.py:644, roughconductor.cpp:255);
    - the light grads, weighted by |Lr_dir|, onto the NEE shadow ray's hit
      face (the emitter geometry), and at the first bounce the receiver
      grad scaled by the distance ratio.

    ``grads``: 'vertices' (V, 3), 'normals' (V, 3) and 'alpha' (B,)
    accumulators; returns them updated."""
    K, N = logs.b0.shape
    faces = scene.faces
    g_v = grads["vertices"].clone()
    g_n = grads["normals"].clone()
    g_alpha = grads["alpha"].clone()
    # the alpha branch has work only where a kind of the scene is glossy
    glossy = any(B.KIND_FLAGS[kind] & B.BSDFFlags.Glossy
                 for kind in scene.static.bsdf_kinds)

    def scatter(acc, idx, val):
        acc.index_add_(0, idx, val)

    for k in range(K):
        act = logs.active[k][:, None]
        f = faces[logs.prim_index[k].long()].long()      # (N, 3)

        # triangle vertex grads
        for v in range(3):
            scatter(g_v, f[:, v], torch.where(act, path_grad[k, v], 0.0))

        # the diffuse receiver point (FollowShape: detached barycentrics)
        b0, b1 = logs.b0[k][:, None], logs.b1[k][:, None]
        b2 = 1.0 - b0 - b1
        gd = torch.where(act, diffuse_grad[k], 0.0)
        scatter(g_v, f[:, 0], b0 * gd)
        scatter(g_v, f[:, 1], b1 * gd)
        scatter(g_v, f[:, 2], b2 * gd)

        # the shading-normal grad -> vertex normals through normalize(interp)
        gn = torch.where(act, path_grad[k, 3], 0.0)
        with torch.enable_grad():
            n012 = torch.stack([logs.n0[k], logs.n1[k], logs.n2[k]],
                               1).requires_grad_(True)
            nvec = n012[:, 0] * b0 + n012[:, 1] * b1 + n012[:, 2] * b2
            nrm = nvec * m.safe_rsqrt(m.squared_norm(nvec))[:, None]
            (gn012,) = torch.autograd.grad(nrm, n012, gn)
        for v in range(3):
            scatter(g_n, f[:, v], gn012[:, v])

        if glossy:
            _inject_alpha(scene, logs, k, path_grad[k, 4], g_alpha)

        # light grads onto the NEE shadow ray's hit face, weighted by
        # |Lr_dir| (epsm.py:626-627)
        lw = torch.sum(logs.lr_dir[k], dim=-1, keepdim=True)
        act_em = (logs.active[k] & logs.em_hit_valid[k])[:, None]
        gl = torch.where(act_em, light_grad[k] * lw, 0.0)
        fe = faces[logs.em_prim[k].long()].long()
        eb0, eb1 = logs.em_b0[k][:, None], logs.em_b1[k][:, None]
        eb2 = 1.0 - eb0 - eb1
        scatter(g_v, fe[:, 0], eb0 * gl)
        scatter(g_v, fe[:, 1], eb1 * gl)
        scatter(g_v, fe[:, 2], eb2 * gl)

        # the direct-shadow receiver grads of shallow paths (epsm.py:609-620)
        if k == 0:
            gd0 = torch.where(act_em,
                              diffuse_grad[k] * logs.em_dist_ratio[k][:, None],
                              0.0)
            scatter(g_v, fe[:, 0], eb0 * gd0)
            scatter(g_v, fe[:, 1], eb1 * gd0)
            scatter(g_v, fe[:, 2], eb2 * gd0)

    return {"vertices": g_v, "normals": g_n, "alpha": g_alpha}


# ---------------------------------------------------------------------------
# render_epsm: the forward and its backward
# ---------------------------------------------------------------------------

def _primal(scene, seed, sensor_idx, spp, max_depth, rr_depth):
    """The EPSM primal (epsm.py:13-82, :755-771): the path tracer's image
    and two zero position channels, (H, W, 5).  It seeds the independent
    sampler whatever the scene names, as the reference does (:759); a
    filter other than the box is splatted by the general scatter
    (``films.splat``, :763-769)."""
    sensor = scene.sensors[sensor_idx]
    n = sensor.width * sensor.height * spp
    sampler = smp.seed(seed, n, device=scene.device)
    sampler, ray, weight, pos = common.sample_rays(sensor, sampler, spp)
    L, _ = P.sample_primal(scene, sampler, ray, max_depth, rr_depth)
    value = L * weight
    if sensor.rfilter == "box":
        img = films.accumulate_coalesced(value, sensor.width, sensor.height,
                                         spp)
    else:
        data, w = films.splat(pos, value, sensor.width, sensor.height,
                              sensor.rfilter)
        img = films.develop(data, w)
    zeros = torch.zeros(img.shape[:-1] + (2,), dtype=img.dtype,
                        device=img.device)
    return torch.cat([img, zeros], dim=-1)


class _RenderEPSM(torch.autograd.Function):
    """``_make_render_epsm``'s custom_vjp (:749-784): the inputs are the
    scene leaves that require grad; the backward is ``render_backward``
    on the backward sensor, one gradient for each leaf."""

    @staticmethod
    def forward(ctx, scene, cfg, names, *leaves):
        seed, sensor_idx, spp, max_depth, rr_depth = cfg[:5]
        ctx.scene, ctx.cfg, ctx.names = scene, cfg, names
        return _primal(scene, seed, sensor_idx, spp, max_depth, rr_depth)

    @staticmethod
    def backward(ctx, g_img):
        seed, _, _, max_depth, rr_depth, caustic, bwd_idx, bwd_spp = ctx.cfg
        scene = ctx.scene
        grads = render_backward(scene, ctx.names, g_img.contiguous(), seed,
                                max_depth, rr_depth, caustic, bwd_idx,
                                bwd_spp)
        if scene.bvh is not None and scene.device.type == "cuda":
            # a ray that ran out of traversal stack lost hits (waits)
            CT.raise_on_overflow(scene.device)
        return (None, None, None, *(grads[k] for k in ctx.names))


def render_epsm(scene, seed: int = 0, sensor_idx: int = 0, spp: int = 16,
                max_depth: int = 6, rr_depth: int = 5, caustic: bool = False,
                bwd_sensor_idx: int = -1, bwd_spp: int = 8) -> torch.Tensor:
    """One EPSM pass (``render_epsm``, :739-745): the (H, W, 5) image.
    Where grad mode is on and a scene leaf requires grad, its backward is
    the manifold backward on sensor ``bwd_sensor_idx`` (the last one when
    negative) at ``bwd_spp`` samples a pixel, seeded ``seed``."""
    leaves = scene.leaves()
    names = tuple(k for k, v in leaves.items() if v.requires_grad)
    if torch.is_grad_enabled() and names:
        cfg = (seed, sensor_idx, spp, max_depth, rr_depth, caustic,
               bwd_sensor_idx, bwd_spp)
        return _RenderEPSM.apply(scene, cfg, names,
                                 *(leaves[k] for k in names))
    with torch.no_grad():
        return _primal(scene, seed, sensor_idx, spp, max_depth, rr_depth)


def render_backward(scene, names: Sequence[str], grad_in, seed,
                    max_depth: int, rr_depth: int, caustic: bool,
                    bwd_sensor_idx: int = -1, bwd_spp: int = 8
                    ) -> Dict[str, torch.Tensor]:
    """ManifoldIntegrator.render_backward (epsm.py:84-306): the gradient
    of sum(image * ``grad_in``) w.r.t. the scene leaves ``names``.

    Runs on the backward sensor (the reference hard-codes sensor 2 at
    128^2 and spp 8, epsm.py:142-145); falls back to the last sensor.
    Seeds the independent sampler whatever the scene names (:797)."""
    s_idx = bwd_sensor_idx if bwd_sensor_idx >= 0 else len(scene.sensors) - 1
    sensor = scene.sensors[s_idx]
    n = sensor.width * sensor.height * bwd_spp
    sampler = smp.seed(seed, n, device=scene.device)
    sampler, ray, weight, _ = common.sample_rays(sensor, sampler, bwd_spp)
    return backward_core(scene, names, grad_in, ray, sampler, 0, s_idx,
                         max_depth, rr_depth, caustic, bwd_spp, weight)


def first_hit_jvp(scene, ray: Ray, grad_d):
    """d(b0, b1, p) of the first hit along ``grad_d``, the tangent of the
    ray directions (epsm.py:263-274): five reverse passes, one an output
    component, each contracted with ``grad_d`` lane by lane.  Returns
    (db0 (N,), db1 (N,), dp (N, 3))."""
    with torch.no_grad():
        pi0 = scene.ray_intersect_preliminary(ray)
    d = ray.d.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        si = I.compute_surface_interaction(
            scene, Ray.make(ray.o.detach(), d), pi0, RayFlags.All)
        outs = [si.b0, si.b1, si.p[:, 0], si.p[:, 1], si.p[:, 2]]
        tangents = []
        for i, o in enumerate(outs):
            (g,) = torch.autograd.grad(o.sum(), d, retain_graph=i < 4)
            tangents.append(m.dot(g, grad_d))
    return tangents[0], tangents[1], torch.stack(tangents[2:], dim=-1)


def backward_core(scene, names: Sequence[str], grad_in, ray: Ray, sampler,
                  lane0: int, s_idx: int, max_depth: int, rr_depth: int,
                  caustic: bool, bwd_spp: int,
                  weight: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """The backward for the lanes from global lane ``lane0`` on
    (``backward_core``, :804-897)."""
    from ..ad import prb as prb_mod
    sensor = scene.sensors[s_idx]
    res_w, res_h = sensor.width, sensor.height
    n = ray.o.shape[0]
    scene_d = scene.with_leaves({k: v.detach()
                                 for k, v in scene.leaves().items()})

    # PASS 1: the logged primal (epsm.py:170-181)
    _, _, logs = sample_path_logged(scene_d, sampler, ray, max_depth,
                                    rr_depth)

    # position-channel grads -> ray-direction grads (epsm.py:249-257);
    # grad_in may come at the forward sensor's resolution: the reference
    # crops it to the backward film (epsm.py:240)
    g5 = grad_in[:res_h, :res_w, :]
    lane_pix = (lane0 + torch.arange(n, device=ray.o.device)) // bwd_spp
    g_lane = g5[lane_pix // res_w, lane_pix % res_w]            # (N, 5)
    gx, gy = g_lane[:, 3:4], g_lane[:, 4:5]
    grad_d = (ray.d_x - ray.d) * gx + (ray.d_y - ray.d) * gy

    # the derivative through the first intersection (epsm.py:263-274)
    db0, db1, dp = first_hit_jvp(scene_d, ray, grad_d)
    K = logs.b0.shape[0]
    dlduv1 = torch.zeros((n, 2 * K), dtype=torch.float32,
                         device=ray.o.device)
    dlduv1[:, 0] = db0
    dlduv1[:, 1] = db1

    # the per-lane camera vertex: right for sensors whose ray origins
    # differ per lane as well
    cam = ray.o.detach().contiguous()
    path_grad, light_grad, diffuse_grad = calc_grad(logs, dlduv1, dp, cam,
                                                    caustic)

    with torch.no_grad():
        acc = inject_gradients(scene_d, logs, path_grad, light_grad,
                               diffuse_grad,
                               {"vertices": torch.zeros_like(scene.vertices),
                                "normals": torch.zeros_like(scene.normals),
                                "alpha": torch.zeros_like(
                                    scene.bsdfs["alpha"])})
        out = {"vertices": acc["vertices"], "normals": acc["normals"],
               "bsdfs.alpha": acc["alpha"]}
        # the camera-origin gradient (epsm.py:260-261:
        # dr.backward(ray.o * -grad_d))
        tw = torch.zeros_like(sensor.to_world)
        tw[:3, 3] = -torch.sum(grad_d, dim=0)
        out[f"sensors.{s_idx}.to_world"] = tw

        # the colour-channel adjoint: a PRB replay with dL from the box
        # film's adjoint, whatever the sensor's filter (each lane reads
        # its own pixel, as the reference does, :820-827, :887), so
        # colour-dependent OT losses reach material and radiance
        # parameters beside the geometric manifold gradients (the
        # reference comments its ``dr.backward_from(δL * Lo)`` out,
        # epsm.py:733-738); the recording pass makes the replay traverse
        # nothing
        w_lane = weight if weight is not None else torch.ones_like(ray.o)
        dL = g_lane[:, :3] * w_lane / float(bwd_spp)
        L_total, _, trace = P.sample_primal_recorded(scene_d, sampler, ray,
                                                     max_depth, rr_depth)
    prb_grads = prb_mod.prb_backward(scene, names, sampler, ray, dL, L_total,
                                     max_depth, rr_depth, trace)
    leaves = scene.leaves()
    return {k: (out[k] if k in out else torch.zeros_like(leaves[k]))
            + prb_grads[k] for k in names}
