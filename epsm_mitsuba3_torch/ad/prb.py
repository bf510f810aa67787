"""Path Replay Backpropagation (counterpart of ``ad/prb.py``) as a
``torch.autograd.Function``.

Forward: the recording primal, one pass of the path tracer over a
wavefront of ``W * H * spp`` lanes that keeps each bounce's hits and
shadow visibilities (``path.sample_primal_recorded``).  Backward: the
film's adjoint turns the image cotangent into each lane's δL; the replay
re-runs the loop from the same sampler stream, reads the recorded trace
instead of traversing, and at every bounce takes one
``torch.autograd.grad`` of ``sum(Lo * δL)`` w.r.t. the scene's leaves,

    Lo = Le + Lr_dir + L_remaining * replace_grad(1, bsdf_val / bsdf_val)

(epsm.py:688-715, the denominator detached).  The replay is the fused form
(``_prb_backward_fused``): one bounce computes the attached contribution
and, from detached values, the next loop state, drawing from the sampler
in the primal's order (NEE 2-D, BSDF 1-D and 2-D, roulette 1-D).  No
graph spans two bounces.

Forward mode (``render_prb_forward``, JAX :551-711) is the replay's
transpose: one recording primal, then per bounce the JVP of the same Lo
(``_bounce_lo``) against the leaves' tangents, each bounce (or lane
chunk) in a ``torch.autograd.forward_ad`` dual level of its own.

``prb_reparam`` (``reparam=True``) replays the same objective with ray
reparameterisation (``ad/reparam.py``; JAX ``prb_backward`` :483-529):
each bounce's incident direction is warped and its contribution
multiplied by the warp's divergence (1 at the camera vertex), and the NEE
term by the divergence of a shadow ray from the receiving point; the
camera vertex's divergence enters through a re-projected film splat
(:802-850).  Each auxiliary ray set is a closest-hit query (K1 or K2).
That replay runs in lane chunks of ``REPARAM_CHUNK``: the objective is a
sum over lanes, each lane's part reading only its own state and sampler
streams, so the chunks' gradients add up to the whole's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import replace
from typing import Dict, Optional, Sequence

import torch
import torch.autograd.forward_ad as fwAD

from ..core import math as m
from ..integrators import common, path as P
from ..models import bsdf as B
from ..models import emitters as E
from ..models import films, samplers as smp
from ..models import sensors as S
from ..models.records import Ray, RayFlags
from ..ops import intersect as I
from .reparam import reparameterize_ray

#: lanes of one chunk of the reparameterised replay and camera term: the
#: graphs of a chunk's auxiliary rays are held at once, a few KiB a lane
#: at 16 rays a warp and two warps a bounce
REPARAM_CHUNK = 1 << 21
#: the seed stride of the auxiliary samplers (JAX ad/prb.py:496, :829)
_GOLDEN = 0x9E3779B9


def reparam_config(items=()) -> dict:
    """The reparameterisation's settings from ``render``'s items (the
    reference names mapped by ``ad/render.py`` ``_rp_items``): num_rays,
    kappa, exponent (defaults 16, 1e5, 3) and the diagnostic knobs
    ``_salt`` (added to the auxiliary seeds), ``_no_em_det``,
    ``_no_main_det`` and ``_no_cam`` (detach the NEE divergence, the
    bounce divergence, or drop the camera-vertex term).  An odd num_rays
    raises: the warps are antithetic."""
    cfg = dict(items)
    num_rays = int(cfg.get("num_rays", 16))
    if num_rays % 2:
        raise ValueError("antithetic reparameterization requires an even "
                         f"num_rays (got {num_rays})")
    return {"num_rays": num_rays,
            "kappa": float(cfg.get("kappa", 1e5)),
            "exponent": float(cfg.get("exponent", 3.0)),
            "salt": int(cfg.get("_salt", 0)),
            "no_em_det": bool(cfg.get("_no_em_det", 0)),
            "no_main_det": bool(cfg.get("_no_main_det", 0)),
            "no_cam": bool(cfg.get("_no_cam", 0))}


def split_scene(scene) -> Dict[str, torch.Tensor]:
    """The differentiable leaves by name (JAX ``split_scene``, :41-45):
    every float tensor of the scene state, named as ``scene_from_arrays``
    names them (``Scene.leaves``)."""
    return scene.leaves()


def merge_scene(leaves: Dict[str, torch.Tensor], scene):
    """``scene`` with the named leaves replaced (JAX ``merge_scene``,
    :48-50; ``Scene.with_leaves``)."""
    return scene.with_leaves(leaves)


def zero_tangent(scene) -> Dict[str, torch.Tensor]:
    """A zero tangent for every float leaf (JAX ``zero_tangent``, :71-77):
    set the leaf to differentiate to the perturbation's direction and hand
    the mapping to ``render_forward``."""
    return {k: torch.zeros_like(v.detach())
            for k, v in split_scene(scene).items()}


def zero_cotangent(scene) -> Dict[str, torch.Tensor]:
    """A zero cotangent for every float leaf (JAX ``zero_cotangent``,
    :80-86): the same mapping as ``zero_tangent``, since the port's
    cotangents are named leaves too."""
    return zero_tangent(scene)


def scene_tangents(scene, d_scene) -> Dict[str, torch.Tensor]:
    """A tangent for every float leaf (JAX ``scene_tangents``, :53-68):
    ``d_scene``'s entry of the leaf's name, cast to the leaf's type and
    shape, zeros where ``d_scene`` (a mapping, or None) has none.  A name
    that is no float leaf raises."""
    leaves = split_scene(scene)
    d_scene = dict(d_scene or {})
    unknown = sorted(set(d_scene) - set(leaves))
    if unknown:
        raise KeyError(f"tangents of {unknown}: no float leaf has that "
                       f"name (the leaves: {sorted(leaves)})")
    out = {}
    for k, v in leaves.items():
        t = d_scene.get(k)
        out[k] = (torch.zeros_like(v.detach()) if t is None else
                  torch.as_tensor(t, dtype=v.dtype,
                                  device=v.device).reshape(v.shape))
    return out


def _warp(sc, rp: dict, seed_value: int, ray: Ray, active, lane0: int):
    """``reparameterize_ray`` (antithetic, as the reference's integrator
    calls it) of the rays of lanes [lane0, lane0 + N), drawing from those
    lanes of the auxiliary stream seeded ``seed_value`` (an independent
    sampler): (d, det)."""
    rs = smp.seed(seed_value & smp.M32, ray.o.shape[0], lane_offset=lane0,
                  device=ray.o.device)
    _, d, det = reparameterize_ray(
        sc, rs, ray, active, num_rays=rp["num_rays"], kappa=rp["kappa"],
        exponent=rp["exponent"])
    return d, det


def _rows(x, a: int, b: int):
    """Lanes [a, b) of a record: every tensor field sliced on dim 0."""
    if isinstance(x, torch.Tensor):
        return x[a:b]
    if isinstance(x, dict):
        return {k: _rows(v, a, b) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return replace(x, **{f.name: _rows(getattr(x, f.name), a, b)
                             for f in dataclasses.fields(x)})
    return x


def _cat(parts):
    """The inverse of ``_rows``: records of consecutive lanes joined."""
    x = parts[0]
    if isinstance(x, torch.Tensor):
        return torch.cat(parts)
    if dataclasses.is_dataclass(x):
        return replace(x, **{f.name: _cat([getattr(p, f.name)
                                           for p in parts])
                             for f in dataclasses.fields(x)})
    return x


def _film_fn(values, pos, weight, sensor, spp):
    """The film of the pixel-major lanes (``_film_fn``, :93-101): the box
    filter's per-pixel mean, or any other filter's scatter-free splat of
    the samples at ``pos`` developed by a detached weight channel."""
    value = values * weight
    if sensor.rfilter == "box":
        return films.accumulate_coalesced(value, sensor.width,
                                          sensor.height, spp)
    jitter = pos - torch.floor(pos)
    data, w = films.splat_coalesced(jitter, value, sensor.width,
                                    sensor.height, spp, sensor.rfilter)
    return films.develop(data, w.detach())


def film_adjoint(g_img, pos, weight, sensor, spp: int,
                 n: int) -> torch.Tensor:
    """Per-lane adjoint radiance δL (n, 3) of the image cotangent
    ``g_img`` (``film_adjoint``, :104-108), by ``torch.autograd.grad``
    through the film."""
    with torch.enable_grad():
        values = torch.zeros((n, 3), dtype=g_img.dtype,
                             device=g_img.device, requires_grad=True)
        img = _film_fn(values, pos, weight, sensor, spp)
        (dL,) = torch.autograd.grad(img, values, g_img)
    return dL


def attached_emitter_weight(sc, ds, d_att, em_weight_att):
    """The attached weight of an NEE sample ``ds`` toward the attached
    direction ``d_att`` (JAX ad/prb.py:168-177): the area kinds'
    ``eval_hit`` at the attached emitter point over the detached pdf;
    every other kind's is ``sample_direction``'s weight
    ``em_weight_att``, attached to its intensity, irradiance, radiance and
    the envmap's texels.  A scene of area lights alone skips the select,
    whose other branch's backward would cost it as much as its own."""
    em_val = E.eval_hit(sc.emitters, ds.emitter_index,
                        m.dot(-d_att, ds.n),
                        kinds_present=sc.static.emitter_kinds)
    pdf_d = ds.pdf.detach()
    em_weight = torch.where(
        (pdf_d > 0.0)[..., None],
        em_val / torch.clamp(pdf_d, min=1e-20)[..., None], 0.0)
    area_kinds = (E.KIND_AREA, E.KIND_DIRECTIONALAREA)
    if any(k not in area_kinds for k in sc.static.emitter_kinds):
        kind = sc.emitters["kind"][torch.clamp(ds.emitter_index,
                                               min=0).long()]
        is_area = (kind == area_kinds[0]) | (kind == area_kinds[1])
        em_weight = torch.where(is_area[..., None], em_weight,
                                em_weight_att)
    return em_weight


def _bounce_lo(sc, st: P.LoopState, cached: dict, max_depth: int,
               rr_depth: int, rp: Optional[dict] = None, bounce: int = 0,
               lane0: int = 0):
    """One bounce of the fused replay: (the next detached state, the
    attached local contribution Lo (N, 3)).  Lo carries the derivative of
    the scene ``sc``'s leaves, as a graph for ``_replay_bounce`` or as
    forward-mode tangents for ``_forward_bounce``.  With ``rp``
    (``reparam_config``) the bounce ``bounce`` of lanes [lane0, lane0 +
    N) is replayed reparameterised (JAX ad/prb.py:483-529, the ``rp_em``
    term of ``_local_contrib``)."""
    det = None
    st_hit = st
    if rp is not None:
        # the incident direction, warped and attached: the recorded
        # hit is evaluated along it
        d_in, det = _warp(sc, rp, bounce * _GOLDEN + 17 + rp["salt"],
                          Ray.make(st.ray_o, st.ray_d), st.active, lane0)
        st_hit = replace(st, ray_d=d_in)
        if bounce == 0:
            # the camera vertex's divergence belongs to the film
            # integral (``_camera_term``)
            det = None
        elif rp["no_main_det"]:
            det = det.detach()
    # the primal's hit stage, on the recorded hit: no traversal
    _, si, le, active_next, active_em = P.hit_stage(sc, st_hit, max_depth,
                                                    cached=cached)

    # NEE, attached: the emitter point and the receiving point carry
    # the gradient; pdfs and the recorded visibility are detached
    sampler, s2 = smp.next_2d(st.sampler)
    ds, em_weight_att = E.sample_direction(
        sc.emitters, sc.static.emitter_kinds, si.p.detach(), s2,
        sc.vertices, sc.faces, sc.em_faces, sc.textures,
        sc.static.env_texture)
    active_em = active_em & (ds.pdf != 0.0)
    d_att = m.normalize(ds.p - si.p)
    pdf_d = ds.pdf.detach()
    em_weight = torch.where((active_em & ~cached["occl"])[..., None],
                            attached_emitter_weight(sc, ds, d_att,
                                                    em_weight_att), 0.0)
    wo_em = si.to_local(d_att.detach())
    textures = sc.bsdf_textures()
    bsdf_val_em, bsdf_pdf_em = B.eval_pdf(
        sc.bsdfs, sc.static.bsdf_kinds, si.bsdf_index, si.wi, wo_em,
        active_em, uv=si.uv, textures=textures, vcolor=si.vcolor)
    mis_em = torch.where(ds.delta, 1.0,
                         common.mis_weight(pdf_d, bsdf_pdf_em))
    lr_dir = st.beta * mis_em[..., None] * bsdf_val_em * em_weight
    if rp is not None and not rp["no_em_det"] and bounce + 1 < max_depth:
        # the divergence of the shadow ray's warp toward the detached
        # emitter point, from the receiving point following its shape;
        # after the last bounce no lane samples an emitter
        si_f = I.compute_surface_interaction(
            sc, Ray.make(st_hit.ray_o, st_hit.ray_d), cached["pi"],
            RayFlags.All | RayFlags.FollowShape)
        em_ray = Ray.make(si_f.p, m.normalize(ds.p.detach() - si_f.p))
        _, det_em = _warp(sc, rp, bounce * _GOLDEN + 29 + rp["salt"],
                          em_ray, active_em, lane0)
        lr_dir = lr_dir * det_em[..., None]

    # the state advance, detached: bitwise the primal bounce's
    si_d = si.detach()
    bsdfs_d = {k: v.detach() for k, v in sc.bsdfs.items()}
    st2, wo_world = P.advance(st, si_d, sampler, bsdfs_d,
                              sc.static.bsdf_kinds, active_next,
                              rr_depth, {i: t.detach()
                                         for i, t in textures.items()})

    # indirect: the detached BSDF weight cancelled and re-attached
    L_remaining = (st.L - le - lr_dir).detach()
    bsdf_val, _ = B.eval_pdf(
        sc.bsdfs, sc.static.bsdf_kinds, si.bsdf_index, si.wi,
        si.to_local(wo_world), active_next, uv=si.uv, textures=textures,
        vcolor=si.vcolor)
    val_d = bsdf_val.detach()
    # a subnormal value counts as 0, as on the reference's devices, which
    # flush subnormals (XLA): its reciprocal would overflow, and its lane's
    # zero cotangent turn NaN (a measured table's grazing entries)
    nz = torch.abs(val_d) >= torch.finfo(val_d.dtype).tiny
    inv_det = torch.where(nz, 1.0, 0.0) / torch.where(nz, val_d, 1.0)
    lr_ind = L_remaining * I.replace_grad(torch.ones_like(bsdf_val),
                                          inv_det * bsdf_val)
    lo = le + lr_dir + lr_ind
    if det is not None:
        lo = lo * det[..., None]
    return replace(st2, L=L_remaining), lo


def _replay_bounce(sc, leaves: Sequence[torch.Tensor], st: P.LoopState,
                   cached: dict, dL, max_depth: int, rr_depth: int,
                   rp: Optional[dict] = None, bounce: int = 0,
                   lane0: int = 0):
    """One bounce of the fused replay: (the next detached state, the
    gradient of sum(Lo * dL) w.r.t. each of ``leaves``, None where it
    does not reach one)."""
    with torch.enable_grad():
        st2, lo = _bounce_lo(sc, st, cached, max_depth, rr_depth, rp,
                             bounce, lane0)
        obj = torch.sum(lo * dL)
        grads = (torch.autograd.grad(obj, leaves, allow_unused=True)
                 if obj.requires_grad else (None,) * len(leaves))
    return st2, grads


def _attached(scene, names: Sequence[str]):
    """The scene with its leaves ``names`` replaced by detached copies
    that require grad, and those copies in order."""
    all_leaves = scene.leaves()
    leaves = {k: all_leaves[k].detach().requires_grad_(True) for k in names}
    return scene.with_leaves(leaves), list(leaves.values())


def _add(grads: Dict[str, torch.Tensor], names, g) -> None:
    for k, gk in zip(names, g):
        if gk is not None:
            grads[k] += gk


def prb_backward(scene, names: Sequence[str], sampler, ray: Ray, dL,
                 L_total, max_depth: int, rr_depth: int,
                 trace: dict, rp: Optional[dict] = None
                 ) -> Dict[str, torch.Tensor]:
    """The replay: the gradient of sum(image * cotangent) w.r.t. the
    scene's leaves ``names``, accumulated over the bounces.  ``trace`` is
    the recording primal's; the replay traverses nothing.  With ``rp``
    (``reparam_config``) each bounce is replayed reparameterised, in lane
    chunks of ``REPARAM_CHUNK``; its auxiliary rays are the only queries
    of the replay."""
    sc, order = _attached(scene, names)
    grads = {k: torch.zeros_like(v) for k, v in zip(names, order)}
    n = ray.o.shape[0]
    st = P.init_state(sampler, ray, n)
    st = replace(st, L=L_total)
    for i in range(max_depth):
        cached = P.trace_at(trace, i)
        if rp is None:
            st, g = _replay_bounce(sc, order, st, cached, dL, max_depth,
                                   rr_depth)
            _add(grads, names, g)
            continue
        parts = []
        for a in range(0, n, REPARAM_CHUNK):
            b = min(n, a + REPARAM_CHUNK)
            st_c, g = _replay_bounce(sc, order, _rows(st, a, b),
                                     _rows(cached, a, b), dL[a:b],
                                     max_depth, rr_depth, rp, i, a)
            parts.append(st_c)
            _add(grads, names, g)
        st = _cat(parts)
    return grads


def _camera_splat(sc, rp: dict, seed: int, sensor_idx: int, spp: int,
                  value, pos, a: int, b: int):
    """The camera vertex's attached splat of lanes [a, b) (JAX
    ad/prb.py:802-850): the camera rays re-sampled from the same stream
    through the scene ``sc``'s sensor, warped (auxiliary seed ``seed *
    0x9E3779B9 + 23`` at lane offset ``a``), re-projected
    (``point_to_film(sensor, o + d)``, the detached ``pos`` where the kind
    has none) and splatted with the divergence as an extra filter weight,
    through a gaussian where the sensor's filter is the box.  Returns
    (data (H, W, 3), weight (H, W))."""
    sensor = sc.sensors[sensor_idx]
    device = sc.device
    smp_c = smp.seed(seed, b - a, kind=sc.static.sampler_kind, spp=spp,
                     lane_offset=a, device=device)
    _, ray_c, _, _ = common.sample_rays(sensor, smp_c, spp, lane_offset=a)
    ones = torch.ones(b - a, dtype=torch.bool, device=device)
    d0, det0 = _warp(sc, rp, seed * _GOLDEN + 23, ray_c, ones, a)
    pos_c = S.point_to_film(sensor, ray_c.o + d0)
    if pos_c is None:
        pos_c = pos[a:b]
    rfilter = "gaussian" if sensor.rfilter == "box" else sensor.rfilter
    return films.splat(pos_c, value[a:b], sensor.width, sensor.height,
                       rfilter, extra_weight=det0)


def _camera_term(scene, names: Sequence[str], seed: int, sensor_idx: int,
                 spp: int, L_total, g_img, rp: dict
                 ) -> Dict[str, torch.Tensor]:
    """The camera vertex's reparameterisation at the film (JAX
    ad/prb.py:802-850): the gradient of sum(develop(splat) * g_img)
    w.r.t. the leaves ``names``, the splat ``_camera_splat``'s.

    The developed film divides two sums over all lanes, so the chunks of
    ``REPARAM_CHUNK`` lanes each take the gradient of its first-order
    part at the whole film's values: sum(g / w * data_c) - sum(g . data /
    w^2 * w_c), the chain rule through ``films.develop``."""
    sc, order = _attached(scene, names)
    grads = {k: torch.zeros_like(v) for k, v in zip(names, order)}
    sensor, n, _, ray, weight, pos = common.camera(scene, seed, sensor_idx,
                                                   spp)
    W, H = sensor.width, sensor.height
    rfilter = "gaussian" if sensor.rfilter == "box" else sensor.rfilter
    value = (L_total * weight).detach()
    with torch.no_grad():
        pos_p = S.point_to_film(sensor, ray.o + ray.d)
        if pos_p is None:
            pos_p = pos
        coefs = develop_coefs(*films.splat(pos_p, value, W, H, rfilter),
                              g_img)
    for a in range(0, n, REPARAM_CHUNK):
        b = min(n, a + REPARAM_CHUNK)
        with torch.enable_grad():
            obj = develop_objective(coefs, *_camera_splat(
                sc, rp, seed, sensor_idx, spp, value, pos, a, b))
            if obj.requires_grad:
                _add(grads, names, torch.autograd.grad(obj, order,
                                                       allow_unused=True))
    return grads


def develop_coefs(data, w, g_img):
    """The chain rule through ``films.develop(data, w)`` at the whole
    film's ``data`` and ``w`` for the image cotangent ``g_img``: (g / w,
    g . data / w^2), zero where the weight is."""
    w_pos = w > 0.0
    w1 = torch.where(w_pos, w, 1.0)
    return (g_img / w1[..., None],
            torch.where(w_pos, torch.sum(g_img * data, -1) / (w1 * w1), 0.0))


def develop_objective(coefs, data_c, w_c):
    """The first-order part of sum(develop(data, w) * g) that one lane
    chunk's attached splat (data_c, w_c) contributes, at the whole film's
    values (``develop_coefs``): the chunks' gradients add up to the
    whole's."""
    coef_data, coef_w = coefs
    return torch.sum(coef_data * data_c) - torch.sum(coef_w * w_c)


# -- forward mode (JAX ad/prb.py:551-711) -------------------------------------

def _tangent(x: torch.Tensor) -> torch.Tensor:
    """The forward-mode tangent of ``x``, zeros where it carries none."""
    primal, tangent = fwAD.unpack_dual(x)
    return torch.zeros_like(primal) if tangent is None else tangent


def _dual(scene, tangents: Dict[str, torch.Tensor]):
    """Inside a dual level: the scene with each leaf that ``tangents``
    names made a dual tensor of its detached value and that tangent."""
    leaves = scene.leaves()
    return scene.with_leaves({k: fwAD.make_dual(leaves[k].detach(), t)
                              for k, t in tangents.items()})


def _forward_bounce(scene, tangents, st: P.LoopState, cached: dict,
                    max_depth: int, rr_depth: int, rp: Optional[dict] = None,
                    bounce: int = 0, lane0: int = 0):
    """The JVP of one bounce's Lo (``_bounce_lo``), in a dual level of its
    own: (the next detached state, dLo (N, 3))."""
    with torch.no_grad(), fwAD.dual_level():
        st2, lo = _bounce_lo(_dual(scene, tangents), st, cached, max_depth,
                             rr_depth, rp, bounce, lane0)
        return st2, _tangent(lo)


def prb_forward(scene, tangents: Dict[str, torch.Tensor], sampler, ray: Ray,
                L_total, max_depth: int, rr_depth: int, trace: dict,
                rp: Optional[dict] = None) -> torch.Tensor:
    """Forward-mode PRB (JAX ``prb_forward``, :551-624), the transpose of
    ``prb_backward``: per bounce, the JVP of the same Lo against the
    leaves' ``tangents`` (name -> tensor), summed a lane.  Returns the
    per-lane radiance tangent (n, 3).  It traverses nothing but ``rp``'s
    auxiliary rays, in lane chunks of ``REPARAM_CHUNK`` with the
    backward's seeds and lane offsets."""
    n = ray.o.shape[0]
    st = replace(P.init_state(sampler, ray, n), L=L_total)
    dvals = torch.zeros((n, 3), dtype=ray.o.dtype, device=ray.o.device)
    step = n if rp is None else REPARAM_CHUNK
    for i in range(max_depth):
        cached = P.trace_at(trace, i)
        parts = []
        for a in range(0, n, step):
            b = min(n, a + step)
            st_c, dlo = _forward_bounce(scene, tangents, _rows(st, a, b),
                                        _rows(cached, a, b), max_depth,
                                        rr_depth, rp, i, a)
            dvals[a:b] += dlo
            parts.append(st_c)
        st = _cat(parts)
    return dvals


def _camera_forward(scene, tangents, seed: int, sensor_idx: int, spp: int,
                    value, pos, rp: dict) -> torch.Tensor:
    """The JVP of the camera vertex's film term (JAX ad/prb.py:677-710),
    the forward form of ``_camera_term``: the lane chunks' attached splats
    (``_camera_splat``) summed and developed in one dual level."""
    n = value.shape[0]
    with torch.no_grad(), fwAD.dual_level():
        sc = _dual(scene, tangents)
        data = w = 0.0
        for a in range(0, n, REPARAM_CHUNK):
            data_c, w_c = _camera_splat(sc, rp, seed, sensor_idx, spp, value,
                                        pos, a, min(n, a + REPARAM_CHUNK))
            data, w = data + data_c, w + w_c
        return _tangent(films.develop(data, w))


def render_prb_forward(scene, d_scene=None, seed: int = 0,
                       sensor_idx: int = 0, spp: int = 16,
                       max_depth: int = 6, rr_depth: int = 5,
                       multi_pop: Optional[int] = None,
                       reparam: bool = False, rp_items=()) -> torch.Tensor:
    """The image tangent d(image)/dθ · θ̇ of one pass (JAX
    ``render_prb_forward``, :653-711) for the leaves' tangents ``d_scene``
    (a mapping of ``zero_tangent``'s names to tensors; a missing name or
    None: zeros).  The recording primal, the replay's JVP pushed through
    the film with detached positions and weights, and under ``reparam``
    (without ``_no_cam``) the camera vertex's term."""
    rp = reparam_config(rp_items) if reparam else None
    full = scene_tangents(scene, d_scene)
    tangents = {k: full[k] for k, t in dict(d_scene or {}).items()
                if t is not None}
    with torch.no_grad():
        sensor, _, sampler, ray, weight, pos = common.camera(scene, seed,
                                                       sensor_idx, spp)
        L, _, trace = P.sample_primal_recorded(scene, sampler, ray,
                                               max_depth, rr_depth,
                                               multi_pop)
    dvals = prb_forward(scene, tangents, sampler, ray, L, max_depth,
                        rr_depth, trace, rp)
    with torch.no_grad():
        dimg = _film_fn(dvals, pos, weight, sensor, spp)
    if rp is not None and not rp["no_cam"]:
        dimg = dimg + _camera_forward(scene, tangents, seed, sensor_idx,
                                      spp, (L * weight).detach(), pos, rp)
    return dimg


class _RenderPRB(torch.autograd.Function):
    """``_make_render``'s custom_vjp (:763-858): the inputs are the scene
    leaves that require grad, and the backward hands back one gradient for
    each."""

    @staticmethod
    def forward(ctx, scene, cfg, names, *leaves):
        seed, sensor_idx, spp, max_depth, rr_depth, multi_pop, _ = cfg
        sensor, _, sampler, ray, weight, pos = common.camera(scene, seed,
                                                       sensor_idx, spp)
        L, _, trace = P.sample_primal_recorded(scene, sampler, ray,
                                               max_depth, rr_depth,
                                               multi_pop)
        ctx.scene, ctx.cfg, ctx.names = scene, cfg, names
        ctx.L, ctx.trace = L, trace
        return _film_fn(L, pos, weight, sensor, spp)

    @staticmethod
    def backward(ctx, g_img):
        seed, sensor_idx, spp, max_depth, rr_depth, _, rp = ctx.cfg
        scene = ctx.scene
        sensor, n, sampler, ray, weight, pos = common.camera(scene, seed,
                                                       sensor_idx, spp)
        g_img = g_img.contiguous()
        dL = film_adjoint(g_img, pos, weight, sensor, spp, n)
        grads = prb_backward(scene, ctx.names, sampler, ray, dL, ctx.L,
                             max_depth, rr_depth, ctx.trace, rp)
        ctx.trace = None
        if rp is not None and not rp["no_cam"]:
            g_cam = _camera_term(scene, ctx.names, seed, sensor_idx, spp,
                                 ctx.L, g_img, rp)
            for k in ctx.names:
                grads[k] += g_cam[k]
        ctx.L = None
        return (None, None, None, *(grads[k] for k in ctx.names))


def render_prb(scene, seed: int = 0, sensor_idx: int = 0, spp: int = 16,
               max_depth: int = 6, rr_depth: int = 5,
               multi_pop: Optional[int] = None, reparam: bool = False,
               execution: str = "megakernel",
               compact_chunks: int = 0, rp_items=()) -> torch.Tensor:
    """One pass (``render_prb``): the (H, W, 3) image.  Where grad mode is
    on and a scene leaf requires grad, the pass records its trace and is
    differentiable through the replay; otherwise it is the detached
    primal.  ``multi_pop``: the BVH closest hit's schedule (K2 or K4;
    ``None`` leaves it to ``cuda_traverse.closest_hit``).  ``reparam``:
    the ``prb_reparam`` backward, with the settings ``rp_items``
    (``reparam_config``); its primal is the same."""
    rp = reparam_config(rp_items) if reparam else None
    if execution != "megakernel":
        raise NotImplementedError(
            f"execution '{execution}': the port runs the megakernel "
            "(masked full-width) loop only")
    if compact_chunks:
        raise NotImplementedError(
            "dead-lane compaction comes with a later slice of the port")
    leaves = scene.leaves()
    names = tuple(k for k, v in leaves.items() if v.requires_grad)
    if torch.is_grad_enabled() and names:
        cfg = (seed, sensor_idx, spp, max_depth, rr_depth, multi_pop, rp)
        return _RenderPRB.apply(scene, cfg, names,
                                *(leaves[k] for k in names))
    with torch.no_grad():
        sensor, _, sampler, ray, weight, pos = common.camera(scene, seed,
                                                       sensor_idx, spp)
        L, _ = P.sample_primal(scene, sampler, ray, max_depth, rr_depth,
                               multi_pop)
        return _film_fn(L, pos, weight, sensor, spp)
