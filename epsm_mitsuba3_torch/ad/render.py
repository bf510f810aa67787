"""The differentiable ``render`` entry point (counterpart of
``ad/render.py``): every float tensor of the scene that requires grad
receives its gradient through ``torch.autograd``:

- PRB (``ad/prb.py``) for ``path``, ``prb`` and ``prb_basic``,
  reparameterised PRB (``ad/reparam.py``) for ``prb_reparam``;
- the EPSM manifold backward (``integrators/epsm.py``) for ``manifold``
  and ``manifold_caustic``;
- the attached reparameterised estimators (``ad/direct_reparam.py``) for
  ``direct_reparam`` and ``emission_reparam``;
- plain autograd through the surface interaction for ``depth`` and the
  geometric and albedo channels of ``aov`` (``integrators/aov.py``);
- zero, as the reference detaches its scene, for ``direct``
  (``integrators/direct.py``), ``moment``, ``ptracer``
  (``integrators/ptracer.py``), ``spectral``, ``spectral_mono`` and
  ``spectral_spec`` (``integrators/spectral.py``) and ``stokes``
  (``integrators/polarized.py``).

A type given to ``register_integrator`` is looked up first.
``render_forward`` is forward mode for the PRB family."""
from __future__ import annotations

from typing import Optional

import torch

from ..core.device import resolve_device
from ..models.films import kahan_add
from ..integrators import aov, direct, epsm, polarized, ptracer
from ..integrators import spectral as spectral_mod
from ..ops import cuda_traverse as CT
from . import direct_reparam, prb

#: integrator types the port renders with the path tracer: the reference
#: runs the same tracer and PRB replay for all of them (``prb_basic`` is
#: its alias of ``prb``, JAX ad/render.py:163), reparameterised for
#: ``prb_reparam``
_PATH_TYPES = ("path", "prb", "prb_basic", "prb_reparam")
#: the EPSM integrators: a 5-channel image (the last two zero) whose
#: backward is the manifold solve
_EPSM_TYPES = ("manifold", "manifold_caustic")
#: the direct-illumination family: ``direct`` (detached) and its two
#: reparameterised, differentiable forms
_DIRECT_TYPES = ("direct", "direct_reparam", "emission_reparam")
#: the other outputs: the depth, the AOV image, the moments, the particle
#: tracer, the Stokes vectors and the spectral developments
_OUTPUT_TYPES = ("depth", "aov", "moment", "ptracer", "stokes") + tuple(
    spectral_mod.MODES)
#: every type ``render`` runs without a registered integrator
TYPES = _PATH_TYPES + _EPSM_TYPES + _DIRECT_TYPES + _OUTPUT_TYPES

#: integrators given to ``register_integrator``: name -> callable
_CUSTOM_INTEGRATORS = {}


def register_integrator(name: str, fn) -> None:
    """mi.register_integrator (JAX ad/render.py:21-31): ``render`` with an
    integrator of type ``name`` calls ``fn(scene, seed=..., spp=...,
    sensor_idx=..., cfg=dict)``, which returns the (H, W, C) image; the
    registered name is looked up before the built-in types, and
    ``spp_chunk`` does not split its calls."""
    _CUSTOM_INTEGRATORS[name] = fn


#: the reparameterisation's settings under the reference's names and the
#: short ones (prb_reparam.py:233-250)
_RP_ALIAS = {"reparam_rays": "num_rays", "reparam_kappa": "kappa",
             "reparam_exp": "exponent", "num_rays": "num_rays",
             "kappa": "kappa", "exponent": "exponent"}
#: diagnostic knobs that isolate a gradient channel or salt the auxiliary
#: streams (``ad/prb.py`` ``reparam_config``)
_RP_KNOBS = ("_salt", "_no_em_det", "_no_main_det", "_no_cam")


def _rp_items(cfg: dict):
    """The reparameterisation's settings of an integrator dict as a sorted
    tuple of (name, float) (``_rp_items``, JAX ad/render.py:34-50)."""
    out = {k: float(v) for k, v in cfg.items() if k in _RP_KNOBS}
    out.update({_RP_ALIAS[k]: float(v) for k, v in cfg.items()
                if k in _RP_ALIAS})
    return tuple(sorted(out.items()))


def _integrator_cfg(scene, integrator: Optional[dict]):
    cfg = dict(scene.static.integrator)
    if integrator:
        cfg.update(integrator)
    cfg.setdefault("type", "path")
    cfg.setdefault("max_depth", 6)
    cfg.setdefault("rr_depth", 5)
    cfg.setdefault("multi_pop", None)
    return cfg


def _aov_names(cfg: dict):
    """The channels of an ``aov`` integrator's ``aovs`` string of
    ``label:name`` pairs (JAX ad/render.py:199-203); without a ``:`` in
    it, ``aov.DEFAULT_AOVS``."""
    if ":" not in str(cfg.get("aovs", "")):
        return aov.DEFAULT_AOVS
    return tuple(a.split(":")[1].strip() for a in
                 str(cfg.get("aovs", "depth:depth,sh_normal:sh_normal")
                     ).split(","))


def render(scene, seed: int = 0, spp: int = 0, sensor: int = 0,
           integrator: Optional[dict] = None, spp_chunk: int = 0,
           device=None) -> torch.Tensor:
    """mi.render: the (H, W, C) image of ``scene``, differentiable w.r.t.
    the scene's float tensors that require grad.  C is 3 but for the
    EPSM integrators (5), ``aov`` (3 + its channels: 13 by default),
    ``moment`` (6: the mean and the second moment), ``stokes`` (15: the
    RGB image, then S0, S1, S2 and S3 in RGB), ``spectral_mono``
    (1) and ``spectral_spec`` (``n_bins``, default 16).  ``direct``,
    ``direct_reparam`` and ``emission_reparam`` read
    ``integrator["emitter_samples"]`` and ``["bsdf_samples"]`` (default 1
    each); the reparameterised types the settings of ``_rp_items``;
    ``aov`` its ``aovs`` string (``_aov_names``); the spectral types
    ``wavelengths`` (4) and ``n_bins`` (16).  Each type's depth is
    ``max_depth``, 6 where neither the scene nor the call sets it: the
    reference's own defaults for ``aov`` (2), ``moment`` and ``stokes``
    (4) are read after that 6 is set, so never apply (kept as they
    are).

    ``spp_chunk``: render in passes of at most this many samples per pixel
    and average them with Kahan-compensated sums, through which the
    gradient flows; pass p is seeded ``seed * n_passes + p``
    (integrator.cpp:201-219); each pass of an EPSM integrator runs its
    own backward, seeded as its forward.  ``integrator["multi_pop"]``: the BVH
    closest hit's schedule, 0 or 1 for K2, 2 or 4 for K4 (absent:
    ``cuda_traverse.MULTI_POP``, read by ``closest_hit``).
    ``device=None`` means the GPU and raises without CUDA; the scene must
    live on the device the call names.  On a
    BVH scene on the GPU the render waits for the device at its end and
    raises ``StackOverflow`` if a ray ran out of traversal stack; an EPSM
    backward checks once more after it has run."""
    device = resolve_device(device)
    if scene.device != device:
        raise ValueError(f"scene is on {scene.device}, render was asked "
                         f"to run on {device}")
    cfg = _integrator_cfg(scene, integrator)
    kind = cfg["type"]
    if spp == 0:
        spp = scene.static.spp
    if kind in _CUSTOM_INTEGRATORS:
        return _CUSTOM_INTEGRATORS[kind](scene, seed=seed, spp=spp,
                                         sensor_idx=sensor, cfg=cfg)
    if kind not in TYPES:
        raise NotImplementedError(f"integrator '{kind}' is not ported")

    multi_pop = cfg["multi_pop"]
    samples = (int(cfg.get("emitter_samples", 1)),
               int(cfg.get("bsdf_samples", 1)))

    def one_pass(pass_seed, pass_spp):
        if kind == "depth":
            return aov.render_depth(scene, pass_seed, sensor, pass_spp)
        if kind == "aov":
            return aov.render_aov(scene, pass_seed, sensor, pass_spp,
                                  aovs=_aov_names(cfg),
                                  max_depth=int(cfg.get("max_depth", 2)))
        if kind == "moment":
            return aov.render_moment(scene, pass_seed, sensor, pass_spp,
                                     max_depth=int(cfg.get("max_depth", 4)))
        if kind == "stokes":
            return polarized.render_stokes(
                scene, pass_seed, sensor, pass_spp,
                max_depth=int(cfg.get("max_depth", 4)))
        if kind == "ptracer":
            return ptracer.render_ptracer(
                scene, pass_seed, sensor, pass_spp,
                max_depth=int(cfg.get("max_depth", 6)))
        if kind in spectral_mod.MODES:
            return spectral_mod.render_spectral(
                scene, pass_seed, sensor, pass_spp,
                max_depth=int(cfg.get("max_depth", 6)),
                rr_depth=int(cfg.get("rr_depth", 5)),
                k=int(cfg.get("wavelengths", 4)),
                mode=spectral_mod.MODES[kind],
                n_bins=int(cfg.get("n_bins", 16)))
        if kind == "direct":
            return direct.render_direct(scene, pass_seed, sensor, pass_spp,
                                        *samples)
        if kind == "direct_reparam":
            return direct_reparam.render_direct_reparam(
                scene, pass_seed, sensor, pass_spp, *samples,
                rp_items=_rp_items(cfg))
        if kind == "emission_reparam":
            return direct_reparam.render_emission_reparam(
                scene, pass_seed, sensor, pass_spp, rp_items=_rp_items(cfg))
        if kind in _EPSM_TYPES:
            return epsm.render_epsm(
                scene, seed=pass_seed, sensor_idx=sensor, spp=pass_spp,
                max_depth=int(cfg["max_depth"]),
                rr_depth=int(cfg["rr_depth"]),
                caustic=kind == "manifold_caustic")
        return prb.render_prb(
            scene, seed=pass_seed, sensor_idx=sensor, spp=pass_spp,
            max_depth=int(cfg["max_depth"]), rr_depth=int(cfg["rr_depth"]),
            multi_pop=None if multi_pop is None else int(multi_pop),
            reparam=kind == "prb_reparam",
            rp_items=_rp_items(cfg))

    if spp_chunk and spp > spp_chunk:
        n_passes = -(-spp // spp_chunk)
        acc = comp = None
        for p in range(n_passes):
            img = one_pass(seed * n_passes + p, spp_chunk)
            if acc is None:
                acc, comp = img, torch.zeros_like(img)
            else:
                acc, comp = kahan_add(acc, comp, img)
        img = acc / n_passes
    else:
        img = one_pass(seed, spp)
    if scene.bvh is not None and device.type == "cuda":
        # a ray that ran out of traversal stack lost hits: raise, once a
        # render and after its recording forward, rather than return a
        # wrong image (waits for the device)
        CT.raise_on_overflow(device)
    return img


def render_forward(scene, d_scene=None, seed: int = 0, spp: int = 0,
                   sensor: int = 0, integrator: Optional[dict] = None,
                   device=None) -> torch.Tensor:
    """mi.render_forward (JAX ad/render.py:82-120): the (H, W, 3) image
    tangent d(render)/dθ · θ̇ for the tangents ``d_scene`` of the scene's
    float leaves, a mapping from a leaf's name (``Scene.leaves``, e.g.
    ``vertices``, ``bsdfs.reflectance``, ``emitters.radiance``,
    ``sensors.0.to_world``; ``ad.prb.zero_tangent`` gives them all) to its
    direction; a leaf it does not name, or ``d_scene=None``, has tangent
    zero.  Supported for the PRB family (``path``, ``prb``, ``prb_basic``,
    ``prb_reparam``): the same estimator as ``render``'s backward,
    transposed, on the same sampler streams (``ad/prb.py``
    ``render_prb_forward``); any other type raises
    ``NotImplementedError``.  ``device=None`` means the GPU and raises
    without CUDA."""
    device = resolve_device(device)
    if scene.device != device:
        raise ValueError(f"scene is on {scene.device}, render_forward was "
                         f"asked to run on {device}")
    cfg = _integrator_cfg(scene, integrator)
    kind = cfg["type"]
    if kind not in _PATH_TYPES:
        raise NotImplementedError(
            f"render_forward: integrator '{kind}' has no forward-mode path "
            "(the reference implements forward for the PRB family only)")
    if spp == 0:
        spp = scene.static.spp
    multi_pop = cfg["multi_pop"]
    dimg = prb.render_prb_forward(
        scene, d_scene, seed=seed, sensor_idx=sensor, spp=spp,
        max_depth=int(cfg["max_depth"]), rr_depth=int(cfg["rr_depth"]),
        multi_pop=None if multi_pop is None else int(multi_pop),
        reparam=kind == "prb_reparam", rp_items=_rp_items(cfg))
    if scene.bvh is not None and device.type == "cuda":
        CT.raise_on_overflow(device)
    return dimg
