"""The differentiable ``render`` entry point (counterpart of
``ad/render.py``): every float tensor of the scene that requires grad
receives its gradient through ``torch.autograd``: PRB (``ad/prb.py``)
for the ``path``, ``prb`` and ``prb_basic`` integrators, reparameterised
PRB (``ad/reparam.py``) for ``prb_reparam``, the EPSM manifold backward
(``integrators/epsm.py``) for ``manifold`` and ``manifold_caustic``, the
attached reparameterised estimators (``ad/direct_reparam.py``) for
``direct_reparam`` and ``emission_reparam``, and zero for ``direct``
(``integrators/direct.py``), as the reference detaches its scene.
``render_forward`` is forward mode for the PRB family."""
from __future__ import annotations

from typing import Optional

import torch

from ..core.device import resolve_device
from ..models.films import kahan_add
from ..integrators import direct, epsm
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


def render(scene, seed: int = 0, spp: int = 0, sensor: int = 0,
           integrator: Optional[dict] = None, spp_chunk: int = 0,
           device=None) -> torch.Tensor:
    """mi.render: the (H, W, 3) image of ``scene`` ((H, W, 5) for the
    EPSM integrators), differentiable w.r.t. the scene's float tensors
    that require grad.  ``direct``, ``direct_reparam`` and
    ``emission_reparam`` read ``integrator["emitter_samples"]`` and
    ``["bsdf_samples"]`` (default 1 each); the reparameterised types the
    settings of ``_rp_items``.

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
    if cfg["type"] not in _PATH_TYPES + _EPSM_TYPES + _DIRECT_TYPES:
        raise NotImplementedError(
            f"integrator '{cfg['type']}' is not ported")
    if spp == 0:
        spp = scene.static.spp

    multi_pop = cfg["multi_pop"]
    samples = (int(cfg.get("emitter_samples", 1)),
               int(cfg.get("bsdf_samples", 1)))

    def one_pass(pass_seed, pass_spp):
        if cfg["type"] == "direct":
            return direct.render_direct(scene, pass_seed, sensor, pass_spp,
                                        *samples)
        if cfg["type"] == "direct_reparam":
            return direct_reparam.render_direct_reparam(
                scene, pass_seed, sensor, pass_spp, *samples,
                rp_items=_rp_items(cfg))
        if cfg["type"] == "emission_reparam":
            return direct_reparam.render_emission_reparam(
                scene, pass_seed, sensor, pass_spp, rp_items=_rp_items(cfg))
        if cfg["type"] in _EPSM_TYPES:
            return epsm.render_epsm(
                scene, seed=pass_seed, sensor_idx=sensor, spp=pass_spp,
                max_depth=int(cfg["max_depth"]),
                rr_depth=int(cfg["rr_depth"]),
                caustic=cfg["type"] == "manifold_caustic")
        return prb.render_prb(
            scene, seed=pass_seed, sensor_idx=sensor, spp=pass_spp,
            max_depth=int(cfg["max_depth"]), rr_depth=int(cfg["rr_depth"]),
            multi_pop=None if multi_pop is None else int(multi_pop),
            reparam=cfg["type"] == "prb_reparam",
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
