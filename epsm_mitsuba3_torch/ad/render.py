"""The ``render`` entry point (counterpart of ``ad/render.py``), primal
only."""
from __future__ import annotations

from typing import Optional

import torch

from ..core.device import resolve_device
from ..models.films import kahan_add
from . import prb


def _integrator_cfg(scene, integrator: Optional[dict]):
    cfg = dict(scene.static.integrator)
    if integrator:
        cfg.update(integrator)
    cfg.setdefault("type", "path")
    cfg.setdefault("max_depth", 6)
    cfg.setdefault("rr_depth", 5)
    return cfg


def render(scene, seed: int = 0, spp: int = 0, sensor: int = 0,
           integrator: Optional[dict] = None, spp_chunk: int = 0,
           device=None) -> torch.Tensor:
    """mi.render: the (H, W, 3) image of ``scene``.

    ``spp_chunk``: render in passes of at most this many samples per pixel
    and average them with Kahan-compensated sums; pass p is seeded
    ``seed * n_passes + p`` (integrator.cpp:201-219).  ``device=None``
    means the GPU and raises without CUDA; the scene must live on the
    device the call names."""
    device = resolve_device(device)
    if scene.device != device:
        raise ValueError(f"scene is on {scene.device}, render was asked "
                         f"to run on {device}")
    cfg = _integrator_cfg(scene, integrator)
    if cfg["type"] != "path":
        raise NotImplementedError(
            f"integrator '{cfg['type']}' is not ported")
    if spp == 0:
        spp = scene.static.spp
    if spp_chunk and spp > spp_chunk:
        n_passes = -(-spp // spp_chunk)
        acc = comp = None
        for p in range(n_passes):
            img = render(scene, seed * n_passes + p, spp_chunk, sensor,
                         integrator, device=device)
            if acc is None:
                acc, comp = img, torch.zeros_like(img)
            else:
                acc, comp = kahan_add(acc, comp, img)
        return acc / n_passes
    return prb.render_prb(scene, seed=seed, sensor_idx=sensor, spp=spp,
                          max_depth=int(cfg["max_depth"]),
                          rr_depth=int(cfg["rr_depth"]))
