"""Optimization loop (counterpart of ``app/optim.py``): the ``prb`` /
``path`` leg of ``run``.

An experiment is a dict with:

- ``scene``: the port's Scene (sensor 0 renders);
- ``apply(scene, theta) -> Scene``: differentiable in ``theta``, a dict
  of tensors (a vertex edit goes through ``Scene.set_vertices``);
- ``init_theta``: the latent variables' starting values;
- ``target_theta``, or ``gt_scene``: the ground truth;
- ``gt_spp``, ``it``, ``spp``, ``resolution``, ``max_depth``,
  ``match_res`` and ``output(theta) -> str``, as in the reference.

Each iteration renders ``apply(scene, theta)`` with PRB, takes the
gradient of the mean squared error against the ground-truth image
(``loss_prb``, :102-106), clears NaNs and steps Adam (:114-126).  The
manifold (EPSM) methods and the ``_hybrid`` switch come with the EPSM
slice; the logger, checkpoints and progress reporter with the
application slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..ad.optimizers import Adam
from ..ad.render import render

METHODS = ("prb", "path")


def run(method: str, exp: Dict, adam_lr: float = 0.01, iters: int = None,
        max_wavefront: int = 2_000_000,
        log: Optional[Callable[[int, float, Dict], None]] = None):
    """Optimize ``exp["init_theta"]`` for ``iters`` (default ``exp["it"]``)
    iterations of ``method``.  Returns (the optimizer, the history: one
    dict of numpy values of theta after each iteration).  Renders run on
    the scene's device.  ``log(it, loss, theta)`` is called after each
    step (it waits for the device)."""
    if method.startswith("manifold") or method.endswith("_hybrid"):
        raise NotImplementedError(
            f"method '{method}': the manifold (EPSM) leg and the _hybrid "
            "switch come with the EPSM slice of the port")
    if method not in METHODS:
        raise ValueError(f"unknown method '{method}'")
    scene = exp["scene"]
    device = scene.device
    it_total = iters if iters is not None else exp["it"]
    spp = exp["spp"]
    max_depth = exp["max_depth"]
    apply_fn = exp["apply"]
    res = exp.get("resolution", 512)
    # wavefront splitting (integrator.cpp:201-219): at most max_wavefront
    # lanes a pass
    spp_chunk = max(1, min(spp, max_wavefront // max(res * res, 1)))

    # ground truth (optim.py:51-66)
    gt_scene = exp.get("gt_scene")
    with torch.no_grad():
        if gt_scene is None:
            gt_scene = apply_fn(scene, exp["target_theta"])
        img_ref = render(gt_scene, spp=exp.get("gt_spp", 512), seed=0,
                         sensor=0,
                         integrator={"type": "path", "max_depth": max_depth},
                         spp_chunk=spp_chunk, device=device)[..., :3]

    opt = Adam(lr=adam_lr)
    for k, v in exp["init_theta"].items():
        opt[k] = torch.as_tensor(v, dtype=torch.float32, device=device)
    integrator = {"type": "prb", "max_depth": max_depth}
    history = []
    for it in range(it_total):
        theta = {k: v.clone().requires_grad_(True) for k, v in opt.items()}
        img = render(apply_fn(scene, theta), spp=spp, seed=it, sensor=0,
                     integrator=integrator, spp_chunk=spp_chunk,
                     device=device)[..., :3]
        loss = torch.sum((img - img_ref) ** 2) / img.numel()
        grads = torch.autograd.grad(loss, list(theta.values()),
                                    allow_unused=True)
        opt.step({k: torch.zeros_like(theta[k]) if g is None
                  else torch.nan_to_num(g) for k, g in zip(theta, grads)})
        history.append({k: v.detach().cpu().numpy().copy()
                        for k, v in opt.items()})
        if log is not None:
            log(it, float(loss.detach()), history[-1])
    return opt, history
