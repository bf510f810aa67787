"""Optimization loop (counterpart of ``app/optim.py``, the reference's
``EPSM/optim.py``).

``run`` optimizes with one of ``METHODS`` -- ``manifold``,
``manifold_caustic``, ``prb``, ``prb_reparam`` (refused, below) and
``path`` -- or with its ``_hybrid`` form: the method until iteration
``thres``, then PRB with a fresh Adam state (optim.py:87-119).  An
experiment is a dict (see ``app/exp``) with:

- ``scene``: the port's Scene; the reference's sensor conventions hold:
  PRB renders sensor 0, the manifold methods sensor 1, and the manifold
  backward the last sensor (optim.py:103-106, epsm.py:142);
- ``apply(scene, theta) -> Scene``: differentiable in ``theta``, a dict
  of tensors (a vertex edit goes through ``Scene.set_vertices``);
- ``init_theta``; ``target_theta``, or ``gt_scene``;
- ``gt_spp``, ``it``, ``spp``, ``resolution``, ``thres``, ``max_depth``,
  ``match_res`` and ``output(theta) -> str``, as in the reference.

Below ``thres`` (every iteration without ``_hybrid``) an iteration renders
with the method's integrator and takes the 5-channel optimal-transport
loss: the Sinkhorn matcher's gradient at ``match_res`` is tiled over the
image and held fixed, and the loss is sum(image * g5) (optim.py:130-136).
From ``thres`` on it takes the PRB render's mean squared error.  Each
gradient is cleared of NaNs before Adam steps.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..ad.optimizers import Adam
from ..ad.render import render
from ..core.logger import ProgressReporter
from ..ops.sinkhorn import Matcher, full_f32_matmul
from ..utils import checkpoint as ckpt
from ..utils.logger import Logger

METHODS = ("manifold", "manifold_caustic", "prb", "prb_reparam", "path")


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """The (n_in, n_out) weights of ``jax.image.resize(..., "linear")``
    along one axis (``jax.image.scale_and_translate``'s
    ``compute_weight_mat``): a triangle kernel, widened by the shrink
    factor when shrinking (antialiasing), each column normalised, float32
    as there."""
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    f32 = torch.float32
    sample_f = ((torch.arange(n_out, dtype=f32, device=device) + 0.5)
                * inv_scale - 0.5)
    x = torch.abs(sample_f[None, :] - torch.arange(
        n_in, dtype=f32, device=device)[:, None]) / kernel_scale
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * 1.1920929e-07,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _resize(img: torch.Tensor, res: int) -> torch.Tensor:
    """``_resize`` (:33): ``jax.image.resize(img, (res, res, C),
    "linear")``, separable, axes of equal size left as they are."""
    h, w = img.shape[:2]
    with full_f32_matmul():
        if h != res:
            wy = _resize_weights(h, res, img.device)
            img = torch.einsum("hwc,hH->Hwc", img, wy)
        if w != res:
            wx = _resize_weights(w, res, img.device)
            img = torch.einsum("hwc,wW->hWc", img, wx)
    return img


def run(method: str, exp: Dict, log_dir: str = None, verbose: bool = True,
        adam_lr: float = 0.01, iters: int = None,
        checkpoint_every: int = 0, resume: bool = False,
        max_wavefront: int = 2_000_000,
        log: Optional[Callable[[int, float, Dict], None]] = None):
    """Optimize ``exp["init_theta"]`` for ``iters`` (default ``exp["it"]``)
    iterations of ``method`` (``run``, :37-134).  Returns (the optimizer,
    the history: one dict of numpy values of theta after each iteration
    this call ran).  Renders run on the scene's device.  ``log(it, loss,
    theta)`` is called after each step (it waits for the device).

    With ``log_dir``, a ``Logger`` there dumps theta after each iteration
    (``params/param{it}.npy``), every ``checkpoint_every`` iterations
    ``save_optimizer`` writes the optimizer into ``{log_dir}/ckpt``, and
    ``resume`` restarts from its latest checkpoint, at the iteration after
    it.  ``verbose`` writes a progress bar to standard error.

    ``prb``, ``prb_reparam`` and ``path`` without ``_hybrid`` take the OT
    loss as the reference's ``run`` does, whose 5-channel gradient does
    not fit their 3-channel image: the reference raises there (``img *
    g_full``, :100), and so does this ``run``, before any render.  With
    ``_hybrid``, the iterations before ``thres`` take that loss too, so
    ``prb_reparam_hybrid`` fails there as the reference does; from
    ``thres`` on every ``_hybrid`` method is the ``prb`` MSE step."""
    hybrid = method.endswith("_hybrid")
    base = method[: -len("_hybrid")] if hybrid else method
    if base not in METHODS:
        raise ValueError(f"unknown method '{method}'")
    if not hybrid and not base.startswith("manifold"):
        raise ValueError(
            f"method '{method}': without _hybrid every method takes the "
            f"5-channel OT loss, and the '{base}' integrator renders 3 "
            "channels (the reference fails at img * g_full); use "
            f"'{base}_hybrid'")
    scene = exp["scene"]
    device = scene.device
    it_total = iters if iters is not None else exp["it"]
    spp = exp["spp"]
    thres = exp.get("thres", 10 ** 9) if hybrid else 10 ** 9
    max_depth = exp["max_depth"]
    match_res = exp["match_res"]
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
        gt_low = _resize(img_ref, match_res).reshape(-1, 3)

    matcher = Matcher(match_res, device=device)
    sensor_id = 1 if base.startswith("manifold") else 0
    if sensor_id >= len(scene.sensors):
        sensor_id = 0

    opt = Adam(lr=adam_lr)
    for k, v in exp["init_theta"].items():
        opt[k] = torch.as_tensor(v, dtype=torch.float32, device=device)
    start_it = 0
    if resume and log_dir:
        start_it = ckpt.load_optimizer(f"{log_dir}/ckpt", opt)
    integrator1 = {"type": base, "max_depth": max_depth}
    integrator2 = {"type": "prb", "max_depth": max_depth}

    def loss_manifold(theta, seed):
        img = render(apply_fn(scene, theta), spp=spp, seed=seed,
                     sensor=sensor_id, integrator=integrator1,
                     spp_chunk=spp_chunk, device=device)
        # the 5-channel OT loss (optim.py:130-136)
        with torch.no_grad():
            img_low = _resize(img[..., :3], match_res).reshape(-1, 3)
            g5 = matcher.match_Sinkhorn(img_low, gt_low).reshape(
                match_res, match_res, 5)
            n = img.shape[0]
            reps = max(1, n // match_res)
            g_full = g5.repeat(reps, reps, 1)[:n, :n]
        return torch.sum(img * g_full)

    def loss_prb(theta, seed):
        img = render(apply_fn(scene, theta), spp=spp, seed=seed, sensor=0,
                     integrator=integrator2, spp_chunk=spp_chunk,
                     device=device)[..., :3]
        return torch.sum((img - img_ref) ** 2) / img.numel()

    logger = Logger(log_dir) if log_dir else None
    progress = ProgressReporter(base, it_total) if verbose else None
    history = []
    try:
        for it in range(start_it, it_total):
            if it == thres:
                for k in list(opt.keys()):
                    opt.reset(k)
            theta = {k: v.clone().requires_grad_(True)
                     for k, v in opt.items()}
            loss = (loss_manifold if it < thres else loss_prb)(theta, it)
            grads = torch.autograd.grad(loss, list(theta.values()),
                                        allow_unused=True)
            opt.step({k: torch.zeros_like(theta[k]) if g is None
                      else torch.nan_to_num(g)
                      for k, g in zip(theta, grads)})
            if progress:
                progress.update(it + 1, exp["output"](dict(opt.items()))[:40])
            history.append({k: v.detach().cpu().numpy().copy()
                            for k, v in opt.items()})
            if logger:
                logger.add_params(it, history[-1])
            if checkpoint_every and log_dir \
                    and (it + 1) % checkpoint_every == 0:
                ckpt.save_optimizer(f"{log_dir}/ckpt", it, opt)
            if log is not None:
                log(it, float(loss.detach()), history[-1])
    finally:
        if logger:
            logger.close()
    return opt, history
