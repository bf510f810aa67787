"""Human pose optimisation driver (counterpart of ``app/optim_human.py``,
the reference's ``EPSM/optim_human.py``).

The reference bridges renderer vertex gradients into SMPL pose gradients
explicitly (optim_human.py:123-131):

    grad = params['human.vertex_positions'].grad        # from dr.backward
    verts = smpl_layer(pose)                             # torch re-forward
    torch.sum(verts * grad).backward()                   # -> pose.grad
    adam.step()

The port keeps the two stages apart: ``vertex_gradient`` renders from a
detached leaf copy of the posed vertices and takes the renderer's VJP
there (for ``manifold``, the EPSM backward), and ``pose_gradient`` then
takes the skinning's VJP, ``torch.autograd.grad(verts, pose, grad_v)``,
which is the reference's ``torch.sum(verts * grad).backward()``.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..ad.optimizers import Adam
from ..ad.render import render
from ..models import smpl
from ..ops.sinkhorn import Matcher
from .optim import _resize


def vertex_gradient(exp: Dict, verts: torch.Tensor, grad_img: torch.Tensor,
                    spp: int, max_depth: int, sensor_id: int, seed: int,
                    method: str = "manifold"):
    """The renderer's VJP at the body's vertices: renders
    ``set_verts(scene, v)`` from a leaf copy ``v`` of ``verts`` and
    returns (dL/dv (V, 3) for the image cotangent ``grad_img``, the
    primal image)."""
    v = verts.detach().requires_grad_(True)
    sc = exp["set_verts"](exp["scene"], v)
    img = render(sc, spp=spp, seed=seed, sensor=sensor_id,
                 integrator={"type": method, "max_depth": max_depth},
                 device=sc.device)
    (grad_v,) = torch.autograd.grad(img, v, grad_img.to(img.dtype),
                                    allow_unused=True,
                                    materialize_grads=True)
    return grad_v, img.detach()


def pose_gradient(exp: Dict, pose: torch.Tensor, grad_img: torch.Tensor,
                  spp: int, max_depth: int, sensor_id: int, seed: int,
                  method: str = "manifold"):
    """dL/dpose for an upstream image cotangent ``grad_img`` through the
    two-stage bridge (optim_human.py:33-53).  Returns (the pose gradient
    (72,), the primal image)."""
    pose = pose.detach().requires_grad_(True)
    verts = smpl.lbs(exp["model"], pose)
    grad_v, img = vertex_gradient(exp, verts, grad_img, spp, max_depth,
                                  sensor_id, seed, method)
    # the reference's torch.sum(verts * grad).backward(): J_lbs^T grad_v
    (pose_grad,) = torch.autograd.grad(verts, pose, grad_v)
    return pose_grad, img


def run(method: str = "manifold", iters: int = None, adam_lr: float = 0.02,
        verbose: bool = True, **kwargs):
    """Optimise the human experiment's pose (optim_human.py:56-126):
    ``human.make(**kwargs)`` (``device=None`` there means the GPU), a
    ``path`` ground truth at ``min(4 spp, 256)`` spp, then ``iters``
    (default the experiment's ``it``) iterations of: the primal render,
    its loss (the 5-channel OT gradient for the manifold methods, the MSE
    otherwise), ``pose_gradient`` (a second render, as the reference's),
    Adam.  Returns (the pose, the loss of each iteration)."""
    from .exp import human
    exp = human.make(**kwargs)
    it_total = iters if iters is not None else exp["it"]
    spp = exp["spp"]
    max_depth = exp["max_depth"]
    match_res = exp["match_res"]
    model, set_verts = exp["model"], exp["set_verts"]

    scene = exp["scene"]
    device = scene.device
    sensor_id = 1 if method.startswith("manifold") else 0
    if sensor_id >= len(scene.sensors):
        sensor_id = 0

    # the ground truth at the target pose
    with torch.no_grad():
        gt_scene = exp["apply"](scene, exp["target_theta"])
        img_ref = render(gt_scene, spp=min(spp * 4, 256), seed=0,
                         sensor=sensor_id,
                         integrator={"type": "path", "max_depth": max_depth},
                         device=device)[..., :3]
        gt_low = _resize(img_ref, match_res).reshape(-1, 3)

    matcher = Matcher(match_res, device=device)
    use_ot = method.startswith("manifold")

    opt = Adam(lr=adam_lr)
    opt["pose"] = exp["init_theta"]["pose"]

    def loss_and_grad(img):
        """The image cotangent and the logged metric (optim.py:130-141)."""
        if use_ot:
            img_low = _resize(img[..., :3], match_res).reshape(-1, 3)
            g5 = matcher.match_Sinkhorn(img_low, gt_low).reshape(
                match_res, match_res, 5)
            n = img.shape[0]
            reps = max(1, n // match_res)
            g_full = g5.repeat(reps, reps, 1)[:n, :n]
            grad_img = g_full if img.shape[-1] == 5 else g_full[..., :3]
        else:
            d = img[..., :3] - img_ref[: img.shape[0], : img.shape[1]]
            grad_img = 2.0 * d / d.numel()
            if img.shape[-1] == 5:
                grad_img = torch.cat(
                    [grad_img, torch.zeros_like(d[..., :2])], -1)
        ref_c = img_ref[: img.shape[0], : img.shape[1]]
        metric = torch.mean((img[..., :3] - ref_c) ** 2)
        return grad_img, metric

    history = []
    for it in range(it_total):
        pose = opt["pose"]
        # stage 1: the primal render, for the image cotangent
        with torch.no_grad():
            sc = set_verts(scene, smpl.lbs(model, pose))
            img = render(sc, spp=spp, seed=it + 1, sensor=sensor_id,
                         integrator={"type": method, "max_depth": max_depth},
                         device=device)
            grad_img, dist = loss_and_grad(img)
        # stage 2: the renderer's VJP -> vertex gradients -> the skinning's
        pg, _ = pose_gradient(exp, pose, grad_img, spp, max_depth,
                              sensor_id, it + 1, method)
        opt.step({"pose": torch.nan_to_num(pg)})
        history.append(float(dist))
        if verbose and (it % 10 == 0 or it == it_total - 1):
            print(f"[{it:4d}] loss={history[-1]:.5f} "
                  f"{exp['output']({'pose': opt['pose']})}")
    return opt["pose"], history


if __name__ == "__main__":
    import sys
    run(sys.argv[1] if len(sys.argv) > 1 else "manifold")
