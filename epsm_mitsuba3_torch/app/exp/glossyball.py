"""Glossyball, joint geometry and material optimization (counterpart of
``app/exp/glossyball.py``, the reference's ``EPSM/exp/glossyball.py``): a
GGX rough-conductor sphere; the latent parameters are its xy translation
and its roughness ``alpha`` (glossyball.py:259-266).  Budgets: 200
iterations, 32 spp, depth 2 (:6-9).
"""
from __future__ import annotations

import torch

from ...core.transform import ScalarTransform4f as T
from ...models.scene import load_dict
from . import common as C


def make(resolution=512, spp=32, it=200, thres=10 ** 9, max_depth=2,
         match_res=128, device=None):
    """The experiment dict of ``app/optim.run``; ``device=None`` means the
    GPU."""
    d = {"type": "scene",
         "integrator": {"type": "manifold_caustic", "max_depth": max_depth}}
    d.update(C.three_sensors(T, [0, 1.5, 4], [0, 0.5, 0], [0, 1, 0],
                             resolution, match_res, spp))
    d["floor"] = {"type": "rectangle",
                  "to_world": T.scale(4).rotate([1, 0, 0], -90),
                  "bsdf": {"type": "diffuse",
                           "reflectance": {"type": "rgb", "value": 0.6}}}
    d["ball"] = {"type": "sphere", "radius": 0.5, "center": [0, 0.5, 0],
                 "bsdf": {"type": "roughconductor", "alpha": 0.15,
                          "eta": {"type": "rgb",
                                  "value": [0.2, 0.92, 1.1]},
                          "k": {"type": "rgb", "value": [3.9, 2.45, 2.14]}}}
    d["light"] = {"type": "rectangle",
                  "to_world": T.look_at(origin=[2, 3, 2], target=[0, 0.5, 0],
                                        up=[0, 1, 0]).scale(0.4),
                  "emitter": {"type": "area",
                              "radiance": {"type": "rgb", "value": 30.0}}}
    scene = load_dict(d, device=device)
    dev = scene.device
    bidx = int(scene.shape_bsdf[
        list(scene.static.shape_names).index("ball")])
    is_ball = torch.arange(scene.bsdfs["alpha"].shape[0], device=dev) == bidx

    def apply(scene, theta):
        t = theta["trans"]
        sc = C.translate_shape(
            scene, "ball", torch.stack([t[0], t[1], torch.zeros_like(t[0])]))
        alpha = torch.where(is_ball, torch.clamp(theta["alpha"], 0.01, 0.8),
                            sc.bsdfs["alpha"])
        return sc.with_leaves({"bsdfs.alpha": alpha})

    return {
        "scene": scene,
        "it": it, "spp": spp, "resolution": resolution, "thres": thres,
        "max_depth": max_depth, "match_res": match_res,
        "init_theta": {"trans": torch.tensor([0.3, 0.1], device=dev),
                       "alpha": torch.tensor(0.4, device=dev)},
        "target_theta": {"trans": torch.zeros(2, device=dev),
                         "alpha": torch.tensor(0.15, device=dev)},
        "apply": apply,
        "output": lambda th: (f"t=({float(th['trans'][0]):.3f},"
                              f"{float(th['trans'][1]):.3f}) "
                              f"a={float(th['alpha']):.3f}"),
    }
