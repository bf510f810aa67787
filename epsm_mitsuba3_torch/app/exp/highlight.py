"""The highlight experiment (counterpart of ``app/exp/highlight.py``,
the reference's ``EPSM/exp/highlight.py``): three lights reflected in a
GGX rough-conductor floor; the latent parameters are each light's xy
translation.  Budgets: 500 iterations, 64 spp, depth 2, ``thres`` 375
(highlight.py:9-14).
"""
from __future__ import annotations

import torch

from ...core.transform import ScalarTransform4f as T
from ...models.scene import load_dict
from . import common as C

NUM = 3


def make(resolution=512, spp=64, it=500, thres=375, max_depth=2,
         match_res=128, device=None):
    """The experiment dict of ``app/optim.run``; ``device=None`` means the
    GPU."""
    d = {"type": "scene",
         "integrator": {"type": "manifold", "max_depth": max_depth}}
    d.update(C.three_sensors(T, [0, 1.2, 4], [0, 0.6, 0], [0, 1, 0],
                             resolution, match_res, spp))
    d["floor"] = {"type": "rectangle",
                  "to_world": T.scale(4).rotate([1, 0, 0], -90),
                  "bsdf": {"type": "roughconductor", "alpha": 0.08,
                           "eta": {"type": "rgb", "value": [0.2, 0.92, 1.1]},
                           "k": {"type": "rgb", "value": [3.9, 2.45, 2.14]}}}
    for i in range(NUM):
        x = -0.8 + 0.8 * i
        d[f"light{i}"] = {
            "type": "rectangle",
            "to_world": T.look_at(origin=[x, 1.6, -0.5],
                                  target=[x, 0, 0.5], up=[0, 1, 0])
            .scale(0.12),
            "emitter": {"type": "area",
                        "radiance": {"type": "rgb",
                                     "value": [25.0, 20.0, 14.0]}},
            "bsdf": {"type": "diffuse",
                     "reflectance": {"type": "rgb", "value": 0.0}},
        }
    scene = load_dict(d, device=device)
    dev = scene.device

    def apply(scene, theta):
        t = torch.stack([theta[f"t{i}"] for i in range(NUM)])
        return C.translate_shapes(
            scene, [f"light{i}" for i in range(NUM)],
            torch.stack([t[:, 0], t[:, 1], torch.zeros_like(t[:, 0])], dim=1))

    return {
        "scene": scene,
        "it": it, "spp": spp, "resolution": resolution, "thres": thres,
        "max_depth": max_depth, "match_res": match_res,
        "init_theta": {f"t{i}": torch.tensor([0.2, -0.1], device=dev)
                       for i in range(NUM)},
        "target_theta": {f"t{i}": torch.zeros(2, device=dev)
                         for i in range(NUM)},
        "apply": apply,
        "output": lambda th: " ".join(
            f"{float(torch.as_tensor(th[f't{i}']).abs().mean()):.3f}"
            for i in range(NUM)),
    }
