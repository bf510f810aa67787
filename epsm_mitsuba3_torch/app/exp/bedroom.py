"""The bedroom experiment (counterpart of ``app/exp/bedroom.py``, the
reference's ``EPSM/exp/bedroom.py``): 2 object translations in a
procedural room.  Budgets: 200 iterations, 256 spp, depth 8
(bedroom.py:4-9).  ``scene_path`` loads an XML scene instead, whose two
movable shapes are named ``obj0`` and ``obj1``.
"""
from __future__ import annotations

import torch

from ...core.transform import ScalarTransform4f as T
from ...core.xmlparse import load_file
from ...models.scene import load_dict
from . import common as C


def make(resolution=512, spp=256, it=200, thres=10 ** 9, max_depth=8,
         match_res=128, scene_path=None, device=None):
    """The experiment dict of ``app/optim.run``; ``device=None`` means the
    GPU."""
    if scene_path is not None:
        scene = load_file(scene_path, device=device)
        names = ["obj0", "obj1"]
    else:
        d = {"type": "scene",
             "integrator": {"type": "manifold", "max_depth": max_depth}}
        d.update(C.three_sensors(T, [0, 1.0, 3.8], [0, 0.9, 0], [0, 1, 0],
                                 resolution, match_res, spp))
        d.update(C.cornell_walls(T, white=(0.7, 0.68, 0.62)))
        d["bed"] = {"type": "cube",
                    "to_world": T.translate([-0.3, 0.25, -0.2])
                    .scale([0.5, 0.25, 0.4]),
                    "bsdf": {"type": "diffuse",
                             "reflectance": {"type": "rgb",
                                             "value": [0.6, 0.5, 0.45]}}}
        d["table"] = {"type": "cube",
                      "to_world": T.translate([0.55, 0.2, 0.2])
                      .scale([0.15, 0.2, 0.15]),
                      "bsdf": {"type": "diffuse",
                               "reflectance": {"type": "rgb",
                                               "value": [0.35, 0.25, 0.18]}}}
        d["light"] = {"type": "rectangle",
                      "to_world": T.translate([0, 1.99, 0])
                      .rotate([1, 0, 0], 90).scale(0.35),
                      "emitter": {"type": "area",
                                  "radiance": {"type": "rgb",
                                               "value": [15.0, 14.0, 12.0]}}}
        scene = load_dict(d, device=device)
        names = ["bed", "table"]
    dev = scene.device

    def apply(scene, theta):
        t = torch.stack([theta[f"t{i}"] for i in range(len(names))])
        return C.translate_shapes(scene, names, torch.stack(
            [t[:, 0], torch.zeros_like(t[:, 0]), t[:, 1]], dim=1))

    return {
        "scene": scene,
        "it": it, "spp": spp, "resolution": resolution, "thres": thres,
        "max_depth": max_depth, "match_res": match_res,
        "init_theta": {"t0": torch.tensor([0.2, -0.15], device=dev),
                       "t1": torch.tensor([-0.15, 0.1], device=dev)},
        "target_theta": {"t0": torch.zeros(2, device=dev),
                         "t1": torch.zeros(2, device=dev)},
        "apply": apply,
        "output": lambda th: (
            f"t0={float(torch.as_tensor(th['t0']).abs().mean()):.3f} "
            f"t1={float(torch.as_tensor(th['t1']).abs().mean()):.3f}"),
    }
