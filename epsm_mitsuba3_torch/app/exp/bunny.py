"""The bunny experiment (counterpart of ``app/exp/bunny.py``, the
reference's ``EPSM/exp/bunny.py``): one object's xz translation in a
Cornell box.  Budgets: 200 iterations, 64 spp, depth 6 (bunny.py:3-8).
It loads ``mesh_path`` (the reference's ``data/meshes/bunny.ply``) where
the file is present, and builds a sphere stand-in otherwise.
"""
from __future__ import annotations

import os

import torch

from ...core.transform import ScalarTransform4f as T
from ...models.scene import load_dict
from . import common as C


def make(resolution=512, spp=64, it=200, thres=10 ** 9, max_depth=6,
         match_res=128, mesh_path="data/meshes/bunny.ply", device=None):
    """The experiment dict of ``app/optim.run``; ``device=None`` means the
    GPU."""
    if os.path.exists(mesh_path):
        obj = {"type": "ply", "filename": mesh_path,
               "to_world": T.translate([0, 0.5, 0])}
    else:
        obj = {"type": "sphere", "radius": 0.5, "center": [0, 0.5, 0]}
    obj["bsdf"] = {"type": "diffuse",
                   "reflectance": {"type": "rgb", "value": [0.7, 0.6, 0.4]}}
    d = {"type": "scene",
         "integrator": {"type": "manifold", "max_depth": max_depth}}
    d.update(C.three_sensors(T, [0, 1.5, 4], [0, 0.5, 0], [0, 1, 0],
                             resolution, match_res, spp))
    d.update(C.cornell_walls(T))
    d["bunny"] = obj
    d["light"] = {"type": "rectangle",
                  "to_world": T.translate([0, 1.99, 0]).rotate([1, 0, 0], 90)
                  .scale(0.3),
                  "emitter": {"type": "area",
                              "radiance": {"type": "rgb",
                                           "value": [18.4, 15.6, 8.0]}}}
    scene = load_dict(d, device=device)
    dev = scene.device

    def apply(scene, theta):
        t = theta["trans"]
        return C.translate_shape(
            scene, "bunny",
            torch.stack([t[0], torch.zeros_like(t[0]), t[1]]))

    return {
        "scene": scene,
        "it": it, "spp": spp, "resolution": resolution, "thres": thres,
        "max_depth": max_depth, "match_res": match_res,
        "init_theta": {"trans": torch.tensor([0.3, 0.2], device=dev)},
        "target_theta": {"trans": torch.zeros(2, device=dev)},
        "apply": apply,
        "output": lambda th: (f"t=({float(th['trans'][0]):.3f},"
                              f"{float(th['trans'][1]):.3f})"),
    }
