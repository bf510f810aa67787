"""The shadow experiment (counterpart of ``app/exp/shadow.py``, the
reference's ``EPSM/exp/shadow.py``): many diffuse spheres above a floor,
lit by one area light; the latent parameters are the spheres' xz
translations.  400 spheres of 3,968 triangles make 1,587,204 triangles
with the floor and the light, held in a BVH.  Budgets: 600 iterations,
64 spp, depth 2, ``thres`` 250 (shadow.py:6-11, 204-224).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.transform import ScalarTransform4f as T
from ...models.scene import load_dict
from . import common as C


def make(resolution=512, spp=64, it=600, thres=250, max_depth=2,
         match_res=128, n_objects=400, seed=3, device=None):
    """The experiment dict of ``app/optim.run``; ``device=None`` means the
    GPU."""
    d = {"type": "scene",
         "integrator": {"type": "manifold", "max_depth": max_depth}}
    d.update(C.three_sensors(T, [0, 2.5, 4.5], [0, 0.5, 0], [0, 1, 0],
                             resolution, match_res, spp))
    d["floor"] = {"type": "rectangle",
                  "to_world": T.scale(4).rotate([1, 0, 0], -90),
                  "bsdf": {"type": "diffuse",
                           "reflectance": {"type": "rgb", "value": 0.8}}}
    d["light"] = {"type": "rectangle",
                  "to_world": T.translate([0, 4, 0]).rotate([1, 0, 0], 90)
                  .scale(0.4),
                  "emitter": {"type": "area",
                              "radiance": {"type": "rgb", "value": 40.0}}}
    rng = np.random.default_rng(seed)
    grid = max(1, int(math.ceil(math.sqrt(n_objects))))
    names = []
    for i in range(n_objects):
        gx = (i % grid) / grid * 3.0 - 1.5
        gz = (i // grid) / grid * 3.0 - 1.5
        nm = f"ball{i}"
        names.append(nm)
        d[nm] = {"type": "sphere", "radius": 0.45 / grid,
                 "center": [gx, 1.2, gz],
                 "bsdf": {"type": "diffuse",
                          "reflectance": {"type": "rgb", "value": 0.5}}}
    scene = load_dict(d, device=device)
    dev = scene.device
    offsets0 = rng.uniform(-0.2, 0.2, (n_objects, 2)).astype(np.float32)

    def apply(scene, theta):
        off = theta["offsets"]                       # (n, 2) xz offsets
        shift = torch.stack([off[:, 0], torch.zeros_like(off[:, 0]),
                             off[:, 1]], dim=-1)
        # one add and one set_vertices, as the reference's apply
        # (shadow.py:49-57): the tree is refit and re-packed once
        return C.translate_shapes(scene, names, shift)

    return {
        "scene": scene,
        "it": it, "spp": spp, "resolution": resolution, "thres": thres,
        "max_depth": max_depth, "match_res": match_res,
        "init_theta": {"offsets": torch.tensor(offsets0, device=dev)},
        "target_theta": {"offsets": torch.zeros((n_objects, 2),
                                                device=dev)},
        "apply": apply,
        "output": lambda th: (
            f"|off|={float(torch.as_tensor(th['offsets']).abs().mean()):.4f}"),
    }
