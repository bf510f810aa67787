"""The bathroom experiment (counterpart of ``app/exp/bathroom.py``, the
reference's ``EPSM/exp/bathroom.py``): 8 objects with xz translations.
Budgets: 600 iterations, 64 spp, depth 8, ``thres`` 500, ``match_res``
128 (bathroom.py:4-42).  The reference's interior assets are not
shipped; a procedural room with 8 movable boxes keeps the same latent
structure and budgets.  ``scene_path`` loads an XML scene instead, whose
movable shapes are named ``obj0`` to ``obj7``.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.transform import ScalarTransform4f as T
from ...core.xmlparse import load_file
from ...models.scene import load_dict
from . import common as C

N_OBJ = 8


def make(resolution=512, spp=64, it=600, thres=500, max_depth=8,
         match_res=128, scene_path=None, device=None):
    """The experiment dict of ``app/optim.run``; ``device=None`` means the
    GPU."""
    names = [f"obj{i}" for i in range(N_OBJ)]
    if scene_path is not None:
        scene = load_file(scene_path, device=device)
    else:
        d = {"type": "scene",
             "integrator": {"type": "manifold", "max_depth": max_depth}}
        d.update(C.three_sensors(T, [0, 1.2, 3.8], [0, 1, 0], [0, 1, 0],
                                 resolution, match_res, spp))
        d.update(C.cornell_walls(T, white=(0.65, 0.67, 0.7)))
        rng = np.random.default_rng(7)
        for i, nm in enumerate(names):
            x = -0.7 + 1.4 * (i % 4) / 3
            z = -0.5 + 0.6 * (i // 4)
            sz = 0.12 + 0.08 * rng.random()
            d[nm] = {"type": "cube",
                     "to_world": T.translate([x, sz, z]).scale(sz),
                     "bsdf": {"type": "diffuse",
                              "reflectance": {"type": "rgb",
                                              "value": rng.uniform(
                                                  0.2, 0.8, 3).tolist()}}}
        d["light"] = {"type": "rectangle",
                      "to_world": T.translate([0, 1.99, 0])
                      .rotate([1, 0, 0], 90).scale(0.4),
                      "emitter": {"type": "area",
                                  "radiance": {"type": "rgb",
                                               "value": [14.0, 13.0, 11.0]}}}
        scene = load_dict(d, device=device)
    dev = scene.device

    def apply(scene, theta):
        t = torch.stack([theta[f"t{i}"] for i in range(len(names))])
        return C.translate_shapes(scene, names, torch.stack(
            [t[:, 0], torch.zeros_like(t[:, 0]), t[:, 1]], dim=1))

    rng = np.random.default_rng(11)
    return {
        "scene": scene,
        "it": it, "spp": spp, "resolution": resolution, "thres": thres,
        "max_depth": max_depth, "match_res": match_res,
        "init_theta": {f"t{i}": torch.tensor(
            rng.uniform(-0.25, 0.25, 2).astype("float32"), device=dev)
            for i in range(N_OBJ)},
        "target_theta": {f"t{i}": torch.zeros(2, device=dev)
                         for i in range(N_OBJ)},
        "apply": apply,
        "output": lambda th: "|t|={:.4f}".format(float(torch.stack(
            [torch.as_tensor(th[f"t{i}"]) for i in range(N_OBJ)])
            .abs().mean())),
    }
