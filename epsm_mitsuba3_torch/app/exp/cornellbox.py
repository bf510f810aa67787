"""The Cornell-box light-ring experiment (counterpart of
``app/exp/cornellbox.py``, the reference's ``EPSM/exp/cornellbox.py``).

Six coloured area lights and diffuse bars on a ring above the box; the
latent parameters are the six ring rotation angles, starting pi/3 from
the target, optimized with ``manifold_caustic`` in the reference
(cornellbox.py:7-12, 104-130).  Budgets: 500 iterations, 256 spp, 512^2,
depth 6, ``thres`` 375, ``match_res`` 128.
"""
from __future__ import annotations

import math

import torch

from ...core import transform as TR
from ...core.transform import ScalarTransform4f as T
from ...models.scene import load_dict
from . import common as C

NUM = 6
RGB = [[100, 0, 0], [100, 100, 0], [0, 100, 0],
       [0, 100, 100], [0, 0, 100], [100, 0, 100]]
ANGLE = [math.pi * 2 * i / NUM - math.pi / 2 for i in range(NUM)]
INIT_ROT = math.pi / 3


def make(resolution=512, spp=256, it=500, thres=375, max_depth=6,
         match_res=128, light_scale=0.05, device=None):
    """The experiment dict of ``app/optim.run``; ``device=None`` means the
    GPU."""
    d = {"type": "scene",
         "integrator": {"type": "manifold_caustic", "max_depth": max_depth}}
    d.update(C.three_sensors(T, [0, 1, 3.9], [0, 1, 0], [0, 1, 0],
                             resolution, match_res, spp))
    d.update(C.cornell_walls(T))
    # untransformed rectangles: apply() places them from the latent angles
    # (the reference's cornellbox2 scene, cornellbox.py:66-96)
    for i in range(NUM):
        d[f"light{i}"] = {
            "type": "rectangle",
            "emitter": {"type": "area",
                        "radiance": {"type": "rgb", "value": RGB[i]}},
            "bsdf": {"type": "diffuse",
                     "reflectance": {"type": "rgb", "value": 0.0}},
        }
        d[f"lightbar{i}"] = {
            "type": "rectangle",
            "bsdf": {"type": "twosided",
                     "material": {"type": "diffuse",
                                  "reflectance": {"type": "rgb",
                                                  "value": 0.4}}},
        }
    scene = load_dict(d, device=device)
    dev = scene.device

    # each moving shape's untransformed vertices
    base = {}
    for i in range(NUM):
        for nm in (f"light{i}", f"lightbar{i}"):
            s, c = C.shape_range(scene, nm)
            base[nm] = scene.vertices[s:s + c].clone()

    target = torch.tensor([0.0, 1.0, -0.3], device=dev)
    up = torch.tensor([0.0, 0.0, 1.0], device=dev)
    scale = TR.scale(torch.tensor(light_scale, device=dev))

    def ring_mat(i, rot, radius=0.5):
        x = radius * torch.sin(rot + ANGLE[i])
        y = radius * torch.cos(rot + ANGLE[i])
        origin = torch.stack([x, 1.0 + y, torch.full_like(x, 0.1)])
        return TR.look_at(origin, target, up) @ scale

    def apply(scene, theta):
        sc = scene
        for i in range(NUM):
            rot = theta[f"rot{i}"]
            sc = C.transform_shape(sc, f"light{i}", ring_mat(i, rot),
                                   base[f"light{i}"])
            # the bars follow at radius 0.51 with a detached angle
            # (cornellbox.py:120-125)
            sc = C.transform_shape(sc, f"lightbar{i}",
                                   ring_mat(i, rot.detach(), radius=0.51),
                                   base[f"lightbar{i}"])
        return sc

    return {
        "scene": scene,
        "it": it, "spp": spp, "resolution": resolution, "thres": thres,
        "max_depth": max_depth, "match_res": match_res,
        "init_theta": {f"rot{i}": torch.tensor(INIT_ROT, device=dev)
                       for i in range(NUM)},
        "target_theta": {f"rot{i}": torch.tensor(0.0, device=dev)
                         for i in range(NUM)},
        "apply": apply,
        "output": lambda th: ",".join(
            f"{float(th[f'rot{i}']):.3f}" for i in range(NUM)),
    }
