"""The egg caustic experiment (counterpart of ``app/exp/egg.py``, the
reference's ``EPSM/exp/egg.py``): a refractive egg casting a caustic on
the floor; the latent parameter is the egg's xz translation.  Budgets:
200 iterations, 256 spp, depth 6, ``manifold_caustic`` (egg.py:3-8).
"""
from __future__ import annotations

import torch

from ...core.transform import ScalarTransform4f as T
from ...models.scene import load_dict
from . import common as C


def make(resolution=512, spp=256, it=200, thres=10 ** 9, max_depth=6,
         match_res=128, device=None):
    """The experiment dict of ``app/optim.run``; ``device=None`` means the
    GPU."""
    d = {"type": "scene",
         "integrator": {"type": "manifold_caustic", "max_depth": max_depth}}
    d.update(C.three_sensors(T, [0, 2.0, 3.5], [0, 0.4, 0], [0, 1, 0],
                             resolution, match_res, spp))
    d["floor"] = {"type": "rectangle",
                  "to_world": T.scale(4).rotate([1, 0, 0], -90),
                  "bsdf": {"type": "diffuse",
                           "reflectance": {"type": "rgb", "value": 0.7}}}
    d["egg"] = {"type": "sphere", "radius": 0.4, "center": [0, 0.45, 0],
                "bsdf": {"type": "dielectric", "int_ior": 1.5}}
    d["light"] = {"type": "rectangle",
                  "to_world": T.look_at(origin=[1.5, 3, 1.5],
                                        target=[0, 0.45, 0],
                                        up=[0, 1, 0]).scale(0.25),
                  "emitter": {"type": "area",
                              "radiance": {"type": "rgb", "value": 60.0}}}
    scene = load_dict(d, device=device)
    dev = scene.device

    def apply(scene, theta):
        t = theta["trans"]
        return C.translate_shape(
            scene, "egg", torch.stack([t[0], torch.zeros_like(t[0]), t[1]]))

    return {
        "scene": scene,
        "it": it, "spp": spp, "resolution": resolution, "thres": thres,
        "max_depth": max_depth, "match_res": match_res,
        "init_theta": {"trans": torch.tensor([0.25, -0.15], device=dev)},
        "target_theta": {"trans": torch.zeros(2, device=dev)},
        "apply": apply,
        "output": lambda th: (f"t=({float(th['trans'][0]):.3f},"
                              f"{float(th['trans'][1]):.3f})"),
    }
