"""The glass-slab experiment (counterpart of ``app/exp/glassslab.py``,
the reference's ``EPSM/exp/glassslab.py``): light seen through a
refractive slab whose per-vertex normals are the latent field
(glassslab.py:250-278).  Budgets: 1000 iterations, 64 spp, 512^2, depth
4, ``match_res`` 256, a 16 x 16 grid (glassslab.py:9-14).

The slab is written as an OBJ with per-vertex normals into a temporary
directory and loaded from there, as the reference does; theta is the
(V, 2) tangent perturbation of its normals, renormalised into
``scene.normals``, through which the manifold backward's normal
gradient reaches it.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import replace

import numpy as np
import torch

from ...core import math as m
from ...core.transform import ScalarTransform4f as T
from ...models.scene import load_dict
from . import common as C


def _slab_obj(path: str, grid: int) -> None:
    """The slab's front face, ``grid`` x ``grid`` quads over [-1, 1]^2 at
    z = 0 with normals +z, as an OBJ at ``path``."""
    xs = np.linspace(-1, 1, grid + 1, dtype=np.float32)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    V = np.stack([X, Y, np.zeros_like(X)], -1).reshape(-1, 3)
    faces = []
    for i in range(grid):
        for j in range(grid):
            a = i * (grid + 1) + j
            b, c = a + 1, a + (grid + 1)
            faces.append([a, b, c + 1])
            faces.append([c + 1, c, a])
    with open(path, "w") as f:
        for v in V:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for _ in V:
            f.write("vn 0 0 1\n")
        for tri in np.asarray(faces, np.int32) + 1:
            f.write(f"f {tri[0]}//{tri[0]} {tri[1]}//{tri[1]} "
                    f"{tri[2]}//{tri[2]}\n")


def make(resolution=512, spp=64, it=1000, thres=10 ** 9, max_depth=4,
         match_res=256, grid: int = 16, device=None):
    """The experiment dict of ``app/optim.run``; ``device=None`` means the
    GPU."""
    d = {"type": "scene",
         "integrator": {"type": "manifold_caustic", "max_depth": max_depth}}
    d.update(C.three_sensors(T, [0, 0, 4], [0, 0, 0], [0, 1, 0],
                             resolution, match_res, spp))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "slab.obj")
        _slab_obj(path, grid)
        d["slab"] = {"type": "obj", "filename": path,
                     "bsdf": {"type": "dielectric"}}
        d["screen"] = {"type": "rectangle",
                       "to_world": T.translate([0, 0, -1.5]).scale(2.0),
                       "bsdf": {"type": "diffuse",
                                "reflectance": {"type": "rgb",
                                                "value": 0.8}}}
        d["light"] = {"type": "rectangle",
                      "to_world": T.translate([0, 0, 3])
                      .rotate([1, 0, 0], 180).scale(0.3),
                      "emitter": {"type": "area",
                                  "radiance": {"type": "rgb",
                                               "value": 20.0}}}
        scene = load_dict(d, device=device)
    dev = scene.device
    s, c = C.shape_range(scene, "slab")

    def apply(scene, theta):
        """theta["normal_field"] (V, 2): the slab normals' tangent
        perturbation, renormalised (glassslab.py:250-278)."""
        nf = theta["normal_field"]
        n = torch.cat([nf, torch.ones_like(nf[:, :1])], -1)
        n = n * m.safe_rsqrt(m.squared_norm(n))[:, None]
        return replace(scene, normals=torch.cat(
            [scene.normals[:s], n, scene.normals[s + c:]]))

    init = np.random.default_rng(0).normal(0, 0.05, (c, 2)).astype(
        np.float32)
    return {
        "scene": scene,
        "it": it, "spp": spp, "resolution": resolution, "thres": thres,
        "max_depth": max_depth, "match_res": match_res,
        "init_theta": {"normal_field": torch.from_numpy(init).to(dev)},
        "target_theta": {"normal_field": torch.zeros((c, 2), device=dev)},
        "apply": apply,
        "output": lambda th: "|nf|={:.4f}".format(float(
            torch.as_tensor(th["normal_field"]).abs().mean())),
    }
