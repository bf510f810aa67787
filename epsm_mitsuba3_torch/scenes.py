"""Scene dicts of the port's workloads.

``cornell_box`` is the classic Cornell box of the reference's test scenes
(``tests/scenes.py`` of the JAX package): white floor, ceiling and back
wall, red left and green right walls, a small area light under the
ceiling; 12 triangles.  ``cornell_box_mesh`` adds the displaced sphere
``bumpy_sphere`` (64,800 triangles at the default ``subdiv``), so that
every ray query goes through the BVH.  ``blocker_scene`` is the
reparameterisation's silhouette scene (the JAX package's
``tests/test_reparam.py`` ``_make``): a floor under a small square
blocker and an area light, so that the blocker's shadow edge moves with
it.  ``single_quad_direct`` is one diffuse quad under one area light (the
JAX package's ``tests/scenes.py``), where ``direct`` and ``path`` at
``max_depth`` 2 estimate the same image.
"""
from __future__ import annotations

import numpy as np

from .core.transform import ScalarTransform4f as T


def cornell_box(res: int = 64, spp: int = 16, max_depth: int = 4,
                light_size: float = 0.5):
    def wall(to_world, rgb):
        return {
            "type": "rectangle",
            "to_world": to_world,
            "bsdf": {"type": "diffuse",
                     "reflectance": {"type": "rgb", "value": rgb}},
        }

    white = [0.725, 0.71, 0.68]
    red = [0.57, 0.043, 0.044]
    green = [0.105, 0.37, 0.067]

    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": max_depth},
        "sensor": {
            "type": "perspective",
            "fov": 39.3077,
            "to_world": T.look_at(origin=[0, 1, 3.9], target=[0, 1, 0],
                                  up=[0, 1, 0]),
            "film": {"type": "hdrfilm", "width": res, "height": res,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp},
        },
        # floor y=0 (normal +y)
        "floor": wall(T.translate([0, 0, 0]).rotate([1, 0, 0], -90), white),
        # ceiling y=2 (normal -y)
        "ceiling": wall(T.translate([0, 2, 0]).rotate([1, 0, 0], 90), white),
        # back wall z=-1 (normal +z)
        "back": wall(T.translate([0, 1, -1]), white),
        # left wall x=-1 (normal +x), red
        "left": wall(T.translate([-1, 1, 0]).rotate([0, 1, 0], 90), red),
        # right wall x=+1 (normal -x), green
        "right": wall(T.translate([1, 1, 0]).rotate([0, 1, 0], -90), green),
        # area light just below the ceiling, facing down
        "light": {
            "type": "rectangle",
            "to_world": T.translate([0, 1.99, 0]).rotate([1, 0, 0], 90)
            .scale(light_size * 0.5),
            "emitter": {"type": "area",
                        "radiance": {"type": "rgb",
                                     "value": [18.4, 15.6, 8.0]}},
            "bsdf": {"type": "diffuse",
                     "reflectance": {"type": "rgb", "value": [0, 0, 0]}},
        },
    }


def bumpy_sphere(subdiv: int = 180, radius: float = 0.55,
                 center=(0.0, 0.7, 0.0), bump: float = 0.08):
    """Displaced UV sphere of 2 * subdiv^2 triangles of incoherent
    geometry: (vertices (V, 3) float32, faces (F, 3) int32)."""
    th = np.linspace(1e-3, np.pi - 1e-3, subdiv + 1)
    ph = np.linspace(0, 2 * np.pi, subdiv + 1)[:-1]
    TH, PH = np.meshgrid(th, ph, indexing="ij")
    r = radius * (1.0 + bump * (np.sin(6 * TH) * np.cos(5 * PH)
                                + 0.5 * np.sin(11 * PH + 2 * TH)))
    x = r * np.sin(TH) * np.cos(PH) + center[0]
    y = r * np.cos(TH) + center[1]
    z = r * np.sin(TH) * np.sin(PH) + center[2]
    V = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    n_ph = subdiv
    faces = []
    for i in range(subdiv):
        for j in range(n_ph):
            a = i * n_ph + j
            b = i * n_ph + (j + 1) % n_ph
            c = (i + 1) * n_ph + j
            d = (i + 1) * n_ph + (j + 1) % n_ph
            faces.append([a, c, b])
            faces.append([b, c, d])
    F = np.asarray(faces, np.int32)
    return V, F


def cornell_box_mesh(res: int = 64, spp: int = 16, max_depth: int = 4,
                     subdiv: int = 180):
    """The Cornell box with ``bumpy_sphere`` in it: 64,812 triangles at
    the default ``subdiv``."""
    d = cornell_box(res=res, spp=spp, max_depth=max_depth)
    V, F = bumpy_sphere(subdiv=subdiv)
    d["blob"] = {
        "type": "mesh",
        "vertices": V,
        "faces": F,
        "bsdf": {"type": "diffuse",
                 "reflectance": {"type": "rgb", "value": [0.55, 0.45, 0.3]}},
    }
    return d


def blocker_scene(res: int = 24, spp: int = 16):
    """A 2 x 2 floor, a 0.8 x 0.8 blocker 1 above it and a 0.6 x 0.6
    light at 2.5, seen from (0, 3, 3) through a box filter; 6
    triangles."""
    return {
        "type": "scene",
        "sensor": {
            "type": "perspective", "fov": 45.0,
            "to_world": T.look_at(origin=[0, 3, 3], target=[0, 0, 0],
                                  up=[0, 1, 0]),
            "film": {"type": "hdrfilm", "width": res, "height": res,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp},
        },
        "floor": {"type": "rectangle",
                  "to_world": T.scale(2).rotate([1, 0, 0], -90),
                  "bsdf": {"type": "diffuse",
                           "reflectance": {"type": "rgb", "value": 0.8}}},
        "blocker": {"type": "rectangle",
                    "to_world": T.translate([0.0, 1.0, 0])
                    .rotate([1, 0, 0], -90).scale(0.4),
                    "bsdf": {"type": "diffuse",
                             "reflectance": {"type": "rgb", "value": 0.3}}},
        "light": {"type": "rectangle",
                  "to_world": T.translate([0, 2.5, 0])
                  .rotate([1, 0, 0], 90).scale(0.3),
                  "emitter": {"type": "area",
                              "radiance": {"type": "rgb", "value": 30.0}}},
    }


def single_quad_direct(res: int = 32, spp: int = 8, albedo=(0.6, 0.4, 0.2)):
    """One diffuse 2 x 2 quad at z = 0 lit by a 1 x 1 area light at z = 3
    facing it, seen obliquely from (0, -3, 3) through a box filter; 4
    triangles."""
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 2},
        "sensor": {
            "type": "perspective",
            "fov": 45.0,
            # oblique, so that the light does not hide the quad
            "to_world": T.look_at(origin=[0, -3, 3], target=[0, 0, 0],
                                  up=[0, 0, 1]),
            "film": {"type": "hdrfilm", "width": res, "height": res,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp},
        },
        "quad": {
            "type": "rectangle",
            "bsdf": {"type": "diffuse",
                     "reflectance": {"type": "rgb", "value": list(albedo)}},
        },
        "light": {
            "type": "rectangle",
            "to_world": T.translate([0, 0, 3]).rotate([1, 0, 0], 180)
            .scale(0.5),
            "emitter": {"type": "area",
                        "radiance": {"type": "rgb",
                                     "value": [10.0, 10.0, 10.0]}},
        },
    }
