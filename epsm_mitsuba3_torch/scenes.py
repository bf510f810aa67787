"""Scene dicts of the port's workloads.

``cornell_box`` is the classic Cornell box of the reference's test scenes
(``tests/scenes.py`` of the JAX package): white floor, ceiling and back
wall, red left and green right walls, a small area light under the
ceiling; 12 triangles.
"""
from __future__ import annotations

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
