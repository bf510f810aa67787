"""Shared builders of the experiments (counterpart of
``app/exp/common.py``, the reference's ``EPSM/exp/*``).

The reference's experiments load scene assets that are not shipped;
these rebuild the same optimization structure procedurally: the same
latent parameters, transformation chains, budgets and sensor conventions
(sensor 0 the PRB view, sensor 1 the EPSM view, sensor 2 the low-resolution
backward film; optim.py:103-106, epsm.py:142).
"""
from __future__ import annotations

import torch


def three_sensors(T, origin, target, up, resolution, match_res, spp,
                  fov=39.0):
    """The reference's three-sensor convention."""
    def sensor(res, rfilter="box"):
        return {
            "type": "perspective",
            "fov": fov,
            "to_world": T.look_at(origin=origin, target=target, up=up),
            "film": {"type": "hdrfilm", "width": res, "height": res,
                     "rfilter": {"type": rfilter}},
            "sampler": {"type": "independent", "sample_count": spp},
        }

    return {
        "sensor0": sensor(resolution),
        "sensor1": sensor(resolution),
        "sensor2": sensor(match_res),
    }


def cornell_walls(T, white=(0.725, 0.71, 0.68), red=(0.57, 0.043, 0.044),
                  green=(0.105, 0.37, 0.067)):
    def wall(to_world, rgb):
        return {"type": "rectangle", "to_world": to_world,
                "bsdf": {"type": "diffuse",
                         "reflectance": {"type": "rgb", "value": list(rgb)}}}
    return {
        "floor": wall(T.rotate([1, 0, 0], -90), white),
        "ceiling": wall(T.translate([0, 2, 0]).rotate([1, 0, 0], 90), white),
        "back": wall(T.translate([0, 1, -1]), white),
        "left": wall(T.translate([-1, 1, 0]).rotate([0, 1, 0], 90), red),
        "right": wall(T.translate([1, 1, 0]).rotate([0, 1, 0], -90), green),
    }


def shape_range(scene, name):
    """(vertex_start, vertex_count) of the shape ``name``."""
    i = list(scene.static.shape_names).index(name)
    return scene.static.vertex_ranges[i]


def translate_shapes(scene, names, offsets):
    """The scene with each shape ``names[i]`` translated by ``offsets[i]``
    (n, 3): one add of the per-shape offsets repeated over each shape's
    vertices (zero for the other shapes), and one ``set_vertices``, so a
    BVH is refit and re-packed once, however many shapes move."""
    index = {nm: i for i, nm in enumerate(scene.static.shape_names)}
    v = scene.vertices
    per_shape = torch.zeros((len(index), 3), dtype=v.dtype, device=v.device)
    rows = torch.tensor([index[nm] for nm in names], device=v.device)
    per_shape = per_shape.index_copy(0, rows, offsets.to(v.dtype))
    counts = torch.tensor([c for _, c in scene.static.vertex_ranges],
                          device=v.device)
    return scene.set_vertices(v + per_shape.repeat_interleave(counts, dim=0))


def translate_shape(scene, name, offset):
    """The scene with the shape ``name`` translated by ``offset``
    (differentiable in it)."""
    return translate_shapes(scene, [name], torch.as_tensor(
        offset, device=scene.vertices.device).reshape(1, 3))


def transform_shape(scene, name, mat4, base_vertices):
    """The scene with the shape ``name``'s vertices replaced by
    ``base_vertices`` transformed by the (4, 4) ``mat4``."""
    s, c = shape_range(scene, name)
    vh = torch.cat([base_vertices, torch.ones_like(base_vertices[:, :1])],
                   -1)
    v2 = torch.sum(vh[:, None, :] * mat4[None, :, :], dim=-1)[:, :3]
    v = scene.vertices.clone()
    v[s:s + c] = v2
    return scene.set_vertices(v)
