"""Procedural shapes as triangle meshes (counterpart of
``models/shapes.py``): the rectangle and the cube."""
from __future__ import annotations

import numpy as np


def rectangle():
    """Unit rectangle on the XY plane, z=0, spanning [-1,1]^2."""
    v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                 np.float32)
    f = np.array([[0, 1, 2], [2, 3, 0]], np.int32)
    n = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return {"vertices": v, "faces": f, "normals": n, "uvs": uv}


def cube():
    """Axis-aligned cube spanning [-1,1]^3 with outward normals."""
    verts, faces, normals = [], [], []
    axes = [
        ((0, 0, 1), (1, 0, 0), (0, 1, 0)),   # +z
        ((0, 0, -1), (0, 1, 0), (1, 0, 0)),  # -z
        ((1, 0, 0), (0, 1, 0), (0, 0, 1)),   # +x
        ((-1, 0, 0), (0, 0, 1), (0, 1, 0)),  # -x
        ((0, 1, 0), (0, 0, 1), (1, 0, 0)),   # +y
        ((0, -1, 0), (1, 0, 0), (0, 0, 1)),  # -y
    ]
    for n, u, v in axes:
        n = np.array(n, np.float32)
        u = np.array(u, np.float32)
        v = np.array(v, np.float32)
        base = len(verts)
        for su, sv in [(-1, -1), (1, -1), (1, 1), (-1, 1)]:
            verts.append(n + su * u + sv * v)
            normals.append(n)
        faces.append([base, base + 1, base + 2])
        faces.append([base + 2, base + 3, base])
    return {
        "vertices": np.asarray(verts, np.float32),
        "faces": np.asarray(faces, np.int32),
        "normals": np.asarray(normals, np.float32),
    }
