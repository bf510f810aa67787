"""Procedural shapes as triangle meshes (counterpart of
``models/shapes.py``): the rectangle, the cube, the disk, the
tessellated UV sphere and the open cylinder."""
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


def disk(segments: int = 32):
    """Unit disk on the XY plane (disk.cpp): a triangle fan around the
    origin."""
    ang = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    rim = np.stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)], -1)
    v = np.concatenate([np.zeros((1, 3)), rim], axis=0).astype(np.float32)
    f = np.asarray(
        [[0, 1 + i, 1 + (i + 1) % segments] for i in range(segments)],
        np.int32)
    n = np.tile(np.array([[0, 0, 1]], np.float32), (len(v), 1))
    return {"vertices": v, "faces": f, "normals": n}


def sphere(radius: float = 1.0, center=(0.0, 0.0, 0.0), subdiv: int = 32):
    """UV sphere (sphere.cpp's analytic shape as a mesh): ``subdiv``
    rings of latitude, 2 ``subdiv`` segments of longitude, each pole a
    row of coincident vertices; 3,968 faces and 2,112 vertices at
    ``subdiv`` 32.  Built in float64 and cast to float32, as the
    reference builds it."""
    lat, lon = subdiv, subdiv * 2
    theta = np.linspace(0.0, np.pi, lat + 1)
    phi = np.linspace(0.0, 2.0 * np.pi, lon, endpoint=False)
    t, p = np.meshgrid(theta, phi, indexing="ij")
    pts = np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p),
                    np.cos(t)], -1).reshape(-1, 3)
    v = (pts * radius + np.asarray(center, np.float32)).astype(np.float32)
    i, j = np.meshgrid(np.arange(lat), np.arange(lon), indexing="ij")
    a, b = i * lon + j, i * lon + (j + 1) % lon
    c, d = (i + 1) * lon + (j + 1) % lon, (i + 1) * lon + j
    # per quad [a, b, c] (not on the top ring), then [a, c, d] (not on
    # the bottom ring), quads in row-major order
    upper = np.stack([a, b, c], -1)
    lower = np.stack([a, c, d], -1)
    quads = np.stack([upper, lower], 2)                  # (lat, lon, 2, 3)
    keep = np.stack([np.broadcast_to(i > 0, i.shape),
                     np.broadcast_to(i < lat - 1, i.shape)], -1)
    faces = quads[keep].astype(np.int32)
    return {"vertices": v, "faces": faces, "normals": pts.astype(np.float32)}


def cylinder(radius: float = 1.0, segments: int = 32):
    """Open cylinder along +Z, z in [0, 1] (cylinder.cpp)."""
    ang = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    ring = np.stack([radius * np.cos(ang), radius * np.sin(ang)], -1)
    v0 = np.concatenate([ring, np.zeros((segments, 1))], -1)
    v1 = np.concatenate([ring, np.ones((segments, 1))], -1)
    v = np.concatenate([v0, v1], axis=0).astype(np.float32)
    n = np.concatenate(
        [np.concatenate([ring / radius, np.zeros((segments, 1))], -1)] * 2,
        0).astype(np.float32)
    faces = []
    for i in range(segments):
        j = (i + 1) % segments
        faces.append([i, j, segments + j])
        faces.append([segments + j, segments + i, i])
    return {"vertices": v, "faces": np.asarray(faces, np.int32),
            "normals": n}
