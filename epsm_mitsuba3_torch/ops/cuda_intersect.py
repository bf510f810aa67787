"""Kernel K1: brute-force ray-triangle intersection, written in CUDA C++
for Hopper (counterpart of ``ops/pallas_intersect.py``).

``closest_hit`` and ``any_hit`` take the packed triangles of
``pack_tris`` and the rays.  On CUDA tensors they launch the kernels of
``csrc/mt_intersect.cu``, which are built with ``nvcc`` at first use into
``_build/`` by ``ops/_native.py`` and loaded with ``ctypes``.  On CPU
tensors they run the plain versions, ``ops/intersect.py``
``ray_intersect_brute`` / ``ray_test_brute``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _native
from . import intersect as I

SPEC = _native.Spec(
    name="mt_intersect",
    source=_native.PKG / "csrc" / "mt_intersect.cu",
    headers=(_native.PKG / "csrc" / "mt_test.cuh",),
    compiler="nvcc", flags=_native.NVCC_FLAGS)

#: launches of each kernel entry, counted where the launch happens
launches = {"mt_closest_hit": 0, "mt_any_hit": 0}

_lib = None


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the K1 library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _native.load(SPEC)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mt_closest_hit.argtypes = [ptr, i32, ptr, ptr, ptr, i32,
                                   ptr, ptr, ptr, ptr, ptr]
    lib.mt_closest_hit.restype = i32
    lib.mt_any_hit.argtypes = [ptr, i32, ptr, ptr, ptr, i32, ptr, ptr]
    lib.mt_any_hit.restype = i32
    _lib = lib
    return lib


def pack_tris(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(F, 9) float32 rows [p0, p1 - p0, p2 - p0] (``_pack_tris``)."""
    f = faces.long()
    p0, p1, p2 = (vertices[f[:, k]] for k in range(3))
    return torch.cat([p0, p1 - p0, p2 - p0], dim=-1).contiguous()


def check_inputs(kernel: str, o, d, maxt, **tables):
    """Raise unless the rays ``o``, ``d`` (N, 3), ``maxt`` (N,) and each
    table ``name=(tensor, columns)`` are float32, contiguous, of those
    shapes and on one device (the CPU or a GPU)."""
    n = o.shape[0] if o.dim() == 2 else -1
    arrays = [(name, x, (x.shape[0], cols))
              for name, (x, cols) in tables.items()]
    arrays += [("o", o, (n, 3)), ("d", d, (n, 3)), ("maxt", maxt, (n,))]
    for name, x, shape in arrays:
        if tuple(x.shape) != shape:
            raise ValueError(f"{kernel}: {name} has shape "
                             f"{tuple(x.shape)}, expected {shape}")
        if x.dtype != torch.float32:
            raise TypeError(f"{kernel}: {name} is {x.dtype}, expected "
                            "float32")
        if x.device != o.device:
            raise ValueError(f"{kernel}: {name} is on {x.device}, rays on "
                             f"{o.device}")
        if not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {o.device}")
    if max(x.shape[0] for _, x, _ in arrays) >= 2 ** 31:
        raise ValueError(f"{kernel}: more than 2^31 - 1 rays or rows")


def closest_hit(tri, o, d, maxt):
    """Closest hit of each ray against every triangle.

    Returns (t (N,) +inf on a miss, prim (N,) int32 -1 on a miss,
    u, v (N,) 0 on a miss)."""
    check_inputs("K1", o, d, maxt, tri=(tri, 9))
    if o.device.type == "cpu":
        return I.ray_intersect_brute(tri, o, d, maxt)
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    prim = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n == 0:
        return t, prim, u, v
    lib = build()
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        err = lib.mt_closest_hit(tri.data_ptr(), tri.shape[0], o.data_ptr(),
                                 d.data_ptr(), maxt.data_ptr(), n,
                                 t.data_ptr(), prim.data_ptr(), u.data_ptr(),
                                 v.data_ptr(), stream)
    _native.check_launch(err, "mt_closest_hit")
    launches["mt_closest_hit"] += 1
    return t, prim, u, v


def any_hit(tri, o, d, maxt) -> torch.Tensor:
    """Occlusion: (N,) bool, True where some triangle passes the
    closest-hit test; equals ``closest_hit``'s ``prim >= 0``."""
    check_inputs("K1", o, d, maxt, tri=(tri, 9))
    if o.device.type == "cpu":
        return I.ray_test_brute(tri, o, d, maxt)
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    if n == 0:
        return occ
    lib = build()
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        err = lib.mt_any_hit(tri.data_ptr(), tri.shape[0], o.data_ptr(),
                             d.data_ptr(), maxt.data_ptr(), n,
                             occ.data_ptr(), stream)
    _native.check_launch(err, "mt_any_hit")
    launches["mt_any_hit"] += 1
    return occ
