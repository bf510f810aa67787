"""Kernel K1: brute-force ray-triangle intersection, written in CUDA C++
for Hopper (counterpart of ``ops/pallas_intersect.py``).

``closest_hit`` and ``any_hit`` take the packed triangles of
``pack_tris`` and the rays.  On CUDA tensors they launch the kernels of
``csrc/mt_intersect.cu``, which are built with ``nvcc`` at first use into
``_build/`` (keyed by a hash of the source and flags) and loaded with
``ctypes``.  On CPU tensors they run the plain versions,
``ops/intersect.py`` ``ray_intersect_brute`` / ``ray_test_brute``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from . import intersect as I

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "mt_intersect.cu"
BUILD_DIR = _PKG / "_build"
#: --fmad=false keeps each multiply and add rounded on its own, as in the
#: plain version; -Xptxas=-v reports registers and shared memory
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")

#: launches of each kernel entry, counted where the launch happens
launches = {"mt_closest_hit": 0, "mt_any_hit": 0}

#: compiler output of the build in this process (registers, spills)
build_log = ""

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: K1 builds with the CUDA toolkit")
    return path


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the K1 library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"libmt_intersect_{key[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                              str(SOURCE)], capture_output=True, text=True)
        build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{build_log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
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


def _check(tri, o, d, maxt):
    n = o.shape[0] if o.dim() == 2 else -1
    for name, x, shape in (("tri", tri, (tri.shape[0], 9)),
                           ("o", o, (n, 3)), ("d", d, (n, 3)),
                           ("maxt", maxt, (n,))):
        if tuple(x.shape) != shape:
            raise ValueError(f"K1: {name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if x.dtype != torch.float32:
            raise TypeError(f"K1: {name} is {x.dtype}, expected float32")
        if x.device != o.device:
            raise ValueError(f"K1: {name} is on {x.device}, rays on "
                             f"{o.device}")
        if not x.is_contiguous():
            raise ValueError(f"K1: {name} is not contiguous")
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K1: unsupported device {o.device}")
    if tri.shape[0] >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError("K1: more than 2^31 - 1 rays or triangles")


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"K1 {name}: CUDA error {err} at launch")


def closest_hit(tri, o, d, maxt):
    """Closest hit of each ray against every triangle.

    Returns (t (N,) +inf on a miss, prim (N,) int32 -1 on a miss,
    u, v (N,) 0 on a miss)."""
    _check(tri, o, d, maxt)
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
    _raise_on(err, "mt_closest_hit")
    launches["mt_closest_hit"] += 1
    return t, prim, u, v


def any_hit(tri, o, d, maxt) -> torch.Tensor:
    """Occlusion: (N,) bool, True where some triangle passes the
    closest-hit test; equals ``closest_hit``'s ``prim >= 0``."""
    _check(tri, o, d, maxt)
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
    _raise_on(err, "mt_any_hit")
    launches["mt_any_hit"] += 1
    return occ
