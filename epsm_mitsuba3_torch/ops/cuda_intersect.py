"""Kernel K1: brute-force ray-triangle intersection, written in CUDA C++
for Hopper (counterpart of ``ops/pallas_intersect.py``).

``closest_hit`` and ``any_hit`` take the packed triangles of
``pack_tris``, (F, 12) rows of 48 bytes, and the rays.  On CUDA tensors
they launch the kernels of ``csrc/mt_intersect.cu``, which are built with
``nvcc`` at first use into ``_build/`` by ``ops/_native.py`` and loaded
with ``ctypes``.  On CPU tensors they run the plain versions,
``ops/intersect.py`` ``ray_intersect_brute`` / ``ray_test_brute``.

A block walks the table in tiles of up to ``TILE_ROWS`` rows in shared
memory (``tile_rows``); a thread tests R rays against each row it reads,
or S lanes split a ray's rows; the any hit stops each ray at its first
hit, lane by lane or warp-wide.  ``launch_rule`` picks the launch from
the triangle and ray counts; ``STEPS`` are the launches it picks among,
which ``chip_smoke.py`` times.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from . import _native
from . import intersect as I

SPEC = _native.Spec(
    name="mt_intersect",
    source=_native.PKG / "csrc" / "mt_intersect.cu",
    headers=(_native.PKG / "csrc" / "mt_test.cuh",),
    compiler="nvcc", flags=_native.NVCC_FLAGS)

#: bytes of one packed triangle row, (F, 12) float32
ROW_BYTES = 48
#: the (R rays, S lanes a group) pairs compiled for the closest hit, the R
#: of the "lanes" any hit and the rows a lane tests a step in the "warp"
#: any hit (``mt_intersect.cu`` EPSM_K1_CONFIGS, _LANES_RAYS, _WARP_ROWS)
CONFIGS = ((2, 1), (4, 1), (4, 8))
LANES_RAYS = (4,)
WARP_ROWS = (1, 2)
#: the any hit's schedules: each thread stops once its R rays have hit;
#: or the warp tests 32 x ``rows`` rows of one ray at a time
ANY_MODES = {"lanes": 0, "warp": 1}
#: rows a block holds at once: 1,024 rows (48 KB) leave room for four
#: blocks an SM, where the whole 4,096-row table would allow one
TILE_ROWS = 1024


@dataclass(frozen=True)
class Launch:
    """How K1 is launched: R rays for each group of S lanes, which split
    the rows among them (S > 1: the closest hit only); the any hit's
    schedule (``ANY_MODES``) and, warp-wide, the rows a lane tests a step;
    and ``tile``, the most rows a block holds in shared memory at once."""
    rays: int = 1
    split: int = 1
    any: str = "lanes"
    rows: int = 1
    tile: int = TILE_ROWS


#: the launches ``launch_rule`` picks among, by the design step each came
#: from (``chip_smoke.py`` times each): R rays a thread, or the rows of R
#: rays split among 8 lanes (2); the any hit warp-wide, 32 or 64 rows of a
#: ray at a time (3)
STEPS = {
    "2 R=2": Launch(2),
    "2 R=4": Launch(4),
    "2 R=4 S=8": Launch(4, 8),
    "3 warp": Launch(1, any="warp"),
    "3 warp 2 rows": Launch(1, any="warp", rows=2),
}


def _fits(v: Launch, kind: str) -> bool:
    """Whether ``v`` names a compiled launch of ``kind``."""
    if kind == "closest":
        return v.any == "lanes" and (v.rays, v.split) in CONFIGS
    if v.any == "lanes":
        return v.split == 1 and v.rays in LANES_RAYS
    return (v.any == "warp" and v.rays == 1 and v.split == 1
            and v.rows in WARP_ROWS)


#: the steps that are closest-hit launches, and those of the any hit
CLOSEST_STEPS = tuple(k for k, v in STEPS.items() if _fits(v, "closest"))
ANY_STEPS = tuple(k for k, v in STEPS.items() if _fits(v, "any"))

#: from this many rays on (128 blocks of R = 4 x 256 rays, about one an SM
#: of the H100) the closest hit takes R = 4 rays a thread at any triangle
#: count, and the warp-wide any hit 32 rows a step (``chip_smoke.py``
#: ``k1_rule_sweep``, 12-4,096 rows x 2^16-2^21 rays; ``PERF.md`` §6)
FULL_RAYS = 2 ** 17
#: with fewer rays: the closest hit splits each ray's rows among 8 lanes
#: from SPLIT_MIN_TRIS rows on, and the warp-wide any hit tests 64 rows a
#: step from WIDE_MIN_TRIS on; the any hit goes warp-wide from
#: WARP_MIN_TRIS rows on at any ray count
SPLIT_MIN_TRIS = 128
WIDE_MIN_TRIS = 1024
WARP_MIN_TRIS = 64


def launch_rule(n_tris: int, n_rays: int, kind: str = "closest") -> Launch:
    """The main path's launch of ``kind`` ("closest" or "any") against
    ``n_tris`` rows for ``n_rays`` rays, values every lane shares, so the
    choice is launch-wide.  From FULL_RAYS rays on, the closest hit takes
    R = 4 rays a thread; with fewer, R = 2, or from SPLIT_MIN_TRIS rows on
    R = 4 for each 8 lanes, which split the rows.  The any hit takes R = 4
    rays a thread below WARP_MIN_TRIS rows, else tests a ray's rows
    warp-wide, 32 at a time, or 64 with fewer than FULL_RAYS rays and from
    WIDE_MIN_TRIS rows on."""
    full = n_rays >= FULL_RAYS
    if kind == "any":
        if n_tris < WARP_MIN_TRIS:
            return Launch(4)
        wide = not full and n_tris >= WIDE_MIN_TRIS
        return Launch(1, any="warp", rows=2 if wide else 1)
    if full:
        return Launch(4)
    return Launch(4, 8) if n_tris >= SPLIT_MIN_TRIS else Launch(2)


def tile_rows(n_tris: int, budget: int, tile: int = TILE_ROWS) -> int:
    """Rows a K1 block holds in shared memory: at most ``tile``, as many
    as ``budget`` bytes hold, and no more than the table's ``n_tris``."""
    rows = budget // ROW_BYTES
    if rows < 1:
        raise ValueError(f"K1: a shared-memory budget of {budget} B holds "
                         "no triangle row")
    return min(n_tris, rows, tile)


#: launches of each kernel entry, counted where the launch happens
launches = {"mt_closest_hit": 0, "mt_any_hit": 0}

_lib = None
_budget = {}        # device -> bytes of dynamic shared memory a block


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the K1 library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _native.load(SPEC)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    rays = [ptr, i32, i32, ptr, ptr, ptr, i32]
    lib.mt_closest_hit.argtypes = rays + [i32, i32] + [ptr] * 5
    lib.mt_any_hit.argtypes = rays + [i32, i32] + [ptr] * 2
    lib.mt_shared_budget.argtypes = [ctypes.POINTER(i32)]
    for entry in ("mt_closest_hit", "mt_any_hit", "mt_shared_budget"):
        getattr(lib, entry).restype = i32
    _lib = lib
    return lib


def shared_budget(device) -> int:
    """Bytes of dynamic shared memory a K1 block may take on ``device``."""
    if device not in _budget:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            _native.check_launch(build().mt_shared_budget(
                ctypes.byref(out)), "mt_shared_budget")
        _budget[device] = out.value
    return _budget[device]


def pack_tris(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(F, 12) float32 rows [p0, p1 - p0, p2 - p0, 0, 0, 0]
    (``_pack_tris``), 48 bytes a row: three 16-byte loads."""
    f = faces.long()
    p0, p1, p2 = (vertices[f[:, k]] for k in range(3))
    return torch.cat([p0, p1 - p0, p2 - p0, p0.new_zeros(f.shape[0], 3)],
                     dim=-1).contiguous()


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


def _prepare(tri, o, kind, launch):
    """The launch (``launch_rule``'s where not given), the rows a block
    holds at once, and the checks common to both entries."""
    n_tris = tri.shape[0]
    if launch is None:
        launch = launch_rule(n_tris, o.shape[0], kind)
    tile = tile_rows(n_tris, shared_budget(o.device), launch.tile)
    if tri.data_ptr() % 16 != 0:
        raise ValueError("K1: triangle rows must be 16-byte aligned")
    if o.shape[0] > 2 ** 30:
        raise ValueError("K1: more than 2^30 rays in a launch")
    if not _fits(launch, kind):
        raise ValueError(f"K1: the {kind} hit has no compiled launch "
                         f"{launch}")
    return launch, tile


def launch_closest(tri, o, d, maxt, launch: Optional[Launch] = None):
    """K1's closest hit on CUDA tensors with ``launch`` (default
    ``launch_rule``'s).  Returns ``closest_hit``'s outputs."""
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    prim = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n == 0 or tri.shape[0] == 0:
        t.fill_(float("inf"))
        prim.fill_(-1)
        u.zero_()
        v.zero_()
        return t, prim, u, v
    lib = build()
    with torch.cuda.device(o.device):
        launch, tile = _prepare(tri, o, "closest", launch)
        err = lib.mt_closest_hit(
            tri.data_ptr(), tri.shape[0], tile, o.data_ptr(), d.data_ptr(),
            maxt.data_ptr(), n, launch.rays, launch.split, t.data_ptr(),
            prim.data_ptr(), u.data_ptr(), v.data_ptr(),
            torch.cuda.current_stream(o.device).cuda_stream)
    _native.check_launch(err, "mt_closest_hit")
    launches["mt_closest_hit"] += 1
    return t, prim, u, v


def launch_any(tri, o, d, maxt, launch: Optional[Launch] = None
               ) -> torch.Tensor:
    """K1's any hit on CUDA tensors, with the arguments of
    ``launch_closest``."""
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    if n == 0 or tri.shape[0] == 0:
        return occ.zero_()
    lib = build()
    with torch.cuda.device(o.device):
        launch, tile = _prepare(tri, o, "any", launch)
        err = lib.mt_any_hit(
            tri.data_ptr(), tri.shape[0], tile, o.data_ptr(), d.data_ptr(),
            maxt.data_ptr(), n, ANY_MODES[launch.any],
            launch.rays if launch.any == "lanes" else launch.rows,
            occ.data_ptr(), torch.cuda.current_stream(o.device).cuda_stream)
    _native.check_launch(err, "mt_any_hit")
    launches["mt_any_hit"] += 1
    return occ


def closest_hit(tri, o, d, maxt):
    """Closest hit of each ray against every triangle.

    Returns (t (N,) +inf on a miss, prim (N,) int32 -1 on a miss,
    u, v (N,) 0 on a miss)."""
    check_inputs("K1", o, d, maxt, tri=(tri, 12))
    if o.device.type == "cpu":
        return I.ray_intersect_brute(tri, o, d, maxt)
    return launch_closest(tri, o, d, maxt)


def any_hit(tri, o, d, maxt) -> torch.Tensor:
    """Occlusion: (N,) bool, True where some triangle passes the
    closest-hit test; equals ``closest_hit``'s ``prim >= 0``."""
    check_inputs("K1", o, d, maxt, tri=(tri, 12))
    if o.device.type == "cpu":
        return I.ray_test_brute(tri, o, d, maxt)
    return launch_any(tri, o, d, maxt)
