"""Kernels K2, K4 and K3: BVH4 closest-hit (single- and multi-pop) and
any-hit traversal, written in CUDA C++ for Hopper (counterpart of
``ops/pallas_traverse.py``).

``pack_bvh4`` packs a scene's BVH into the kernels' inputs once at load.
``closest_hit`` and ``any_hit`` take those and the rays.  On CUDA tensors
they launch the kernels of ``csrc/bvh_traverse.cu``, built with ``nvcc``
at first use into ``_build/`` by ``ops/_native.py`` and loaded with
``ctypes``.  On CPU tensors they run the plain versions,
``ops/traverse.py`` ``bvh_ray_intersect_plain`` / ``bvh_ray_test_plain``.
``closest_hit``'s ``multi_pop`` picks the schedule: 0 or 1 is K2, 2 or 4
is K4 popping that many stack entries an iteration.

Around the launch the rays may be sorted by a 30-bit 6-D Morton key of
origin and direction (``sort_keys``) and the results un-sorted, as the
reference does.  A kernel whose ray would push past its stack sets a flag
on the device instead of faulting; ``raise_on_overflow`` reads it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _native
from . import cuda_intersect as CI
from . import traverse as T

SPEC = _native.Spec(
    name="bvh_traverse",
    source=_native.PKG / "csrc" / "bvh_traverse.cu",
    headers=(_native.PKG / "csrc" / "mt_test.cuh",),
    compiler="nvcc", flags=_native.NVCC_FLAGS)

#: the kernels' compiled-in stack size; ``traverse.STACK_SIZE`` may set a
#: smaller limit at run time
MAX_STACK = 64

#: whether ``closest_hit`` / ``any_hit`` Morton-sort the rays by default.
#: Set from ``chip_smoke.py`` on the main path's 2^21 rays (H100 80GB
#: HBM3, 700 W): K2 1.29 ms unsorted against 3.88 ms sorted, sort
#: included, and 1.16 ms on rays sorted beforehand; K3 0.57, 3.55, 0.60
SORT_RAYS = False

#: ``closest_hit``'s schedule where no caller names one: 0 is K2, 2 or 4
#: is K4 (``pallas_traverse.py`` ``MULTI_POP``, :79); read at each call
MULTI_POP = 0
#: the multi-pop widths K4 is compiled for
K4_WIDTHS = (2, 4)

#: launches of each kernel entry, counted where the launch happens
launches = {"bvh4_closest_hit": 0, "bvh4_closest_hit_mp": 0,
            "bvh4_any_hit": 0}

_lib = None
_overflow = {}      # device -> int32 flag the kernels set


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the K2/K3 library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _native.load(SPEC)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bvh4_closest_hit.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32,
                                     ptr, ptr, ptr, ptr, ptr, ptr]
    lib.bvh4_closest_hit.restype = i32
    lib.bvh4_closest_hit_mp.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32,
                                        i32, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.bvh4_closest_hit_mp.restype = i32
    lib.bvh4_any_hit.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, ptr,
                                 ptr, ptr]
    lib.bvh4_any_hit.restype = i32
    _lib = lib
    return lib


def pack_bvh4(bvh, vertices: torch.Tensor, faces: torch.Tensor):
    """The kernels' inputs (``pack_scene``, not tiled).

    Returns ``nodes`` (n4, 32) float32, one record a BVH4 node: [0:4]
    child id or leaf start, [4:8] count (-1 empty, 0 inner, > 0 leaf),
    [8 + 6k:14 + 6k] the box (min, max) of child k from its binary node
    ``c4_node``, inverted (+-3e38) for an empty slot; and ``tri`` (F, 9)
    the triangles in leaf order, rows [p0, p1 - p0, p2 - p0]."""
    if faces.shape[0] >= 2 ** 24:
        raise ValueError("pack_bvh4: ids are stored as float32, exact "
                         "below 2^24 triangles")
    node = bvh.c4_node.long()
    empty = (bvh.c4_cnt < 0)[..., None]
    bmin = torch.where(empty, 3e38, bvh.bmin[node])
    bmax = torch.where(empty, -3e38, bvh.bmax[node])
    boxes = torch.cat([bmin, bmax], dim=-1).reshape(-1, 24)
    nodes = torch.cat([bvh.c4_id.float(), bvh.c4_cnt.float(), boxes],
                      dim=-1).contiguous()
    tri = CI.pack_tris(vertices, faces[bvh.order.long()])
    return nodes, tri


def sort_keys(o, d, bmin, bmax, maxt=None) -> torch.Tensor:
    """Coherence keys (``sort_keys``, "interleave" mode): a 30-bit 6-D
    Morton code, origin and direction bits alternating from coarse to
    fine, 5 bits an axis each; rays with maxt <= 1e-6 get 0xFFFFFFFF.
    uint32 values carried in int64."""
    ext = torch.clamp(bmax - bmin, min=1e-6)
    qo = (torch.clamp((o - bmin) / ext, 0.0, 1.0) * 31.0).long()
    qd = (torch.clamp(d * 0.5 + 0.5, 0.0, 1.0) * 31.0).long()
    key = torch.zeros(o.shape[:-1], dtype=torch.int64, device=o.device)
    for b in range(4, -1, -1):
        for q in (qo, qd):
            for a in range(3):
                key = (key << 1) | ((q[:, a] >> b) & 1)
    if maxt is not None:
        key = torch.where(maxt > 1e-6, key, 0xFFFFFFFF)
    return key


def _morton_order(nodes, o, d, maxt):
    """The permutation that sorts the rays by ``sort_keys``, with the
    scene box taken from the root record's child boxes."""
    b = nodes[0, 8:32].reshape(4, 6)
    keys = sort_keys(o, d, b[:, 0:3].amin(0), b[:, 3:6].amax(0), maxt)
    return torch.sort(keys, stable=True).indices


def _unsort(x, perm):
    out = torch.empty_like(x)
    out[perm] = x
    return out


def _check(nodes, tri, o, d, maxt):
    CI.check_inputs("K2/K3", o, d, maxt, nodes=(nodes, 32), tri=(tri, 9))
    if nodes.shape[0] == 0 or tri.shape[0] >= 2 ** 24:
        raise ValueError("K2/K3: no nodes, or 2^24 triangles or more")


def _stack_cap() -> int:
    if not 1 <= T.STACK_SIZE <= MAX_STACK:
        raise ValueError(f"K2/K3: stack size {T.STACK_SIZE} outside "
                         f"[1, {MAX_STACK}]")
    return T.STACK_SIZE


def _flag(device) -> torch.Tensor:
    if device not in _overflow:
        _overflow[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _overflow[device]


def raise_on_overflow(device) -> None:
    """Raise ``traverse.StackOverflow`` if a K2/K3/K4 launch on ``device``
    ran out of stack since the last call, and clear the flag.  Waits for
    the device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    flag = _overflow.get(device)
    if flag is not None and int(flag.item()) != 0:
        flag.zero_()
        raise T.StackOverflow(
            f"a ray's BVH traversal on {device} needed more than "
            f"{T.STACK_SIZE} stack entries: its hits are incomplete")


def _launch_closest(nodes, tri, o, d, maxt, multi_pop):
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    slot = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n == 0:
        return t, slot, u, v
    lib = build()
    cap = _stack_cap()
    with torch.cuda.device(o.device):
        flag = _flag(o.device)
        stream = torch.cuda.current_stream(o.device).cuda_stream
        rays = (nodes.data_ptr(), tri.data_ptr(), o.data_ptr(),
                d.data_ptr(), maxt.data_ptr(), n, cap)
        hits = (t.data_ptr(), u.data_ptr(), v.data_ptr(), slot.data_ptr(),
                flag.data_ptr(), stream)
        if multi_pop > 1:
            entry = "bvh4_closest_hit_mp"
            err = lib.bvh4_closest_hit_mp(*rays, multi_pop, *hits)
        else:
            entry = "bvh4_closest_hit"
            err = lib.bvh4_closest_hit(*rays, *hits)
    _native.check_launch(err, entry)
    launches[entry] += 1
    return t, slot, u, v


def _launch_any(nodes, tri, o, d, maxt):
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    if n == 0:
        return occ
    lib = build()
    cap = _stack_cap()
    with torch.cuda.device(o.device):
        flag = _flag(o.device)
        stream = torch.cuda.current_stream(o.device).cuda_stream
        err = lib.bvh4_any_hit(
            nodes.data_ptr(), tri.data_ptr(), o.data_ptr(), d.data_ptr(),
            maxt.data_ptr(), n, cap, occ.data_ptr(), flag.data_ptr(),
            stream)
    _native.check_launch(err, "bvh4_any_hit")
    launches["bvh4_any_hit"] += 1
    return occ


def closest_hit(nodes, tri, o, d, maxt, sort: bool = SORT_RAYS,
                multi_pop: Optional[int] = None):
    """Closest hit of each ray through the BVH4: K2, or K4 with
    ``multi_pop`` in ``K4_WIDTHS``; ``None`` reads ``MULTI_POP``, the one
    place the default is set.  K4 finds K2's closest t; of two triangles
    at the same t it may keep the other one.

    Returns (t (N,) +inf on a miss, slot (N,) int32 row of ``tri``, -1 on
    a miss, u, v (N,) 0 on a miss)."""
    _check(nodes, tri, o, d, maxt)
    if multi_pop is None:
        multi_pop = MULTI_POP
    if multi_pop > 1 and multi_pop not in K4_WIDTHS:
        raise ValueError(f"K4: multi_pop {multi_pop} is not one of "
                         f"{K4_WIDTHS} (0 or 1 is K2)")
    if sort:
        perm = _morton_order(nodes, o, d, maxt)
        o, d, maxt = o[perm], d[perm], maxt[perm]
    if o.device.type == "cpu":
        out = T.bvh_ray_intersect_plain(nodes, tri, o, d, maxt,
                                        multi_pop=multi_pop)
    else:
        out = _launch_closest(nodes, tri, o, d, maxt, multi_pop)
    return tuple(_unsort(x, perm) for x in out) if sort else out


def any_hit(nodes, tri, o, d, maxt, sort: bool = SORT_RAYS) -> torch.Tensor:
    """Occlusion: (N,) bool, True where some triangle passes the closest
    hit's test; equals ``closest_hit``'s ``slot >= 0``."""
    _check(nodes, tri, o, d, maxt)
    if sort:
        perm = _morton_order(nodes, o, d, maxt)
        o, d, maxt = o[perm], d[perm], maxt[perm]
    if o.device.type == "cpu":
        occ = T.bvh_ray_test_plain(nodes, tri, o, d, maxt)
    else:
        occ = _launch_any(nodes, tri, o, d, maxt)
    return _unsort(occ, perm) if sort else occ
