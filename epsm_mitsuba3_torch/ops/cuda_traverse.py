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

K2 and K3 walk the tree one lane a ray and test leaves either lane by
lane or warp-wide, 32 triangles of one ray's leaf at a time, one a lane,
whichever a step's leaves make cheaper; on a persistent grid a lane whose
ray is done takes the next one from an atomic counter.  The one-thread-a-
ray walk they replace was held back by both: a lone lane testing the up
to 32 triangles of a fat leaf one after another, and warps waiting for
their longest ray.  They read the triangles as rows padded to 48 bytes
(``kernel_tris``), keep the top ``R`` node records in shared memory
(``shared_records``), and take the launch configuration of ``SCHEDULE``.
K4 and ``closest_hit_reference`` (K2's former walk, kept to time the
redesign against) test each leaf serially in their lane, on the (F, 9)
rows.

Around the launch the rays may be sorted by a 30-bit 6-D Morton key of
origin and direction (``sort_keys``) and the results un-sorted, as the
reference does.  A kernel whose ray would push past its stack sets a flag
on the device instead of faulting; ``raise_on_overflow`` reads it.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
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
#: HBM3, 700 W): K2 0.51 ms unsorted against 5.0 ms sorted, sort
#: included, and 0.50 ms on rays sorted beforehand; K3 0.28, 4.6, 0.29
SORT_RAYS = False

#: ``closest_hit``'s schedule where no caller names one: 0 is K2, 2 or 4
#: is K4 (``pallas_traverse.py`` ``MULTI_POP``, :79); read at each call
MULTI_POP = 0
#: the multi-pop widths K4 is compiled for
K4_WIDTHS = (2, 4)

#: bytes of one node record (32 float32)
RECORD_BYTES = 128
#: the triangle layouts K2/K3 read (``bvh_traverse.cu`` ``Layout``): the
#: (F, 9) rows, or (F, 12) rows padded to 48 bytes
LAYOUTS = {"rows": 0, "pad": 1}


@dataclass(frozen=True)
class Schedule:
    """How K2/K3 are launched: the triangle layout they read and the
    threads a block (each pair one of the kernel's compiled
    configurations); a persistent grid, whose lanes take a new ray from an
    atomic counter when theirs is done, or one warp per 32 rays; the top
    of the tree copied to shared memory or not; and the leaf-phase switch:
    a step's leaves are tested lane by lane when the longest lane's
    triangles are at most ``serial / 8`` times the warp's chunks of 32,
    else warp-wide (0: always warp-wide)."""
    layout: str = "pad"
    threads: int = 1024
    persistent: bool = True
    shared: bool = True
    serial: int = 8


#: the main path's K2/K3 launch
SCHEDULE = Schedule()
#: the design steps, each timed by ``chip_smoke.py``: warp-cooperative
#: leaf tests alone (on the (F, 9) rows, one warp per 32 rays), with the
#: rows padded to 48 bytes, and with the top of the tree in shared memory
#: on a persistent grid whose lanes refill
STEPS = {"1": Schedule("rows", 128, False, False),
         "1+2": Schedule("pad", 128, False, False),
         "1+2+3": SCHEDULE}

#: launches of each kernel entry, counted where the launch happens
launches = {"bvh4_closest_hit": 0, "bvh4_closest_hit_mp": 0,
            "bvh4_any_hit": 0, "bvh4_closest_hit_ref": 0}

_lib = None
_overflow = {}      # device -> int32 flag the kernels set
_budget = {}        # device -> bytes of dynamic shared memory a block


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the K2/K3/K4 library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _native.load(SPEC)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    trace = [ptr, i32, ptr, i32, ptr, ptr, ptr, i32, i32, i32, i32, ptr,
             i32]
    lib.bvh4_closest_hit.argtypes = trace + [ptr] * 7
    lib.bvh4_any_hit.argtypes = trace + [ptr] * 3
    lib.bvh4_closest_hit_mp.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32,
                                        i32, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.bvh4_closest_hit_ref.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32,
                                         ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.bvh4_shared_budget.argtypes = [ctypes.POINTER(i32)]
    for entry in ("bvh4_closest_hit", "bvh4_any_hit", "bvh4_closest_hit_mp",
                  "bvh4_closest_hit_ref", "bvh4_shared_budget"):
        getattr(lib, entry).restype = i32
    _lib = lib
    return lib


def kernel_tris(tri: torch.Tensor, layout: str = SCHEDULE.layout
                ) -> torch.Tensor:
    """The (F, 9) triangle rows in a K2/K3 layout of ``LAYOUTS``: "pad"
    is (F, 12) with zeros after each row, "rows" ``tri`` itself."""
    if layout == "pad":
        return torch.cat([tri, tri.new_zeros(tri.shape[0], 3)], 1)
    if layout == "rows":
        return tri
    raise ValueError(f"K2/K3: no triangle layout {layout!r}")


def pack_bvh4(bvh, vertices: torch.Tensor, faces: torch.Tensor):
    """The kernels' inputs (``pack_scene``, not tiled).

    Returns ``nodes`` (n4, 32) float32, one record a BVH4 node: [0:4]
    child id or leaf start, [4:8] count (-1 empty, 0 inner, > 0 leaf),
    [8 + 6k:14 + 6k] the box (min, max) of child k from its binary node
    ``c4_node``, inverted (+-3e38) for an empty slot; ``tri`` (F, 9) the
    triangles in leaf order, rows [p0, p1 - p0, p2 - p0]; and ``tri_k``,
    the same in K2/K3's layout (``kernel_tris``)."""
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
    return nodes, tri, kernel_tris(tri)


def shared_records(n_records: int, budget: int) -> int:
    """R, the node records a K2/K3 block copies into shared memory: as
    many of the first records as ``budget`` bytes hold.  Records are in
    breadth-first order, so they are the top levels of the tree."""
    return max(0, min(n_records, budget // RECORD_BYTES))


def shared_budget(device) -> int:
    """Bytes of dynamic shared memory a K2/K3 block may take on
    ``device``: the card's opt-in limit less the kernels' static part."""
    if device not in _budget:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            _native.check_launch(build().bvh4_shared_budget(
                ctypes.byref(out)), "bvh4_shared_budget")
        _budget[device] = out.value
    return _budget[device]


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


def _layout_tris(tri_k, layout, device) -> int:
    """The number of triangles in ``tri_k``, checked to be a contiguous
    float32 tensor of ``layout``'s shape on ``device``."""
    n = tri_k.shape[0]
    shape = {"rows": (n, 9), "pad": (n, 12)}[layout]
    if (tuple(tri_k.shape) != shape or tri_k.dtype != torch.float32
            or tri_k.device != device or not tri_k.is_contiguous()):
        raise ValueError(f"K2/K3: the {layout!r} triangles must be a "
                         f"contiguous float32 {shape} tensor on {device}")
    return n


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


def _trace_args(nodes, tri_k, o, d, maxt, schedule, n_shared):
    """The leading arguments of the K2/K3 entries, and the batch counter
    (kept alive by the caller until the launch)."""
    _layout_tris(tri_k, schedule.layout, o.device)
    if n_shared is None:
        n_shared = (shared_records(nodes.shape[0], shared_budget(o.device))
                    if schedule.shared else 0)
    n_shared = min(int(n_shared), nodes.shape[0])
    if n_shared * RECORD_BYTES > shared_budget(o.device):
        raise ValueError(f"K2/K3: {n_shared} records exceed the block's "
                         "shared memory")
    if n_shared > 0 and nodes.data_ptr() % 16 != 0:
        raise ValueError("K2/K3: node records must be 16-byte aligned")
    if schedule.layout == "pad" and tri_k.data_ptr() % 16 != 0:
        raise ValueError("K2/K3: padded triangle rows must be 16-byte "
                         "aligned")
    counter = (torch.zeros(1, dtype=torch.int32, device=o.device)
               if schedule.persistent else None)
    args = (nodes.data_ptr(), n_shared, tri_k.data_ptr(),
            LAYOUTS[schedule.layout], o.data_ptr(), d.data_ptr(),
            maxt.data_ptr(), o.shape[0], _stack_cap(), schedule.threads,
            int(schedule.persistent),
            None if counter is None else counter.data_ptr(), schedule.serial)
    return args, counter


def launch_closest(nodes, tri_k, o, d, maxt, schedule: Schedule = SCHEDULE,
                   n_shared: Optional[int] = None,
                   counts: Optional[torch.Tensor] = None):
    """K2 on CUDA tensors: ``tri_k`` the triangles in ``schedule.layout``;
    ``n_shared`` records in shared memory (``None``: as many as the block
    holds when ``schedule.shared``, else 0); ``counts``, a zeroed (4,)
    int64 tensor, receives the lane utilisation (traversal steps, active
    lanes in them, leaf steps, active lanes in them) from the counting
    build.  Returns (t, slot, u, v) as ``closest_hit``."""
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    slot = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n == 0:
        return t, slot, u, v
    lib = build()
    with torch.cuda.device(o.device):
        args, counter = _trace_args(nodes, tri_k, o, d, maxt, schedule,
                                    n_shared)
        flag = _flag(o.device)
        err = lib.bvh4_closest_hit(
            *args, t.data_ptr(), u.data_ptr(), v.data_ptr(), slot.data_ptr(),
            flag.data_ptr(), None if counts is None else counts.data_ptr(),
            torch.cuda.current_stream(o.device).cuda_stream)
    del counter
    _native.check_launch(err, "bvh4_closest_hit")
    launches["bvh4_closest_hit"] += 1
    return t, slot, u, v


def launch_any(nodes, tri_k, o, d, maxt, schedule: Schedule = SCHEDULE,
               n_shared: Optional[int] = None) -> torch.Tensor:
    """K3 on CUDA tensors, with the arguments of ``launch_closest``."""
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    if n == 0:
        return occ
    lib = build()
    with torch.cuda.device(o.device):
        args, counter = _trace_args(nodes, tri_k, o, d, maxt, schedule,
                                    n_shared)
        flag = _flag(o.device)
        err = lib.bvh4_any_hit(
            *args, occ.data_ptr(), flag.data_ptr(),
            torch.cuda.current_stream(o.device).cuda_stream)
    del counter
    _native.check_launch(err, "bvh4_any_hit")
    launches["bvh4_any_hit"] += 1
    return occ


def _launch_one_thread(nodes, tri, o, d, maxt, multi_pop, counts=None):
    """K4 (``multi_pop`` 2 or 4) or, at 1, the reference: the
    one-thread-a-ray walk on the (F, 9) rows."""
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
                flag.data_ptr())
        if multi_pop > 1:
            entry = "bvh4_closest_hit_mp"
            err = lib.bvh4_closest_hit_mp(*rays, multi_pop, *hits, stream)
        else:
            entry = "bvh4_closest_hit_ref"
            err = lib.bvh4_closest_hit_ref(
                *rays, *hits, None if counts is None else counts.data_ptr(),
                stream)
    _native.check_launch(err, entry)
    launches[entry] += 1
    return t, slot, u, v


def closest_hit(nodes, tri, o, d, maxt, sort: bool = SORT_RAYS,
                multi_pop: Optional[int] = None,
                tri_k: Optional[torch.Tensor] = None):
    """Closest hit of each ray through the BVH4: K2, or K4 with
    ``multi_pop`` in ``K4_WIDTHS``; ``None`` reads ``MULTI_POP``, the one
    place the default is set.  K2 reads ``tri_k``, the triangles in
    ``SCHEDULE.layout`` (``pack_bvh4``'s third output; made from ``tri``
    when not given).

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
    elif multi_pop > 1:
        out = _launch_one_thread(nodes, tri, o, d, maxt, multi_pop)
    else:
        out = launch_closest(nodes, kernel_tris(tri) if tri_k is None
                             else tri_k, o, d, maxt)
    return tuple(_unsort(x, perm) for x in out) if sort else out


def closest_hit_reference(nodes, tri, o, d, maxt,
                          counts: Optional[torch.Tensor] = None):
    """K2's former one-thread-a-ray walk (K4's kernel at P = 1), kept to
    time the redesign against; never on the main path.  ``counts`` as
    ``launch_closest``'s.  Returns ``closest_hit``'s outputs."""
    _check(nodes, tri, o, d, maxt)
    if o.device.type == "cpu":
        return T.bvh_ray_intersect_plain(nodes, tri, o, d, maxt)
    return _launch_one_thread(nodes, tri, o, d, maxt, 1, counts)


def any_hit(nodes, tri, o, d, maxt, sort: bool = SORT_RAYS,
            tri_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Occlusion: (N,) bool, True where some triangle passes the closest
    hit's test; equals ``closest_hit``'s ``slot >= 0``.  ``tri_k`` as
    ``closest_hit``'s."""
    _check(nodes, tri, o, d, maxt)
    if sort:
        perm = _morton_order(nodes, o, d, maxt)
        o, d, maxt = o[perm], d[perm], maxt[perm]
    if o.device.type == "cpu":
        occ = T.bvh_ray_test_plain(nodes, tri, o, d, maxt)
    else:
        occ = launch_any(nodes, kernel_tris(tri) if tri_k is None else tri_k,
                         o, d, maxt)
    return _unsort(occ, perm) if sort else occ
