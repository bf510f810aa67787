"""BVH construction on the host (counterpart of ``ops/bvh.py``).

The binary tree is built by the binned-SAH builder ``native/bvh.cpp``,
compiled from the checkout with ``g++`` into ``_build/`` at first use
(``ops/_native.py``) and called through ``ctypes``; a missing compiler
or a failed build raises.  ``build(..., builder="numpy")`` takes the
reference's median-split builder ``_build_numpy`` instead, with the same
layout and another tree; only that argument reaches it, never a failed
native build.  ``collapse4`` turns the binary tree into the
4-wide topology with fat leaves that kernels K2/K3 traverse, and
``refit`` recomputes the node boxes bottom-up when vertices move.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, replace
from typing import Mapping

import numpy as np
import torch

from . import _native

#: triangles per leaf of the binary tree (``refit`` relies on it)
LEAF_SIZE = 4
#: fat-leaf width of the collapsed BVH4 (the reference's ``MAX_LEAF4``)
MAX_LEAF4 = 32

SPEC = _native.Spec(name="bvh", source=_native.REPO / "native" / "bvh.cpp",
                    compiler="g++", flags=_native.GXX_FLAGS)

#: the fields of ``BVH`` that are arrays, in the reference's names
ARRAY_FIELDS = ("bmin", "bmax", "meta", "order", "levels", "c4_id",
                "c4_cnt", "c4_node")

_lib = None


@dataclass(frozen=True)
class BVH:
    """Flat BVH arrays.  ``meta``: (n, 4) int32 [left | start, right |
    count, is_leaf, parent]; ``order``: (F,) triangle ids in leaf order;
    ``levels``: (n,) depth of each node.  ``c4_*``: (n4, 4) int32 BVH4
    topology: per child ``c4_cnt`` is -1 (empty), 0 (inner, ``c4_id`` is
    the BVH4 child) or the leaf's triangle count (``c4_id`` is its first
    slot in ``order``); ``c4_node`` is the binary node whose box bounds
    the child."""
    bmin: torch.Tensor
    bmax: torch.Tensor
    meta: torch.Tensor
    order: torch.Tensor
    levels: torch.Tensor
    c4_id: torch.Tensor
    c4_cnt: torch.Tensor
    c4_node: torch.Tensor
    n_levels: int

    def replace(self, **kw) -> "BVH":
        return replace(self, **kw)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _native.load(SPEC)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i32 = ctypes.c_int32
        lib.epsm_build_bvh.restype = i32
        lib.epsm_build_bvh.argtypes = [f32p, i32, i32p, i32, i32, f32p,
                                       f32p, i32p, i32p]
        _lib = lib
    return _lib


def _build_native(verts: np.ndarray, faces: np.ndarray):
    lib = _load()
    nf = len(faces)
    if faces.size and (faces.min() < 0 or faces.max() >= len(verts)):
        raise ValueError("face indices out of range")
    cap = max(2 * nf, 4)
    bmin = np.zeros((cap, 3), np.float32)
    bmax = np.zeros((cap, 3), np.float32)
    meta = np.zeros((cap, 4), np.int32)
    order = np.zeros((nf,), np.int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    n = lib.epsm_build_bvh(
        verts.ctypes.data_as(f32p), len(verts), faces.ctypes.data_as(i32p),
        nf, LEAF_SIZE, bmin.ctypes.data_as(f32p), bmax.ctypes.data_as(f32p),
        meta.ctypes.data_as(i32p), order.ctypes.data_as(i32p))
    return bmin[:n], bmax[:n], meta[:n], order


def _build_numpy(verts: np.ndarray, faces: np.ndarray):
    """The median-split builder (``_build_numpy``, :112-154): each node
    splits its triangles at the median centroid along the longest axis
    of its box (a stable sort), down to ``LEAF_SIZE`` a leaf; parents
    come before children, depth first."""
    p = verts[faces]                                  # (F, 3, 3)
    pmin, pmax = p.min(1), p.max(1)
    cent = 0.5 * (pmin + pmax)
    bmin_l, bmax_l, meta_l, order_l = [], [], [], []
    # an explicit stack of (triangle ids, parent, the parent's slot to
    # fill with this node): depth first, left child first
    stack = [(np.arange(len(faces)), -1, None)]
    while stack:
        ids, parent, slot = stack.pop()
        node = len(meta_l)
        if parent >= 0:
            meta_l[parent][slot] = node
        bmin_l.append(pmin[ids].min(0))
        bmax_l.append(pmax[ids].max(0))
        if len(ids) <= LEAF_SIZE:
            meta_l.append([len(order_l), len(ids), 1, parent])
            order_l.extend(ids.tolist())
            continue
        meta_l.append([0, 0, 0, parent])
        axis = int(np.argmax(bmax_l[node] - bmin_l[node]))
        srt = ids[np.argsort(cent[ids, axis], kind="stable")]
        mid = len(srt) // 2
        stack.append((srt[mid:], node, 1))
        stack.append((srt[:mid], node, 0))
    return (np.stack(bmin_l).astype(np.float32),
            np.stack(bmax_l).astype(np.float32),
            np.asarray(meta_l, np.int32), np.asarray(order_l, np.int32))


def _node_levels(meta: np.ndarray) -> np.ndarray:
    n = len(meta)
    lev = np.zeros(n, np.int32)
    for i in range(1, n):  # the builder puts parents before children
        lev[i] = lev[meta[i, 3]] + 1
    return lev


def collapse4(meta_np: np.ndarray, max_leaf: int = MAX_LEAF4):
    """Collapse a binary BVH into a 4-wide BVH with fat leaves.

    The builder emits ``order`` contiguously per subtree, so a subtree's
    triangles form one range [start, start + count): a subtree of at most
    ``max_leaf`` triangles becomes one fat leaf child.

    Returns (c_id, c_cnt, c_node), (n4, 4) int32 each (see ``BVH``)."""
    meta = np.asarray(meta_np)
    n = len(meta)
    start = np.zeros(n, np.int64)
    count = np.zeros(n, np.int64)
    for i in range(n - 1, -1, -1):      # parents precede children
        if meta[i, 2] == 1:
            start[i] = meta[i, 0]
            count[i] = meta[i, 1]
        else:
            l, r = meta[i, 0], meta[i, 1]
            start[i] = min(start[l], start[r])
            count[i] = count[l] + count[r]

    def is_fat_leaf(j):
        return meta[j, 2] == 1 or count[j] <= max_leaf

    if is_fat_leaf(0):
        c_id = np.array([[start[0], 0, 0, 0]], np.int32)
        c_cnt = np.array([[count[0], -1, -1, -1]], np.int32)
        c_node = np.zeros((1, 4), np.int32)
        return c_id, c_cnt, c_node

    idx = {0: 0}
    order4 = [0]
    queue = [0]
    rows = []
    while queue:
        i = queue.pop(0)
        subs = []
        for c in (meta[i, 0], meta[i, 1]):
            if is_fat_leaf(c):
                subs.append((c, True))
            else:
                for g in (meta[c, 0], meta[c, 1]):
                    subs.append((g, is_fat_leaf(g)))
        row = []
        for j, leaf in subs:
            if not leaf and j not in idx:
                idx[j] = len(order4)
                order4.append(j)
                queue.append(j)
            row.append((j, leaf))
        rows.append((i, row))

    n4 = len(order4)
    c_id = np.zeros((n4, 4), np.int32)
    c_cnt = np.full((n4, 4), -1, np.int32)
    c_node = np.zeros((n4, 4), np.int32)
    for i, row in rows:
        a = idx[i]
        for k, (j, leaf) in enumerate(row):
            c_node[a, k] = j
            if leaf:
                c_id[a, k] = start[j]
                c_cnt[a, k] = count[j]
            else:
                c_id[a, k] = idx[j]
                c_cnt[a, k] = 0
    return c_id, c_cnt, c_node


def from_arrays(arrays: Mapping[str, np.ndarray], device) -> BVH:
    """A ``BVH`` from numpy arrays named as ``ARRAY_FIELDS`` (the
    reference BVH's fields), on ``device``."""
    out = {}
    for k in ARRAY_FIELDS:
        a = np.asarray(arrays[k])
        dtype = torch.float32 if k in ("bmin", "bmax") else torch.int32
        out[k] = torch.tensor(a, dtype=dtype, device=device)
    return BVH(n_levels=int(np.asarray(arrays["levels"]).max()) + 1, **out)


def build(vertices, faces, device=None, builder: str = "native") -> BVH:
    """Build the BVH of a triangle mesh on the host; the arrays go to
    ``device`` (default: that of ``vertices`` if it is a tensor, else
    the CPU).  ``builder``: ``"native"`` (binned SAH, ``native/bvh.cpp``)
    or ``"numpy"`` (the median split ``_build_numpy``)."""
    if builder not in ("native", "numpy"):
        raise ValueError(f"unknown BVH builder '{builder}'")
    if device is None:
        device = (vertices.device if isinstance(vertices, torch.Tensor)
                  else "cpu")
    if isinstance(vertices, torch.Tensor):
        vertices = vertices.detach().cpu().numpy()
    if isinstance(faces, torch.Tensor):
        faces = faces.cpu().numpy()
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    if builder == "numpy":
        if f.size and (f.min() < 0 or f.max() >= len(v)):
            raise ValueError("face indices out of range")
        bmin, bmax, meta, order = _build_numpy(v, f)
    else:
        bmin, bmax, meta, order = _build_native(v, f)
    c_id, c_cnt, c_node = collapse4(meta, MAX_LEAF4)
    return from_arrays(dict(bmin=bmin, bmax=bmax, meta=meta, order=order,
                            levels=_node_levels(meta), c4_id=c_id,
                            c4_cnt=c_cnt, c4_node=c_node), device)


def refit(bvh: BVH, vertices: torch.Tensor, faces: torch.Tensor) -> BVH:
    """Node boxes recomputed bottom-up from moved vertices; the topology
    stays."""
    p = vertices[faces.long()]                       # (F, 3, 3)
    pmin = p.amin(1)
    pmax = p.amax(1)
    meta = bvh.meta.long()
    is_leaf = meta[:, 2] == 1
    lanes = torch.arange(LEAF_SIZE, device=meta.device)
    slots = meta[:, 0:1] + lanes[None, :]
    valid = (lanes[None, :] < meta[:, 1:2]) & is_leaf[:, None]
    prim = bvh.order.long()[slots.clamp(0, bvh.order.shape[0] - 1)]
    inf = float("inf")
    leaf_min = torch.where(valid[..., None], pmin[prim], inf).amin(1)
    leaf_max = torch.where(valid[..., None], pmax[prim], -inf).amax(1)
    bmin = torch.where(is_leaf[:, None], leaf_min, bvh.bmin)
    bmax = torch.where(is_leaf[:, None], leaf_max, bvh.bmax)
    # children of inner nodes (a leaf's slots hold its triangle range)
    l = torch.where(is_leaf, 0, meta[:, 0])
    r = torch.where(is_leaf, 0, meta[:, 1])
    for lev in range(bvh.n_levels - 2, -1, -1):     # deepest level first
        sel = ((bvh.levels == lev) & ~is_leaf)[:, None]
        bmin = torch.where(sel, torch.minimum(bmin[l], bmin[r]), bmin)
        bmax = torch.where(sel, torch.maximum(bmax[l], bmax[r]), bmax)
    return bvh.replace(bmin=bmin, bmax=bmax)
