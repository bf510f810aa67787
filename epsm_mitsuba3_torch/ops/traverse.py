"""The plain PyTorch versions of kernels K2, K3 and K4 (counterparts of
the traversal in ``ops/traverse.py`` and of ``ops/pallas_traverse.py``
``_traverse_kernel`` / ``_anyhit_kernel`` / ``_traverse_kernel_mp``).

They take the kernels' inputs: the BVH4 node records ``nodes`` (n4, 32)
of ``cuda_traverse.pack_bvh4``, the leaf-ordered triangles ``tri`` (F, 9)
= rows [p0, e1, e2], and the rays ``o``, ``d`` (N, 3), ``maxt`` (N,).
Each ray walks the tree with a stack of its own, and the walk is the
kernels' one step for step, vectorised over the rays: one pop a lane per
iteration (K4: up to P pops, visited in batch order).

- Directions are clamped to +-1e-12 before the reciprocal.  A child box
  is entered when near <= far and far > 1e-6 (and, for the closest hit,
  near < the ray's current t; for the any hit, near < maxt).
- Closest hit: t starts at maxt.  The root is pushed with key 0; a
  popped entry whose key is not below the ray's current t is skipped.
  The leaf children of a popped node are tested in child order, each
  triangle in slot order with 1e-6 < t < the current t, so the first of
  equal hits wins.  Then the inner children that are still entered are
  pushed far-first, keyed by their near distance; equal keys keep child
  order.
- Any hit: rays with maxt <= 1e-6 start with an empty stack.  The leaf
  children of a popped node are tested in child order and the ray stops
  at its first hit; otherwise its entered inner children are pushed in
  child order.
- A push past ``STACK_SIZE`` raises ``StackOverflow``.
"""
from __future__ import annotations

import torch

from . import intersect as I

#: entries of each ray's stack (the CUDA kernels' limit too)
STACK_SIZE = 64
_INF = float("inf")


class StackOverflow(RuntimeError):
    """A ray's traversal stack would have grown past its size."""


def _inv_dir(d: torch.Tensor) -> torch.Tensor:
    safe = torch.where(d.abs() > 1e-12, d,
                       torch.where(d >= 0, 1e-12, -1e-12))
    return 1.0 / safe


def _slab4(rec: torch.Tensor, o: torch.Tensor, inv: torch.Tensor):
    """Slab test of rays (m, 3) against the four child boxes of their
    records (m, 32): (near, far), (m, 4) each."""
    b = rec[:, 8:32].reshape(-1, 4, 6)
    t0 = (b[..., 0:3] - o[:, None, :]) * inv[:, None, :]
    t1 = (b[..., 3:6] - o[:, None, :]) * inv[:, None, :]
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    near = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]), lo[..., 2])
    far = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]), hi[..., 2])
    return near, far


def _leaf_tests(tri, o, d, start, count, tmax):
    """Rays (m, 3) against the triangles [start, start + count) of their
    leaves: (t, u, v, hit), (m, W) each, W the widest leaf; ``hit`` holds
    every condition of a hit with 1e-6 < t < tmax."""
    width = int(count.max())
    j = torch.arange(width, device=o.device)
    slots = (start[:, None] + j[None, :]).clamp(max=tri.shape[0] - 1)
    rows = tri[slots]                                     # (m, W, 9)
    cols = [rows[..., k] for k in range(9)]
    oc = tuple(o[:, k][:, None] for k in range(3))
    dc = tuple(d[:, k][:, None] for k in range(3))
    t, u, v, hit = I._mt_edges(oc, dc, cols[0:3], cols[3:6], cols[6:9])
    hit = hit & (j[None, :] < count[:, None]) & (t > 1e-6) \
        & (t < tmax[:, None])
    return t, u, v, hit


def _push_check(sp, npush):
    if bool((sp + npush > STACK_SIZE).any()):
        raise StackOverflow(
            f"a ray's BVH traversal needs more than {STACK_SIZE} stack "
            "entries")


def _mark(read, start, count):
    """Set ``read`` over the rows [start, start + count) of each lane."""
    if read is None or start.numel() == 0:
        return
    j = torch.arange(int(count.max()), device=start.device)
    rows = start[:, None] + j[None, :]
    read[rows[j[None, :] < count[:, None]]] = True


def _read_masks(nodes, tri, reads):
    """The records and triangles read so far, all False; (None, None)
    when they are not asked for."""
    if not reads:
        return None, None
    return (torch.zeros(nodes.shape[0], dtype=torch.bool, device=nodes.device),
            torch.zeros(tri.shape[0], dtype=torch.bool, device=tri.device))


def _visit(nodes, tri, node, lanes, o, d, inv, t_best, slot, u, v, tests,
           row_read=None):
    """K2's work at one popped node for each of ``lanes``: the leaf
    children tested in child order (updating t_best, slot, u, v, tests
    and ``row_read`` in place), then the inner children still entered.
    Returns (push (m, 4), rank (m, 4) far-first, near (m, 4), cid
    (m, 4))."""
    rec = nodes[node]
    oa, da = o[lanes], d[lanes]
    near, far = _slab4(rec, oa, inv[lanes])
    cid, cnt = rec[:, 0:4].long(), rec[:, 4:8].long()
    enter = (near <= far) & (far > 1e-6)
    tb = t_best[lanes]
    for k in range(4):
        sel = (enter[:, k] & (cnt[:, k] > 0)
               & (near[:, k] < tb)).nonzero().squeeze(1)
        if sel.numel() == 0:
            continue
        start, c = cid[sel, k], cnt[sel, k]
        t, uu, vv, hit = _leaf_tests(tri, oa[sel], da[sel], start, c,
                                     tb[sel])
        tests[lanes[sel]] += c
        _mark(row_read, start, c)
        tmin, jmin = torch.where(hit, t, _INF).min(dim=1)
        found = hit.any(dim=1)
        hits = lanes[sel][found]
        jf = jmin[found][:, None]
        t_best[hits] = tmin[found]
        slot[hits] = start[found] + jmin[found]
        u[hits] = uu[found].gather(1, jf).squeeze(1)
        v[hits] = vv[found].gather(1, jf).squeeze(1)
        tb = t_best[lanes]
    push = enter & (cnt == 0) & (near < tb[:, None])
    # rank of child k among the pushed ones, farthest first; equal keys
    # keep child order
    k4 = torch.arange(4, device=o.device)
    before = push[:, :, None] & (
        (near[:, :, None] > near[:, None, :])
        | ((near[:, :, None] == near[:, None, :])
           & (k4[:, None] < k4[None, :])))
    return push, before.sum(dim=1), near, cid


def bvh_ray_intersect_plain(nodes, tri, o, d, maxt, counts: bool = False,
                            multi_pop: int = 0, reads: bool = False):
    """Closest hit through the BVH4: K2's plain version, and with
    ``multi_pop`` P > 1 K4's.

    K4 pops ``npop = min(sp, P)`` entries at once: it reads the batch,
    top first, before it visits any of them, because the pushes recycle
    the popped region from ``sp0 = sp - npop``.  It then visits them in
    batch order with K2's per-node work (the stale-entry cull against the
    current t included), appending each node's far-first pushes at ``sp0
    + pos``, ``pos`` the pushes of the batch so far.  P = 1 is K2's walk.

    Returns (t (N,) +inf on a miss, slot (N,) int32 index into ``tri``,
    -1 on a miss, u, v (N,) 0 on a miss); with ``counts``, also the
    per-ray node pops and triangle tests, (N,) int64 each; with
    ``reads``, then the records popped and the triangles tested by some
    ray, (n_nodes,) and (F,) bool: what the walk must read."""
    n, dev = o.shape[0], o.device
    batch = max(1, int(multi_pop))
    inv = _inv_dir(d)
    t_best = maxt.clone()
    slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    u = torch.zeros(n, dtype=o.dtype, device=dev)
    v = torch.zeros(n, dtype=o.dtype, device=dev)
    stack = torch.zeros((n, STACK_SIZE), dtype=torch.int64, device=dev)
    keys = torch.zeros((n, STACK_SIZE), dtype=o.dtype, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    pops = torch.zeros(n, dtype=torch.int64, device=dev)
    tests = torch.zeros(n, dtype=torch.int64, device=dev)
    node_read, row_read = _read_masks(nodes, tri, reads)
    while True:
        a = (sp > 0).nonzero().squeeze(1)
        if a.numel() == 0:
            break
        npop = sp[a].clamp(max=batch)
        sp0 = sp[a] - npop
        entries = [(stack[a, (sp0 + npop - 1 - i).clamp(min=0)],
                    keys[a, (sp0 + npop - 1 - i).clamp(min=0)])
                   for i in range(batch)]
        pos = torch.zeros_like(sp0)
        for i, (node, key) in enumerate(entries):
            # the stale-entry cull, against t as it stands now
            live = (i < npop) & (key < t_best[a])
            lanes = a[live]
            if lanes.numel() == 0:
                continue
            pops[lanes] += 1
            if reads:
                node_read[node[live]] = True
            push, rank, near, cid = _visit(nodes, tri, node[live], lanes, o,
                                           d, inv, t_best, slot, u, v, tests,
                                           row_read)
            npush = push.sum(dim=1)
            base = sp0[live] + pos[live]
            _push_check(base, npush)
            rows = lanes[:, None].expand(-1, 4)[push]
            at = (base[:, None] + rank)[push]
            stack[rows, at] = cid[push]
            keys[rows, at] = near[push]
            pos[live] += npush
        sp[a] = sp0 + pos
    valid = slot >= 0
    out = (torch.where(valid, t_best, _INF), slot.to(torch.int32), u, v)
    return (out + ((pops, tests) if counts else ())
            + ((node_read, row_read) if reads else ()))


def bvh_ray_test_plain(nodes, tri, o, d, maxt, counts: bool = False,
                       reads: bool = False):
    """Occlusion through the BVH4 (K3's plain version): (N,) bool, True
    where some triangle passes the closest hit's test; with ``counts``,
    also the per-ray node pops and triangle tests; with ``reads``, the
    records and triangles read, as ``bvh_ray_intersect_plain``'s."""
    n, dev = o.shape[0], o.device
    inv = _inv_dir(d)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    stack = torch.zeros((n, STACK_SIZE), dtype=torch.int64, device=dev)
    sp = (maxt > 1e-6).long()
    pops = torch.zeros(n, dtype=torch.int64, device=dev)
    tests = torch.zeros(n, dtype=torch.int64, device=dev)
    node_read, row_read = _read_masks(nodes, tri, reads)
    while True:
        a = ((sp > 0) & ~occ).nonzero().squeeze(1)
        if a.numel() == 0:
            break
        sp[a] -= 1
        node = stack[a, sp[a]]
        pops[a] += 1
        if reads:
            node_read[node] = True
        rec = nodes[node]
        oa, da, ma = o[a], d[a], maxt[a]
        near, far = _slab4(rec, oa, inv[a])
        cid, cnt = rec[:, 0:4].long(), rec[:, 4:8].long()
        enter = (near <= far) & (far > 1e-6) & (near < ma[:, None])
        done = torch.zeros(a.numel(), dtype=torch.bool, device=dev)
        for k in range(4):
            sel = (enter[:, k] & (cnt[:, k] > 0) & ~done).nonzero() \
                .squeeze(1)
            if sel.numel() == 0:
                continue
            start, c = cid[sel, k], cnt[sel, k]
            _, _, _, hit = _leaf_tests(tri, oa[sel], da[sel], start, c,
                                       ma[sel])
            found = hit.any(dim=1)
            first = hit.int().argmax(dim=1)          # first hit's slot
            tested = torch.where(found, first + 1, c)
            tests[a[sel]] += tested
            _mark(row_read, start, tested)
            done[sel] = found
        occ[a] = done
        push = enter & (cnt == 0) & ~done[:, None]
        if not bool(push.any()):
            continue
        npush = push.sum(dim=1)
        _push_check(sp[a], npush)
        pos = sp[a][:, None] + push.long().cumsum(dim=1) - 1
        rows = a[:, None].expand(-1, 4)[push]
        stack[rows, pos[push]] = cid[push]
        sp[a] += npush
    extra = (((pops, tests) if counts else ())
             + ((node_read, row_read) if reads else ()))
    return (occ, *extra) if extra else occ
