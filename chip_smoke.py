#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and hold every
hand-written kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (any failed check raises, and the script exits non-zero):

1. build kernels K1 (``csrc/mt_intersect.cu``) and K2/K4/K3
   (``csrc/bvh_traverse.cu``) with nvcc for sm_90a and the BVH builder
   (``native/bvh.cpp``) with g++, all at once, and print the card's name
   and power limit and each kernel's registers, stack and spills;
2. K1's closest-hit and any-hit entries against the plain versions on the
   card, at the Cornell box's shape (12 triangles against 2^20 camera and
   bounce rays, some dead) and at the largest scene K1 serves (4,096
   triangles against 65,536 rays), and their times;
3. the Cornell box's primal render at full width: ``render(load_dict(
   cornell_box(512, 64, 6)), spp=64, spp_chunk=4)``: a warm-up and five
   timed renders, with the launch counts set to 0 before and read after
   each;
4. K2/K3 against their plain versions on ``cornell_box_mesh``'s 2^21
   camera and bounce rays (a tenth dead), and on 65,536 of them against
   K1's plain brute force over all 64,812 triangles; the stack-overflow
   flag stays 0;
5. K2/K3 times, with the rays unsorted and Morton-sorted (sort
   included), beside the plain versions' and the bound; then K4 at P = 2
   and 4 on the same rays against its plain version (every output
   equal), against K2 (t and valid equal, tie rays counted) and against
   the brute force, timed beside K2 in the same call;
6. the mesh's primal render at full width: ``render(load_dict(
   cornell_box_mesh(512, 8, 6)), spp=16, spp_chunk=8)``, each launching
   K2 and K3 12 times and K1 never;
7. both scenes rendered small on the card and on the CPU;
8. bench.py's fwd+bwd cells at full width, the loss ``mean(img^2)``
   differentiated w.r.t. the vertices, reflectances and radiance: the
   box, 16 passes of 1,048,576 lanes (K1 6 + 6 launches in each forward),
   and the mesh, 2 passes of 2,097,152 lanes (K2 and K3 6 each), again
   with ``multi_pop`` 4 (K4 6, K2 none) and the gradients compared; no
   kernel launches in any backward; a warm-up and 3 timed runs each, and
   one profiled pass;
9. three iterations of ``app/optim.run("prb", ...)`` on the mesh at 512^2
   x 8 spp, theta a translation of the sphere through ``set_vertices``;
   then K2 on the re-packed scene against K1's brute force over the moved
   vertices;
10. the fwd+bwd gradients at 64^2 x 4 spp on the card against the CPU's,
    for both scenes.

The last lines are one JSON line of kernel numbers and one JSON line
``{"ok": true, "device": {...}}``.  Without CUDA the script exits 1 and
prints no result.
"""
import json
import subprocess
import sys
import time

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and FP32 flop/s
#: outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
#: float arithmetic of one ray-triangle test in K1: cross products 2 x 9,
#: dot products 4 x 5, 1 reciprocal, 3 subtractions, 3 scalings, u + v
FLOP_PER_TEST = 18 + 20 + 1 + 3 + 3 + 1
#: FP32 operations of one slab test in K2/K3: 6 subtractions, 6
#: multiplies, 6 + 4 min/max, 3 compares
OPS_PER_SLAB = 6 + 6 + 10 + 3
#: K2 orders the pushed children: 12 compares of their keys a pop
OPS_PER_ORDER = 12
#: Cornell-box workload: 512^2, 64 spp in passes of 4, max depth 6 (one
#: closest-hit and one shadow query a bounce)
RES, SPP, SPP_CHUNK, DEPTH = 512, 64, 4, 6
#: BVH-slice workload (bench.py's ``bvh`` section): cornell_box_mesh at
#: 512^2, 16 spp in passes of 8, max depth 6
MESH_SPP, MESH_CHUNK = 16, 8
TIMED_RENDERS = 5
#: fwd+bwd cells (bench.py's ``_bench_scene``): the box's 16 passes of 4
#: spp (``sec_toy``) and the mesh's 2 passes of 8 spp (``sec_bvh``)
BOX_PASSES, MESH_PASSES = 16, 2
#: the ground truth of the [adam] phase
ADAM_GT_SPP = 16


class CheckFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def say(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warm=3):
    """Mean ms a call of ``fn`` on the card, by CUDA events, after warm-up."""
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed(fn):
    """(result, ms) of one call of ``fn``, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def main_path_rays(scene, gen, spp):
    """A pass's rays of the main path's kinds: camera rays (even lanes)
    and random bounce rays from the camera hits (odd lanes), some of
    finite extent; a tenth of all lanes dead (maxt = 0)."""
    import torch
    from epsm_mitsuba3_torch.integrators import common
    from epsm_mitsuba3_torch.models import samplers as smp
    sensor = scene.sensors[0]
    n = sensor.width * sensor.height * spp
    sampler = smp.seed(0, n, device=scene.device)
    _, cam, _, _ = common.sample_rays(sensor, sampler, spp)
    si = scene.ray_intersect(cam)
    dirs = torch.randn((n, 3), generator=gen, device=scene.device)
    bounce = si.spawn_ray(dirs / dirs.norm(dim=-1, keepdim=True))
    odd = (torch.arange(n, device=scene.device) % 2 == 1)[:, None]
    o = torch.where(odd, bounce.o, cam.o).contiguous()
    d = torch.where(odd, bounce.d, cam.d).contiguous()
    u = torch.rand(n, generator=gen, device=scene.device)
    maxt = torch.where(u < 0.3, 3.0 * u + 0.1, float("inf"))
    maxt = torch.where(u > 0.9, 0.0, maxt).contiguous()
    return o, d, maxt


def soup_rays(n_tris, n_rays, gen, device):
    """Random triangles in [-1, 1]^3 and rays aimed into them."""
    import torch
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI

    def uniform(*shape, lo=-1.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)

    verts = uniform(3 * n_tris, 3)
    faces = torch.arange(3 * n_tris, device=device).reshape(n_tris, 3)
    o = uniform(n_rays, 3, lo=-2.0, hi=2.0)
    d = uniform(n_rays, 3, lo=-0.8, hi=0.8) - o
    d = (d / d.norm(dim=-1, keepdim=True)).contiguous()
    u = uniform(n_rays, lo=0.0, hi=1.0)
    maxt = torch.where(u < 0.3, 10.0 * u + 0.5, float("inf"))
    maxt = torch.where(u > 0.9, 0.0, maxt).contiguous()
    return CI.pack_tris(verts, faces), o, d, maxt


def anyhit_tests(tri, o, d, maxt, chunk=512):
    """Ray-triangle tests the any-hit entry needs on these rays: up to
    and including each ray's first hit; none for a ray of no extent."""
    import torch
    from epsm_mitsuba3_torch.ops import intersect as I
    f = tri.shape[0]
    first = torch.full((o.shape[0],), f, dtype=torch.int64, device=o.device)
    for base, _, hit in I.chunk_hits(tri, o, d, maxt, chunk):
        idx = torch.arange(base, base + hit.shape[1], device=o.device)
        first = torch.minimum(first, torch.where(hit, idx, f).amin(dim=1))
    tests = torch.where(first < f, first + 1, f)
    return int(torch.where(maxt > 1e-6, tests, 0).sum())


def bound_ms(n_bytes, n_flop):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_flop = n_flop / PEAK_FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flop else (t_flop, "operations")


def hold(label, got, ref):
    """Hold a kernel's (t, prim, u, v, occ) against a reference's on the
    same rays: ``prim``, ``valid`` and ``occ`` equal on >= 99.99 % of the
    lanes, |err| of t, u, v <= 1e-5 * max(|ref|, 1) where ``prim``
    agrees, and the any hit equal to the closest hit's ``valid``.
    Returns the largest absolute error of t, u, v and of ``occ``."""
    import torch
    t, prim, u, v, occ = got
    t_p, prim_p, u_p, v_p, occ_p = ref
    n = prim.shape[0]
    same = prim == prim_p
    n_diff = int((~same).sum())
    n_valid_diff = int(((prim >= 0) != (prim_p >= 0)).sum())
    n_occ_diff = int((occ != occ_p).sum())
    agree = same & (prim >= 0)
    errs = {}
    for name, a, b in (("t", t, t_p), ("u", u, u_p), ("v", v, v_p)):
        e = (a[agree] - b[agree]).abs()
        rel = e / b[agree].abs().clamp(min=1.0)
        errs[name] = (float(e.max()) if e.numel() else 0.0,
                      float(rel.max()) if rel.numel() else 0.0)
    self_consistent = bool(torch.equal(occ, prim >= 0))
    say(f"[{label}] rays {n} hits {int((prim_p >= 0).sum())}: prim differs "
        f"on {n_diff} lanes, valid on {n_valid_diff}, any-hit on "
        f"{n_occ_diff}; any-hit == closest valid: {self_consistent}; "
        "max |err| " + ", ".join(f"{k} {a:.3g} (rel {r:.3g})"
                                 for k, (a, r) in errs.items())
        + "  [limits: >= 99.99 % agree, |err| <= 1e-5 * max(|ref|, 1)]")
    check(n_diff <= 1e-4 * n and n_valid_diff <= 1e-4 * n,
          f"{label}: closest hit disagrees on {n_diff} lanes")
    check(n_occ_diff <= 1e-4 * n,
          f"{label}: any hit disagrees on {n_occ_diff} lanes")
    check(self_consistent, f"{label}: any-hit != closest-hit valid")
    for k, (_, rel) in errs.items():
        check(rel <= 1e-5, f"{label}: {k} off by {rel} relative")
    return (max(a for a, _ in errs.values()),
            float((occ != occ_p).float().max()) if n else 0.0)


def compare_k1(label, tri, o, d, maxt):
    """Both K1 entries against the plain versions on the same inputs."""
    import torch
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    from epsm_mitsuba3_torch.ops import intersect as I
    got = (*CI.closest_hit(tri, o, d, maxt), CI.any_hit(tri, o, d, maxt))
    torch.cuda.synchronize()
    ref = (*I.ray_intersect_brute(tri, o, d, maxt),
           I.ray_test_brute(tri, o, d, maxt))
    return hold(f"K1 {label}, {tri.shape[0]} tris", got, ref)


def time_k1(tri, o, d, maxt):
    """ms a launch of both entries and of their plain versions, and the
    bound of each entry on these inputs."""
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    from epsm_mitsuba3_torch.ops import intersect as I
    n, f = o.shape[0], tri.shape[0]
    args = (tri, o, d, maxt)
    out = {}
    ray_in = n * (12 + 12 + 4)
    for name, kern, plain, out_bytes, flop in (
            ("mt_closest_hit", CI.closest_hit, I.ray_intersect_brute,
             16 * n, n * f * FLOP_PER_TEST),
            ("mt_any_hit", CI.any_hit, I.ray_test_brute, n,
             anyhit_tests(*args) * FLOP_PER_TEST)):
        ms = cuda_ms(lambda: kern(*args), 50)
        plain_ms = cuda_ms(lambda: plain(*args), 5)
        b_ms, by = bound_ms(36 * f + ray_in + out_bytes, flop)
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=by)
    return out


def compare_bvh(scene, o, d, maxt, n_brute=65536):
    """K2 and K3 (default ray order) against their plain versions on the
    same rays, and on the first ``n_brute`` rays against K1's plain brute
    force over every triangle; the overflow flag must stay 0.  Returns
    the errors against each, the plain versions' ms and their work
    counts."""
    import torch
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.ops import intersect as I
    from epsm_mitsuba3_torch.ops import traverse as TR
    nodes, tri = scene.bvh_nodes, scene.bvh_tris
    order = scene.bvh.order.long()
    t, slot, u, v = CT.closest_hit(nodes, tri, o, d, maxt)
    occ = CT.any_hit(nodes, tri, o, d, maxt)
    torch.cuda.synchronize()
    CT.raise_on_overflow(o.device)
    say("[K2/K3] overflow flag: 0")
    (t_p, slot_p, u_p, v_p, pops, tests), plain_ms_c = timed(
        lambda: TR.bvh_ray_intersect_plain(nodes, tri, o, d, maxt,
                                           counts=True))
    (occ_p, pops_a, tests_a), plain_ms_a = timed(
        lambda: TR.bvh_ray_test_plain(nodes, tri, o, d, maxt, counts=True))
    err = hold("K2/K3 vs plain, main-path rays", (t, slot, u, v, occ),
               (t_p, slot_p, u_p, v_p, occ_p))

    def prim_of(s):
        return torch.where(s >= 0, order[s.clamp(min=0).long()], -1)

    k = slice(0, n_brute)
    tri_all = CI.pack_tris(scene.vertices, scene.faces)
    ref = (*I.ray_intersect_brute(tri_all, o[k], d[k], maxt[k]),
           I.ray_test_brute(tri_all, o[k], d[k], maxt[k]))
    ref = (ref[0], ref[1].long(), *ref[2:])
    err_b = hold(f"K2/K3 vs K1 brute force, {tri_all.shape[0]} tris",
                 (t[k], prim_of(slot[k]), u[k], v[k], occ[k]), ref)
    live = maxt > 1e-6
    say(f"[K2/K3] per live ray: closest hit {float(pops[live].float().mean()):.2f}"
        f" pops, {float(tests[live].float().mean()):.2f} triangle tests; "
        f"any hit {float(pops_a[live].float().mean()):.2f} pops, "
        f"{float(tests_a[live].float().mean()):.2f} tests")
    return dict(err=err, err_brute=err_b, plain_ms=(plain_ms_c, plain_ms_a),
                work=(int(pops.sum()), int(tests.sum()), int(pops_a.sum()),
                      int(tests_a.sum())))


def time_bvh(scene, o, d, maxt, plain_ms, work):
    """ms a launch of K2 and K3, rays unsorted and Morton-sorted (the
    sort and un-sort included), the traversal alone on pre-sorted rays,
    and each entry's bound on these rays from the plain versions' work
    counts."""
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    nodes, tri = scene.bvh_nodes, scene.bvh_tris
    n = o.shape[0]
    tree = 4 * (nodes.numel() + tri.numel())
    pops, tests, pops_a, tests_a = work
    perm = CT._morton_order(nodes, o, d, maxt)
    pre = (o[perm].contiguous(), d[perm].contiguous(), maxt[perm].contiguous())
    out = {}
    default = CT.SORT_RAYS
    for name, fn, out_bytes, ops, p_ms in (
            ("bvh4_closest_hit", CT.closest_hit, 16 * n,
             pops * (4 * OPS_PER_SLAB + OPS_PER_ORDER)
             + tests * FLOP_PER_TEST, plain_ms[0]),
            ("bvh4_any_hit", CT.any_hit, n,
             pops_a * 4 * OPS_PER_SLAB + tests_a * FLOP_PER_TEST,
             plain_ms[1])):
        ms = {srt: cuda_ms(lambda: fn(nodes, tri, o, d, maxt, sort=srt), 20)
              for srt in (False, True)}
        # the traversal alone on rays already in Morton order
        ms_pre = cuda_ms(lambda: fn(nodes, tri, *pre, sort=False), 20)
        n_bytes = tree + 28 * n + out_bytes
        b_ms, by = bound_ms(n_bytes, ops)
        out[name] = dict(ms=ms[default], ms_unsorted=ms[False],
                         ms_sorted=ms[True], ms_presorted=ms_pre,
                         plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                         sort=default)
        say(f"[time] {name} at {tri.shape[0]} tris x {n} rays: unsorted "
            f"{ms[False]:.4f} ms, Morton-sorted {ms[True]:.4f} ms (sort "
            f"included; default {'sorted' if default else 'unsorted'}), "
            f"on pre-sorted rays {ms_pre:.4f} ms; plain version "
            f"{p_ms:.1f} ms; bound {b_ms:.4f} ms by {by} ({ops / 1e9:.3f} "
            f"G operations, {n_bytes / 1e6:.1f} MB)")
    return out


def image_checks(img, res):
    import torch
    check(tuple(img.shape) == (res, res, 3), f"image shape {img.shape}")
    check(bool(torch.isfinite(img).all()), "image has non-finite pixels")
    w = res // 8
    left = img[:, :w].mean((0, 1))
    right = img[:, -w:].mean((0, 1))
    top, bottom = img[: res // 2].mean(), img[res // 2:].mean()
    say(f"[render] mean {float(img.mean()):.5f}; left rgb "
        f"{[round(float(x), 4) for x in left]}, right rgb "
        f"{[round(float(x), 4) for x in right]}; top/bottom "
        f"{float(top):.4f}/{float(bottom):.4f}")
    check(left[0] > left[1], "left wall is not red-tinted")
    check(right[1] > right[0], "right wall is not green-tinted")
    check(top > bottom, "the light is not in the top half")


def render_phase(label, scene, spp, chunk, expect):
    """A warm-up and TIMED_RENDERS timed renders at full width; before
    each every launch count is set to 0, and after it each count must be
    ``expect``'s.  Returns the median wall ms and the last counts."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    walls = []
    for run in ["warm-up"] + [f"timed {i + 1}" for i in range(TIMED_RENDERS)]:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = mt.render(scene, spp=spp, spp_chunk=chunk, seed=0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        say(f"[{label}] {run}: {walls[-1]:.1f} ms, launches {counts}")
        for k, n in expect.items():
            check(counts[k] == n,
                  f"{k} launched {counts[k]} times, expected {n}")
        image_checks(img, scene.sensors[0].width)
    CT.raise_on_overflow(scene.device)
    timed_walls = sorted(walls[1:])
    median = timed_walls[len(timed_walls) // 2]
    sensor = scene.sensors[0]
    n_passes = -(-spp // chunk)
    rays = sensor.width * sensor.height * chunk * DEPTH * 2 * n_passes
    say(f"[{label}] {sensor.width}^2 x {spp} spp ({n_passes} passes of "
        f"{chunk}), depth {DEPTH}: wall median {median:.1f} ms of "
        f"{len(timed_walls)} (min {timed_walls[0]:.1f}, max "
        f"{timed_walls[-1]:.1f}); {rays / (median / 1e3) / 1e6:.2f} "
        "physical Mrays/s at the median")
    return median, counts


def profile_pass(label, fn, names):
    """Device time by kernel over one call of ``fn`` (torch.profiler),
    with the share of the kernels whose names contain one of ``names``;
    the full table goes to standard error."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    key = ("device_time_total" if hasattr(avgs[0], "device_time_total")
           else "cuda_time_total")
    # kernels only: an operator's device time repeats its kernels' time
    kernels = [e for e in avgs if getattr(e, key) > 0 and getattr(
        e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    print(f"== profile: {label}", file=sys.stderr)
    print(avgs.table(sort_by=key, row_limit=30), file=sys.stderr)
    if not kernels:
        say(f"[profile] {label}: wall {wall:.1f} ms; the profiler saw no "
            "device time (not measured)")
        return None
    busy = sum(getattr(e, key) for e in kernels) / 1e3
    ours = sum(getattr(e, key) for e in kernels
               if any(nm in e.key for nm in names)) / 1e3
    top = sorted(kernels, key=lambda e: -getattr(e, key))[:8]
    n_launch = sum(e.count for e in kernels)
    say("[profile] %s: wall %.1f ms, device busy %.1f ms (%.1f %%), %s "
        "%.2f ms (%.1f %% of busy), %d kernel launches; top: %s" % (
            label, wall, busy, 100 * busy / wall, "/".join(names), ours,
            100 * ours / busy, n_launch,
            "; ".join(f"{e.key[:40]} {getattr(e, key) / 1e3:.2f} ms"
                      f" x{e.count}" for e in top)))
    return dict(wall=wall, busy=busy, launches=n_launch)


def compare_k4(scene, o, d, maxt, n_brute=65536):
    """K4 at each multi-pop width against its plain version (every output
    equal), against K2 (t and valid equal; the rays where the two keep
    different triangles at the same t counted) and, on the first
    ``n_brute`` rays, against K1's plain brute force.  Returns per width
    the errors, the plain version's ms and its work counts."""
    import torch
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.ops import intersect as I
    from epsm_mitsuba3_torch.ops import traverse as TR
    nodes, tri = scene.bvh_nodes, scene.bvh_tris
    order = scene.bvh.order.long()
    k2 = CT.closest_hit(nodes, tri, o, d, maxt, multi_pop=0)
    k = slice(0, n_brute)
    tri_all = CI.pack_tris(scene.vertices, scene.faces)
    brute = I.ray_intersect_brute(tri_all, o[k], d[k], maxt[k])
    brute = (brute[0], brute[1].long(), *brute[2:],
             brute[1] >= 0)
    out = {}
    for width in CT.K4_WIDTHS:
        got = CT.closest_hit(nodes, tri, o, d, maxt, multi_pop=width)
        torch.cuda.synchronize()
        CT.raise_on_overflow(o.device)
        (*plain, pops, tests), plain_ms = timed(
            lambda: TR.bvh_ray_intersect_plain(nodes, tri, o, d, maxt,
                                               counts=True,
                                               multi_pop=width))
        n_diff = sum(int((a != b).sum()) for a, b in zip(got, plain))
        # t is +inf on a miss in both: compare the finite entries
        err = max(float(torch.where(torch.isfinite(b), a - b, 0.0).abs()
                        .max()) for a, b in zip((got[0], got[2], got[3]),
                                                (plain[0], plain[2],
                                                 plain[3])))
        t_same = bool(torch.equal(got[0], k2[0]))
        valid_same = bool(torch.equal(got[1] >= 0, k2[1] >= 0))
        ties = int((got[1] != k2[1]).sum())
        say(f"[k4] P={width} on {o.shape[0]} main-path rays: against its "
            f"plain version {n_diff} lanes differ, max |err| {err:.3g} "
            f"(limit 0); against K2 t equal: {t_same}, valid equal: "
            f"{valid_same}, {ties} tie rays keep another triangle; "
            "overflow flag 0")
        check(n_diff == 0, f"K4 P={width} differs from its plain version")
        check(t_same and valid_same, f"K4 P={width}: t/valid != K2's")

        def prim_of(s_):
            return torch.where(s_ >= 0, order[s_.clamp(min=0).long()], -1)

        err_b = hold(f"K4 P={width} vs K1 brute force, "
                     f"{tri_all.shape[0]} tris",
                     (got[0][k], prim_of(got[1][k]), got[2][k], got[3][k],
                      got[1][k] >= 0), brute)
        out[width] = dict(err=err, err_brute=err_b[0], ties=ties,
                          plain_ms=plain_ms,
                          work=(int(pops.sum()), int(tests.sum())))
    return out


def time_k4(scene, o, d, maxt, k4, k2_work):
    """ms a launch of K4 at each width, with K2 timed beside it in the
    same call, and the bound of each on these rays.  K4 computes K2's
    function, so the bound counts the fewer operations of K2's and K4's
    plain work counts (``k2_work``: K2's pops and tests); K4's own
    counts are printed beside it as the work its schedule does."""
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    nodes, tri = scene.bvh_nodes, scene.bvh_tris
    n = o.shape[0]
    n_bytes = 4 * (nodes.numel() + tri.numel()) + 28 * n + 16 * n

    def ops_of(pops, tests):
        return (pops * (4 * OPS_PER_SLAB + OPS_PER_ORDER)
                + tests * FLOP_PER_TEST)

    out = {}
    for width in CT.K4_WIDTHS:
        ms = cuda_ms(lambda: CT.closest_hit(nodes, tri, o, d, maxt,
                                            multi_pop=width), 20)
        ms_k2 = cuda_ms(lambda: CT.closest_hit(nodes, tri, o, d, maxt,
                                               multi_pop=0), 20)
        pops, tests = k4[width]["work"]
        ops = min(ops_of(*k2_work), ops_of(pops, tests))
        b_ms, by = bound_ms(n_bytes, ops)
        out[width] = dict(ms=ms, ms_k2=ms_k2, bound_ms=b_ms, bound_by=by,
                          plain_ms=k4[width]["plain_ms"],
                          pops_per_ray=pops / n, tests_per_ray=tests / n)
        say(f"[time] K4 P={width} at {tri.shape[0]} tris x {n} rays: "
            f"{ms:.4f} ms a launch, K2 {ms_k2:.4f} ms in the same call; "
            f"plain version {k4[width]['plain_ms']:.1f} ms; bound "
            f"{b_ms:.4f} ms by {by} (the function's work: {ops / 1e9:.3f} "
            f"G operations, {n_bytes / 1e6:.1f} MB); K4's own schedule "
            f"{pops / n:.2f} pops, {tests / n:.2f} tests a ray against "
            f"K2's {k2_work[0] / n:.2f} and {k2_work[1] / n:.2f}")
    return out


#: the leaves the training phases differentiate
TRAIN_LEAVES = ("vertices", "bsdfs.reflectance", "emitters.radiance")


def trainable(scene):
    """The scene with TRAIN_LEAVES replaced by copies that require grad,
    and those copies."""
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in scene.leaves().items() if k in TRAIN_LEAVES}
    return scene.with_leaves(leaves), leaves


def zero_counts():
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    for counts in (CI.launches, CT.launches):
        for k in counts:
            counts[k] = 0


def read_counts():
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    return {**CI.launches, **CT.launches}


def fwd_bwd(scene, leaves, spp, seed, integrator=None):
    """One fwd+bwd pass as bench.py's ``_bench_scene`` times it: the loss
    ``mean((img - 0)^2)`` and its gradient w.r.t. ``leaves``.  Returns
    (loss, grads, launches in the forward, launches in the backward)."""
    import torch
    import epsm_mitsuba3_torch as mt
    zero_counts()
    img = mt.render(scene, spp=spp, seed=seed, integrator=integrator)
    loss = torch.mean((img - 0.0) ** 2)
    fwd = read_counts()
    zero_counts()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss, grads, fwd, read_counts()


def train_phase(label, scene, spp, passes, expect_fwd, integrator=None):
    """bench.py's fwd+bwd cell at full width: a warm-up and 3 timed runs
    of ``passes`` fwd+bwd passes.  Every pass must launch ``expect_fwd``
    in the forward and no kernel in the backward (the replay reads the
    recorded trace).  Prints the median wall ms with the range and the
    physical Mrays/s; returns (median ms, Mrays/s, the forward's counts
    of the last run, the trainable scene and its leaves)."""
    import torch
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    walls = []
    sc, leaves = trainable(scene)
    sensor = scene.sensors[0]
    lanes = sensor.width * sensor.height * spp
    torch.cuda.reset_peak_memory_stats()
    for run in ["warm-up", "timed 1", "timed 2", "timed 3"]:
        run_counts = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in range(passes):
            loss, grads, fwd, bwd = fwd_bwd(sc, leaves, spp, p + 1,
                                            integrator)
            for k, n in fwd.items():
                run_counts[k] = run_counts.get(k, 0) + n
            for k, n in expect_fwd.items():
                check(fwd[k] == n, f"{label}: {k} launched {fwd[k]} times "
                      f"in a forward, expected {n}")
            check(sum(bwd.values()) == 0,
                  f"{label}: the replay launched kernels: {bwd}")
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads)
        say(f"[{label}] {run}: {walls[-1]:.1f} ms for {passes} passes, "
            f"loss {float(loss.detach()):.6g}, gradients finite: {finite}; "
            "forward "
            f"launches {run_counts}, backward 0")
        check(finite, f"{label}: loss or gradients not finite")
    rays = lanes * DEPTH * 2 * passes
    timed_walls = sorted(walls[1:])
    median = timed_walls[1]
    mrays = rays / (median / 1e3) / 1e6
    say(f"[{label}] {sensor.width}^2 x {spp} spp, {passes} fwd+bwd passes "
        f"of {lanes} lanes, depth {DEPTH}: wall median {median:.1f} ms "
        f"(range {timed_walls[0]:.1f}-{timed_walls[-1]:.1f}); "
        f"{mrays:.2f} physical Mrays/s fwd+bwd; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    CT.raise_on_overflow(scene.device)
    return median, mrays, run_counts, (sc, leaves)


def rel_l2(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def blob_normals(d):
    """``cornell_box_mesh``'s dict with outward vertex normals on the
    sphere.  Its faces wind inward, so without normals the one-sided
    diffuse sphere is black from outside and detached PRB gives its
    vertices no gradient; with interpolated normals the hit's
    barycentrics carry the vertices' gradient into the shading."""
    import numpy as np
    v = np.asarray(d["blob"]["vertices"])
    d["blob"]["normals"] = v - np.asarray([0.0, 0.7, 0.0], np.float32)
    return d


def grad_card_vs_cpu(label, d, spp):
    """The fwd+bwd gradient of every TRAIN_LEAVES leaf on the card
    (kernels) against the CPU's (plain versions)."""
    import torch
    import epsm_mitsuba3_torch as mt
    out = {}
    for dev in ("cuda", "cpu"):
        sc, leaves = trainable(mt.load_dict(d, device=dev))
        img = mt.render(sc, spp=spp, seed=0, device=dev)
        loss = (img ** 2).mean()
        out[dev] = torch.autograd.grad(loss, list(leaves.values()))
    errs = {k: rel_l2(a.cpu(), b) for k, a, b in
            zip(TRAIN_LEAVES, out["cuda"], out["cpu"])}
    norms = {k: float(b.norm()) for k, b in zip(TRAIN_LEAVES, out["cpu"])}
    res = d["sensor"]["film"]["width"]
    say(f"[grad cpu] {label} {res}^2 x {spp} spp: |g_gpu - g_cpu| / |g_cpu| "
        + ", ".join(f"{k} {e:.3g} (|g| {norms[k]:.4g})"
                    for k, e in errs.items())
        + "  [limit 1e-3 each]")
    for k, e in errs.items():
        check(e <= 1e-3, f"{label}: card and CPU gradients of {k} differ "
              f"by {e} relative")


def adam_phase(mesh_dict, gen):
    """The port's ``app/optim.run("prb", ...)`` for 3 iterations on
    cornell_box_mesh: theta is a translation of the sphere's vertices,
    applied through ``set_vertices``.  Afterwards K2 on the re-packed
    scene must equal K1's brute force over the moved vertices."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.app import optim
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.ops import intersect as I
    scene = mt.load_dict(blob_normals(mesh_dict))
    blob = (scene.face_shape == scene.face_shape.max())
    moving = torch.zeros(scene.vertices.shape[0], dtype=torch.bool,
                         device=scene.device)
    moving[scene.faces[blob].long().flatten()] = True
    v0 = scene.vertices

    def apply(sc, theta):
        return sc.set_vertices(
            v0 + torch.where(moving[:, None], theta["t"][None, :], 0.0))

    exp = dict(scene=scene, apply=apply,
               init_theta={"t": torch.zeros(3)},
               target_theta={"t": torch.tensor([0.1, -0.05, 0.08],
                                               device=scene.device)},
               gt_spp=ADAM_GT_SPP, it=3, spp=MESH_CHUNK, resolution=RES,
               max_depth=DEPTH, match_res=64, output=str)
    losses = []
    t0 = time.perf_counter()
    opt, history = optim.run(
        "prb", exp, iters=3,
        log=lambda it, loss, theta: losses.append(loss))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    for it, (loss, h) in enumerate(zip(losses, history)):
        say(f"[adam] iteration {it}: loss {loss:.6g}, theta "
            f"{[round(float(x), 6) for x in h['t']]}")
    thetas = [h["t"] for h in history]
    import numpy as np
    check(all(np.isfinite(x).all() for x in thetas)
          and all(np.isfinite(x) for x in losses), "adam: not finite")
    check(float(np.abs(thetas[-1]).max()) > 0, "adam: theta did not move")
    say(f"[adam] 3 iterations at {RES}^2 x {MESH_CHUNK} spp, ground truth "
        f"at {ADAM_GT_SPP} spp: {wall:.1f} ms in all")
    final = apply(scene, {"t": opt["t"]})
    o, d, maxt = main_path_rays(final, gen, MESH_CHUNK)
    k = slice(0, 65536)
    t, slot, u, v = CT.closest_hit(final.bvh_nodes, final.bvh_tris, o[k],
                                   d[k], maxt[k])
    prim = torch.where(slot >= 0, final.bvh.order[slot.clamp(min=0).long()],
                       -1)
    tri = CI.pack_tris(final.vertices, final.faces)
    ref = I.ray_intersect_brute(tri, o[k], d[k], maxt[k])
    hold("adam: K2 on the re-packed scene vs K1 brute force, moved "
         "vertices", (t, prim, u, v, slot >= 0),
         (ref[0], ref[1].long(), ref[2], ref[3], ref[1] >= 0))


def card_vs_cpu(label, d, spp):
    """Render the scene dict ``d`` on the card and on the CPU."""
    import epsm_mitsuba3_torch as mt
    img_gpu = mt.render(mt.load_dict(d), spp=spp, seed=0).cpu()
    img_cpu = mt.render(mt.load_dict(d, device="cpu"), spp=spp, seed=0,
                        device="cpu")
    diff = (img_gpu - img_cpu).abs()
    mad, mean = float(diff.mean()), float(img_cpu.mean())
    within = float((diff.amax(-1) <= 1e-3).float().mean())
    say(f"[cpu] {label} 64^2 x {spp} spp: mean |gpu - cpu| {mad:.3g} (limit "
        f"{1e-3 * mean:.3g} = 1e-3 x mean {mean:.4f}); {100 * within:.2f} % "
        "of pixels within 1e-3 (limit 99 %)")
    check(mad <= 1e-3 * mean and within >= 0.99,
          f"{label}: card and CPU renders disagree")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on "
              "the GPU", file=sys.stderr)
        return 1
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import _native
    from epsm_mitsuba3_torch.ops import bvh as BT
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.scenes import cornell_box, cornell_box_mesh

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    gpu = gpu_line()
    say(f"[device] {gpu} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {name} x{torch.cuda.device_count()}")

    # -- 1. build: every compiler at once ----------------------------------
    t0 = time.perf_counter()
    _native.build([CI.SPEC, CT.SPEC, BT.SPEC])
    CI.build()
    CT.build()
    say(f"[build] K1, K2/K4/K3 (nvcc) and the BVH builder (g++) built in "
        f"{time.perf_counter() - t0:.1f} s")
    for lib in (CI.SPEC.name, CT.SPEC.name):
        for line in _native.build_logs.get(lib, "").splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line or "stack frame" in line:
                say(f"[build] {lib}: {line.strip()}")

    # -- 2. K1 against its plain version ------------------------------------
    gen = torch.Generator(device=dev).manual_seed(1)
    box = mt.load_dict(cornell_box(res=RES, spp=SPP_CHUNK, max_depth=DEPTH))
    tri_box = CI.pack_tris(box.vertices, box.faces)
    rays_box = main_path_rays(box, gen, SPP_CHUNK)
    err_box = compare_k1("Cornell-box shape", tri_box, *rays_box)
    err_big = compare_k1("largest shape", *soup_rays(4096, 65536, gen, dev))
    times = time_k1(tri_box, *rays_box)
    for k, v in times.items():
        say(f"[time] {k} at 12 tris x {rays_box[0].shape[0]} rays: "
            f"{v['ms']:.4f} ms a launch (plain version {v['plain_ms']:.3f} "
            f"ms), bound {v['bound_ms']:.4f} ms by {v['bound_by']}")
    big_times = time_k1(*soup_rays(4096, 65536, gen, dev))
    for k, v in big_times.items():
        say(f"[time] {k} at 4096 tris x 65536 rays: {v['ms']:.4f} ms a "
            f"launch (plain {v['plain_ms']:.3f} ms), bound "
            f"{v['bound_ms']:.4f} ms by {v['bound_by']}")
    del rays_box

    # -- 3. the Cornell box at full width ----------------------------------
    scene = mt.load_dict(cornell_box(res=RES, spp=SPP, max_depth=DEPTH))
    n_passes = SPP // SPP_CHUNK
    _, counts_box = render_phase(
        "render box", scene, SPP, SPP_CHUNK,
        {"mt_closest_hit": DEPTH * n_passes, "mt_any_hit": DEPTH * n_passes,
         "bvh4_closest_hit": 0, "bvh4_any_hit": 0})
    profile_pass(f"render box, one {SPP_CHUNK}-spp pass",
                 lambda: mt.render(scene, spp=SPP_CHUNK, seed=7),
                 ("mt_closest", "mt_any"))
    del scene

    # -- 4. K2/K3 against their plain versions --------------------------------
    t0 = time.perf_counter()
    mesh = mt.load_dict(cornell_box_mesh(res=RES, spp=MESH_CHUNK,
                                         max_depth=DEPTH))
    torch.cuda.synchronize()
    say(f"[mesh] cornell_box_mesh: {mesh.faces.shape[0]} triangles, "
        f"{mesh.bvh.meta.shape[0]} binary nodes over {mesh.bvh.n_levels} "
        f"levels, {mesh.bvh_nodes.shape[0]} BVH4 records; loaded with its "
        f"BVH in {time.perf_counter() - t0:.2f} s")
    rays_mesh = main_path_rays(mesh, gen, MESH_CHUNK)
    bvh = compare_bvh(mesh, *rays_mesh)

    # -- 5. K2/K3 times ------------------------------------------------------
    bvh_times = time_bvh(mesh, *rays_mesh, bvh["plain_ms"], bvh["work"])

    # -- 5b. K4 against its plain version, K2 and the brute force ---------
    k4 = compare_k4(mesh, *rays_mesh)
    k4_times = time_k4(mesh, *rays_mesh, k4, bvh["work"][:2])
    del rays_mesh

    # -- 6. the BVH slice at full width ------------------------------------
    n_mesh = MESH_SPP // MESH_CHUNK
    _, counts_mesh = render_phase(
        "render mesh", mesh, MESH_SPP, MESH_CHUNK,
        {"mt_closest_hit": 0, "mt_any_hit": 0,
         "bvh4_closest_hit": DEPTH * n_mesh, "bvh4_any_hit": DEPTH * n_mesh})
    profile_pass(f"render mesh, one {MESH_CHUNK}-spp pass",
                 lambda: mt.render(mesh, spp=MESH_CHUNK, seed=7),
                 ("bvh4_closest", "bvh4_any"))
    del mesh

    # -- 7. card against CPU --------------------------------------------------
    card_vs_cpu("cornell_box", cornell_box(res=64, spp=4, max_depth=DEPTH), 4)
    card_vs_cpu("cornell_box_mesh",
                cornell_box_mesh(res=64, spp=4, max_depth=DEPTH), 4)

    # -- 8. fwd+bwd at full width: bench.py's toy and bvh cells -------------
    box = mt.load_dict(cornell_box(res=RES, spp=SPP_CHUNK, max_depth=DEPTH))
    _, _, train_box, (sc_box, lv_box) = train_phase(
        "train box", box, SPP_CHUNK, BOX_PASSES,
        {"mt_closest_hit": DEPTH, "mt_any_hit": DEPTH,
         "bvh4_closest_hit": 0, "bvh4_any_hit": 0})
    profile_pass(f"train box, one {SPP_CHUNK}-spp fwd+bwd pass",
                 lambda: fwd_bwd(sc_box, lv_box, SPP_CHUNK, 99),
                 ("mt_closest", "mt_any"))
    del box, sc_box, lv_box
    mesh = mt.load_dict(cornell_box_mesh(res=RES, spp=MESH_CHUNK,
                                         max_depth=DEPTH))
    _, _, train_mesh, (sc_mesh, lv_mesh) = train_phase(
        "train mesh", mesh, MESH_CHUNK, MESH_PASSES,
        {"bvh4_closest_hit": DEPTH, "bvh4_closest_hit_mp": 0,
         "bvh4_any_hit": DEPTH, "mt_closest_hit": 0, "mt_any_hit": 0})
    profile_pass(f"train mesh, one {MESH_CHUNK}-spp fwd+bwd pass",
                 lambda: fwd_bwd(sc_mesh, lv_mesh, MESH_CHUNK, 99),
                 ("bvh4_closest", "bvh4_any"))
    mp = {"multi_pop": 4}
    _, _, train_mp, _ = train_phase(
        "train mesh K4", mesh, MESH_CHUNK, MESH_PASSES,
        {"bvh4_closest_hit": 0, "bvh4_closest_hit_mp": DEPTH,
         "bvh4_any_hit": DEPTH, "mt_closest_hit": 0, "mt_any_hit": 0}, mp)
    l2, g2, _, _ = fwd_bwd(sc_mesh, lv_mesh, MESH_CHUNK, 1)
    l4, g4, _, _ = fwd_bwd(sc_mesh, lv_mesh, MESH_CHUNK, 1, mp)
    errs = {k: rel_l2(a, b) for k, a, b in zip(TRAIN_LEAVES, g4, g2)}
    say(f"[train mesh K4] one pass, seed 1: loss K4 {float(l4):.8g}, K2 "
        f"{float(l2):.8g}; |g_K4 - g_K2| / |g_K2| "
        + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
        + "  [limit 1e-4 each: only tie rays may differ]")
    for k, e in errs.items():
        check(e <= 1e-4, f"K4 and K2 gradients of {k} differ by {e}")
    del mesh, sc_mesh, lv_mesh

    # -- 9. Adam on the mesh, through set_vertices -----------------------------
    adam_phase(cornell_box_mesh(res=RES, spp=MESH_CHUNK, max_depth=DEPTH),
               gen)

    # -- 10. gradients on the card against the CPU -----------------------------
    box64 = cornell_box(res=64, spp=4, max_depth=DEPTH)
    for k in ("floor", "ceiling", "back", "left", "right"):
        box64[k]["face_normals"] = True
    grad_card_vs_cpu("cornell_box (face normals)", box64, 4)
    grad_card_vs_cpu("cornell_box_mesh (sphere normals)", blob_normals(
        cornell_box_mesh(res=64, spp=4, max_depth=DEPTH)), 4)

    # -- kernels line: launches of the fwd+bwd cells' last timed run ----------
    kernels = []
    for i, k in enumerate(("mt_closest_hit", "mt_any_hit")):
        v = times[k]
        kernels.append({
            "name": k, "route": "cuda",
            "source": "epsm_mitsuba3_torch/csrc/mt_intersect.cu",
            "replaces": "epsm_mitsuba3_tpu/ops/pallas_intersect.py:25",
            "launches": train_box[k],
            "max_abs_err": max(err_box[i], err_big[i]),
            "ms": v["ms"], "plain_ms": v["plain_ms"],
            "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
            "library_ms": None})
    for i, (k, line) in enumerate((("bvh4_closest_hit", 164),
                                   ("bvh4_any_hit", 446))):
        v = bvh_times[k]
        kernels.append({
            "name": k, "route": "cuda",
            "source": "epsm_mitsuba3_torch/csrc/bvh_traverse.cu",
            "replaces": f"epsm_mitsuba3_tpu/ops/pallas_traverse.py:{line}",
            "launches": train_mesh[k], "max_abs_err": bvh["err"][i],
            "ms": v["ms"], "ms_unsorted": v["ms_unsorted"],
            "ms_sorted": v["ms_sorted"], "ms_presorted": v["ms_presorted"],
            "plain_ms": v["plain_ms"],
            "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
            "library_ms": None})
    v = k4_times[4]
    kernels.append({
        "name": "bvh4_closest_hit_mp", "route": "cuda",
        "source": "epsm_mitsuba3_torch/csrc/bvh_traverse.cu",
        "replaces": "epsm_mitsuba3_tpu/ops/pallas_traverse.py:308",
        "multi_pop": 4, "launches": train_mp["bvh4_closest_hit_mp"],
        "max_abs_err": k4[4]["err"], "tie_rays": k4[4]["ties"],
        "ms": v["ms"], "ms_k2_same_call": v["ms_k2"],
        "ms_p2": k4_times[2]["ms"], "plain_ms": v["plain_ms"],
        "plain_ms_p2": k4_times[2]["plain_ms"],
        "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
        "schedule_pops_per_ray": v["pops_per_ray"],
        "schedule_tests_per_ray": v["tests_per_ray"],
        "library_ms": None})
    say(json.dumps({"kernels": kernels}))
    say(f"[device] {gpu}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
