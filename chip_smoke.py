#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and hold every
hand-written kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (any failed check raises, and the script exits non-zero):

1. build kernels K1 (``csrc/mt_intersect.cu``) and K2/K4/K3
   (``csrc/bvh_traverse.cu``) with nvcc for sm_90a and the BVH builder
   (``native/bvh.cpp``) and the OBJ parser (``native/meshio.cpp``) with
   g++, all at once, and print the card's name
   and power limit and each kernel's registers, stack and spills (K4's
   by instantiation);
2. K1's closest-hit and any-hit entries against the plain versions on the
   card, bit for bit, at three shapes: (i) the Cornell box's 12 triangles
   against 2^20 camera and bounce rays, some dead; (ii) the largest scene
   K1 serves, 4,096 triangles, against 65,536 rays; (iii) the same against
   2^20 rays, a user's pass; the main path's launch, every step of
   ``cuda_intersect.STEPS`` and 1,000-row tiles, each timed on the device
   alone beside the bound (the plain versions timed at (i) and (ii)); then
   the rays one 4-spp box pass hands to ``closest_hit`` / ``any_hit``
   (wrapped in this script), held bit for bit and timed depth by depth;
   then every step at 12 to 4,096 triangles and 2^16 to 2^21 rays, held
   bit for bit and timed beside the launch ``launch_rule`` picks;
3. the Cornell box's primal render at full width: ``render(load_dict(
   cornell_box(512, 64, 6)), spp=64, spp_chunk=4)``: a warm-up and five
   timed renders, with the launch counts set to 0 before and read after
   each;
4. K2/K3 against their plain versions on ``cornell_box_mesh``'s 2^21
   camera and bounce rays (a tenth dead), bit for bit (0 lanes may
   differ), as is the reference (K2's former one-thread-a-ray walk), and
   on 65,536 of them against K1's plain brute force over all 64,812
   triangles; the stack-overflow flag stays 0;
5. K4 at P = 2 and 4 on the same rays against its plain version (every
   output equal, for the main path's launch and each design step of
   ``cuda_traverse.K4_STEPS``), against K2 (t and valid equal, tie rays
   counted) and against the brute force; then the times of K2, the
   reference, K3 and K4 at both widths, with the rays unsorted,
   Morton-sorted (sort included) and pre-sorted, in two rounds (the
   second reversed), beside the plain versions' and the bound, K2, K3
   and K4 also on device time alone; every K4 launch at both widths on
   device time alone beside K2 and the reference; K2 and K3 at each
   design step, each equal to the main path's launch; the lane
   utilisation of K2, K4 at both widths and the reference (counting
   builds); and, on the rays one 8-spp mesh pass hands to
   ``closest_hit`` / ``any_hit`` (the two wrapped in this script), K2
   and K3 against the reference, K4 against its plain version, all
   timed, depth by depth;
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
   one profiled pass each (the mesh's with K2 and with K4);
9. three iterations of ``app/optim.run("prb_hybrid", ...)`` at thres 0
   on the mesh at 512^2
   x 8 spp, theta a translation of the sphere through ``set_vertices``;
   then K2 on the re-packed scene against K1's brute force over the moved
   vertices;
10. the fwd+bwd gradients at 64^2 x 4 spp on the card against the CPU's,
    for both scenes;
11. [epsm mesh]: bench.py's ``manifold_iter`` at its own size, the
    ``manifold`` integrator on cornell_box_mesh at 128^2 x 8 spp with the
    Sinkhorn matcher at 128^2: a warm-up and 4 timed iterations, ms by
    phase (forward render, Sinkhorn match, logged pass, first hit,
    Jacobians, solves, injection, PRB recording pass and replay) by CUDA
    events, K2/K3 launches an iteration (exactly 25 / 18), the gradient
    finite and non-zero, peak memory, one profiled iteration;
12. [epsm cornellbox]: ``app/optim.run("manifold_caustic_hybrid", ...)``
    on ``app/exp/cornellbox.make`` at 512^2, six lights, depth 6,
    match_res 128, spp 32 (published 256) and a 64-spp ground truth, 3
    iterations at thres 2 (the switch to PRB and the Adam reset run): ms,
    loss, theta and K1 launches an iteration, each count exact;
13. [epsm card vs cpu]: a manifold_caustic theta gradient on cornellbox at
    32^2 on the card and on the CPU, and the Sinkhorn matcher at 128^2 on
    the card and the CPU against float64;
14. [epsm experiments]: ``run`` on ``app/exp``'s egg (a glass sphere,
    manifold_caustic, depth 6), glossyball (a GGX rough-conductor sphere,
    theta its translation and roughness), highlight (a rough-conductor
    floor) and shadow (400 spheres, 1,587,204 triangles in a BVH) at
    512^2, match_res 128, 3 iterations each (spp and ground truth cut,
    ``EXP_CELLS``): ms an iteration and by phase, launches (each count
    exact), theta and its gradients finite and non-zero, peak memory,
    device busy share of one profiled iteration, shadow's BVH build and
    refit + re-pack; bunny, bathroom and bedroom one iteration each; K1
    on one egg pass's rays and K2/K3 on one shadow pass's rays, each held
    bit for bit against its plain version and timed beside its bound; the
    card against the CPU on glossyball's theta gradients and egg's
    glass-vertex gradients at 64^2 x 4 spp;
15. [scene files]: ``cornell_box_mesh(512, 16, 6)`` written to a
    temporary directory (the sphere a binary PLY with vertex normals, the
    floor an OBJ, the back wall a .serialized file, the XML through
    ``dict_to_xml`` with a ``$spp`` parameter) and loaded with
    ``load_file``: arrays, BVH and K2/K3 records bit for bit
    ``load_dict``'s, the 512^2 x 16 spp renders (passes of 8) bit for
    bit, with exact K2/K3 counts; parse, mesh-load, BVH-build and render
    times; ``cli.main`` to an EXR equal to ``render``'s image;
    ``traverse().update()`` moving the sphere against ``set_vertices``,
    then K2 on the re-packed tree against K1's brute force;
16. [glassslab]: ``run("manifold_caustic", glassslab.make(...))`` at the
    published widths (512^2, spp 64, depth 4, match_res 256, grid 16),
    ground truth 64 spp, 2 iterations (of 1,000): ms an iteration and by
    phase, K1 launches (each count exact), the normal field and its
    gradient finite and non-zero, peak memory, the busy share of one
    profiled iteration; the normal-field gradient on the card against the
    CPU at 64^2 x 4 spp;
17. [camera]: the box (K1) and the mesh (K2/K3) rendered at 512^2 with no
    rfilter (the hdrfilm's default gaussian, splatted by the roll-sum
    ``splat_coalesced``) and the stratified sampler, at 64 and 16 spp
    (launches exact, wall ms, peak memory, one profiled pass each); the
    mesh's fwd+bwd cell with the same film; the gaussian film of one
    pass on its own (ms, launches and memory of the film, its adjoint and
    the general scatter ``splat``; the roll-sum bit for bit alike from
    run to run, the scatter within 1e-5); two ``manifold`` iterations of
    the epsm-mesh cell with a gaussian sensor on a stratified scene, whose
    passes must seed the independent sampler (PRB the scene's); and the
    card against the CPU at 64^2: every filter with the independent and
    the stratified sampler, each sampler kind at spp 16 and 9, each
    sensor kind (a thin lens of aperture 0.08, a batch sensor of two
    views), PRB gradients through two films, the manifold backward.

The last lines are one JSON line of kernel numbers and one JSON line
``{"ok": true, "device": {...}}``.  Without CUDA the script exits 1 and
prints no result.
"""
import dataclasses
import json
import math
import subprocess
import sys
import time

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; and FP32
#: instructions/s outside the tensor cores: 132 SMs x 128 FP32 lanes x
#: 1.98 GHz boost clock.  The data sheet's 67 TFLOP/s counts an FMA as two
#: operations; the kernels are built with --fmad=false and the counts
#: below count each multiply, add, min/max and compare as one.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 132 * 128 * 1.98e9
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
#: K1's launch-rule sweep: triangle counts from the box's 12 to the 4,096
#: that ``ops/accel.py`` sends to K1 at most with a BVH, ray counts from
#: 65,536 to one 512^2 x 8 spp pass
SWEEP_TRIS = (12, 32, 64, 128, 256, 512, 1024, 2048, 4096)
SWEEP_RAYS = tuple(2 ** k for k in range(16, 22))
#: [epsm mesh]: bench.py's ``manifold_iter`` (bench.py:196-236) at its own
#: size: cornell_box_mesh at 128^2 x 8 spp, depth 6, match_res 128 (the
#: reference's backward budget, 128^2 at spp 8), a warm-up and 4 timed
#: iterations
EPSM_RES, EPSM_SPP, EPSM_ITERS = 128, 8, 4
#: [epsm cornellbox]: app/exp/cornellbox.make at its published widths
#: (512^2, six lights, depth 6, match_res 128); spp 32 of the published
#: 256 and a ground truth at 64 spp of the default 512, to fit the time
#: limit; 3 iterations of manifold_caustic_hybrid with thres 2
CB_RES, CB_SPP, CB_GT_SPP, CB_ITERS, CB_THRES = 512, 32, 64, 3, 2
#: [epsm experiments]: app/exp's egg, glossyball, highlight and shadow at
#: their published widths (512^2, match_res 128, each config's depth and
#: method; shadow's 400 spheres), EXP_ITERS iterations of run(); (config,
#: spp, ground-truth spp): spp cut from the published 256 (egg), 64
#: (highlight, shadow) and a ground truth of the default 512 cut, for the
#: time limit
EXP_RES, EXP_MATCH, EXP_ITERS = 512, 128, 3
EXP_CELLS = (("egg", 32, 32), ("glossyball", 32, 32), ("highlight", 32, 32),
             ("shadow", 16, 16))
#: bunny, bathroom and bedroom (procedural stand-ins): one iteration each
#: at 512^2 and this spp (ground truth too)
EXP_ONE, EXP_ONE_SPP = ("bunny", "bathroom", "bedroom"), 4
#: [scene files]: cornell_box_mesh(512, 16, 6) written out (the sphere as a
#: binary PLY, the floor as an OBJ, the back wall as a .serialized file,
#: the scene as XML) and loaded back; rendered at the mesh cell's size,
#: 16 spp in passes of 8
SF_SPP, SF_CHUNK = 16, 8
#: [glassslab]: app/exp/glassslab.make at its published widths (512^2,
#: spp 64, depth 4, match_res 256, a 16 x 16 grid), ground truth 64 spp
#: (published 512), GS_ITERS iterations of run("manifold_caustic") of the
#: published 1,000
GS_SPP, GS_MATCH, GS_ITERS = 64, 256, 2


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


def device_ms(fn, iters, warm=3):
    """Mean ms a call of ``fn`` takes on the device, by CUDA events, after
    warm-up: the calls are queued behind a sleeping kernel long enough for
    the host to launch all of them, so the host's time a launch (the
    wrappers' checks) does not show between them."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0  # host and device, an upper bound
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2e9, 1.5 * iters * once * 2e9)))
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


def ptxas_usage(log):
    """{function: {"registers", "stack", "spill_stores", "spill_loads"}}
    from ``nvcc -Xptxas=-v`` output, keyed by the mangled name."""
    import re
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w$]+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def k4_registers(log):
    """ptxas's registers, stack and spills of each K4 instantiation
    (``bvh4_closest_mp_warp_kernel<layout, threads, P, fetch, count>``),
    keyed "P=<P> <layout> <threads> <fetch>[ counting]"."""
    import re
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    layouts = {v: k for k, v in CT.LAYOUTS.items()}
    fetches = {v: k for k, v in CT.FETCHES.items()}
    out = {}
    for name, use in ptxas_usage(log).items():
        m = re.search(r"bvh4_closest_mp_warp_kernelILi(\d+)ELi(\d+)ELi(\d+)"
                      r"ELi(\d+)ELb([01])E", name)
        if m:
            lay, threads, p, fetch, count = (int(x) for x in m.groups())
            out[f"P={p} {layouts[lay]} {threads} {fetches[fetch]}"
                + (" counting" if count else "")] = use
    return dict(sorted(out.items()))


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


def anyhit_tests(tri, o, d, maxt, chunk=512, ray_chunk=2 ** 17):
    """Ray-triangle tests the any-hit entry needs on these rays: up to
    and including each ray's first hit; none for a ray of no extent.
    Returns their total and the most one ray needs (how far into the
    table the launch must read)."""
    import torch
    from epsm_mitsuba3_torch.ops import intersect as I
    f = tri.shape[0]
    total = most = 0
    for s in range(0, o.shape[0], ray_chunk):
        k = slice(s, s + ray_chunk)
        first = torch.full((o[k].shape[0],), f, dtype=torch.int64,
                           device=o.device)
        for base, _, hit in I.chunk_hits(tri, o[k], d[k], maxt[k], chunk):
            idx = torch.arange(base, base + hit.shape[1], device=o.device)
            first = torch.minimum(first,
                                  torch.where(hit, idx, f).amin(dim=1))
        tests = torch.where(maxt[k] > 1e-6,
                            torch.where(first < f, first + 1, f), 0)
        total += int(tests.sum())
        most = max(most, int(tests.max()) if tests.numel() else 0)
    return total, most


def ray_bytes(maxt, out_bytes):
    """Bytes of the rays a launch must read and of what it writes: the
    origin, direction and maxt (28 B) of a live ray, only the maxt of a
    dead one (maxt <= 1e-6: its miss needs no test), and ``out_bytes``
    written a ray."""
    n = maxt.shape[0]
    live = int((maxt > 1e-6).sum())
    return 28 * live + 4 * (n - live) + out_bytes * n


def k1_bound(tri, o, d, maxt, any_hit):
    """K1's bound on these rays: a live ray tests every triangle (closest
    hit) or those up to its first hit (any hit), a dead ray none; the
    table is read once, as far as the most tests one ray needs."""
    f = tri.shape[0]
    if any_hit:
        tests, reach = anyhit_tests(tri, o, d, maxt)
    else:
        live = int((maxt > 1e-6).sum())
        tests, reach = live * f, f if live else 0
    return bound_ms(36 * reach + ray_bytes(maxt, 1 if any_hit else 16),
                    tests * FLOP_PER_TEST)


#: bytes of one BVH4 record (32 floats) and of one triangle row of
#: ``tri_k`` (48 B), as K2/K3 read them
NODE_BYTES, ROW_BYTES = 128, 48


def bvh_work(maxt, work, any_hit):
    """(bytes, operations) of K2's (or K3's) function on these rays, from
    the plain version's ``work`` on them, (pops, tests, records read,
    rows read): each record and row some ray needs read once, and the
    rays' bytes (``ray_bytes``); 4 slab tests a pop (+ the ordering of
    K2's pushes) and a triangle test's operations."""
    pops, tests, n_nodes, n_rows = work
    ops = (pops * (4 * OPS_PER_SLAB + (0 if any_hit else OPS_PER_ORDER))
           + tests * FLOP_PER_TEST)
    return (n_nodes * NODE_BYTES + n_rows * ROW_BYTES
            + ray_bytes(maxt, 1 if any_hit else 16)), ops


def bvh_plain_work(nodes, tri, o, d, maxt, any_hit):
    """The plain closest hit's (or any hit's) work on these rays: (pops,
    tests, records read, rows read)."""
    from epsm_mitsuba3_torch.ops import traverse as TR
    plain = (TR.bvh_ray_test_plain if any_hit
             else TR.bvh_ray_intersect_plain)
    out = plain(nodes, tri, o, d, maxt, counts=True, reads=True)
    return tuple(int(x.sum()) for x in out[-4:])


def bound_ms(n_bytes, n_flop):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_flop = n_flop / PEAK_FP32_OPS_PER_S * 1e3
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


K1_FIELDS = ("t", "prim", "u", "v", "occ")


def plain_k1(tri, o, d, maxt, ray_chunk=2 ** 17):
    """The plain versions' (t, prim, u, v, occ), in chunks of rays."""
    import torch
    from epsm_mitsuba3_torch.ops import intersect as I
    outs = []
    for s in range(0, o.shape[0], ray_chunk):
        k = slice(s, s + ray_chunk)
        outs.append((*I.ray_intersect_brute(tri, o[k], d[k], maxt[k]),
                     I.ray_test_brute(tri, o[k], d[k], maxt[k])))
    return tuple(torch.cat(x) for x in zip(*outs))


def k1_calls(tri):
    """Every K1 launch ``chip_smoke.py`` holds and times, by name: the
    main path's ("main") and each step of ``cuda_intersect.STEPS`` (the
    launches ``launch_rule`` picks among), for the closest hit and the any
    hit."""
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    closest = {"main": lambda o, d, m: CI.closest_hit(tri, o, d, m)}
    anyh = {"main": lambda o, d, m: CI.any_hit(tri, o, d, m)}
    for name, v in CI.STEPS.items():
        if name in CI.CLOSEST_STEPS:
            closest[name] = (lambda v_: lambda o, d, m: CI.launch_closest(
                tri, o, d, m, v_))(v)
        if name in CI.ANY_STEPS:
            anyh[name] = (lambda v_: lambda o, d, m: CI.launch_any(
                tri, o, d, m, v_))(v)
    return {"mt_closest_hit": closest, "mt_any_hit": anyh}


def compare_k1(label, tri, o, d, maxt):
    """Both K1 entries against the plain versions on the same inputs, bit
    for bit (0 lanes may differ in t, prim, u, v or occ): the main path's
    launch, every design step, and a launch that walks the table in tiles
    of 1,000 rows.  Returns the largest absolute errors (t, u, v; occ) of
    the main launch."""
    from dataclasses import replace
    import torch
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    ref = plain_k1(tri, o, d, maxt)
    calls = k1_calls(tri)
    main = (*calls["mt_closest_hit"]["main"](o, d, maxt),
            calls["mt_any_hit"]["main"](o, d, maxt))
    torch.cuda.synchronize()
    err = hold(f"K1 {label}, {tri.shape[0]} tris", main, ref)
    got = {"main": main}
    for name in set(calls["mt_closest_hit"]) | set(calls["mt_any_hit"]):
        if name == "main":
            continue
        c = calls["mt_closest_hit"].get(name, calls["mt_closest_hit"]["main"])
        a = calls["mt_any_hit"].get(name, calls["mt_any_hit"]["main"])
        got[name] = (*c(o, d, maxt), a(o, d, maxt))
    if tri.shape[0] > 1000:
        f, n = tri.shape[0], o.shape[0]
        got["tiles of 1000"] = (
            *CI.launch_closest(tri, o, d, maxt, replace(
                CI.launch_rule(f, n, "closest"), tile=1000)),
            CI.launch_any(tri, o, d, maxt, replace(
                CI.launch_rule(f, n, "any"), tile=1000)))
    torch.cuda.synchronize()
    for name, g in got.items():
        diff = {k: int((a != b).sum()) for k, a, b in zip(K1_FIELDS, g, ref)}
        check(sum(diff.values()) == 0, f"K1 {label}, launch {name!r} "
              f"differs from the plain versions: {diff}")
    check(bool(torch.equal(main[4], main[1] >= 0)),
          f"K1 {label}: any hit != closest hit's valid")
    say(f"[K1] {label}: the main launch, steps "
        f"{', '.join(CI.STEPS)} and 1,000-row tiles equal the plain "
        f"versions bit for bit on {o.shape[0]} rays (0 lanes differ in "
        f"{', '.join(K1_FIELDS)}); any hit == closest valid")
    return err


def time_k1(tri, o, d, maxt, iters, plain=True):
    """ms a launch of both entries (the main path's launch and every design
    step, two rounds, the second reversed; device time alone) and of their
    plain versions, and the bound of each entry on these inputs."""
    from epsm_mitsuba3_torch.ops import intersect as I
    n, f = o.shape[0], tri.shape[0]
    args = (tri, o, d, maxt)
    calls = k1_calls(tri)
    cases = [(k, name) for k in calls for name in calls[k]]
    runs = {c: [] for c in cases}
    for seq in (cases, cases[::-1]):
        for k, name in seq:
            fn = calls[k][name]
            runs[(k, name)].append(device_ms(lambda: fn(o, d, maxt), iters))
    out = {}
    for name, plain_fn, any_hit in (
            ("mt_closest_hit", I.ray_intersect_brute, False),
            ("mt_any_hit", I.ray_test_brute, True)):
        plain_ms = cuda_ms(lambda: plain_fn(*args), 5) if plain else None
        b_ms, by = k1_bound(*args, any_hit)
        steps = {s: sum(runs[(name, s)]) / 2 for s in calls[name]}
        out[name] = dict(ms=steps.pop("main"), plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=by, steps_ms=steps)
        v = out[name]
        say(f"[time] {name} at {f} tris x {n} rays: {v['ms']:.4f} ms a "
            f"launch (plain version "
            + (f"{plain_ms:.3f} ms" if plain else "not timed")
            + f"), bound {b_ms:.4f} ms by {by} ({b_ms / v['ms']:.1%}); "
            "steps " + ", ".join(f"{s} {t:.4f}" for s, t in steps.items()))
    return out


def render_rays_k1(scene, spp):
    """Record the rays one ``spp`` pass of the box hands to
    ``closest_hit`` and ``any_hit`` (wrapped here, not in the package);
    then on each depth's batch hold the main path's K1 launches against
    the plain versions bit for bit (and the any hit against the closest
    hit's valid on the shadow rays), and time them beside every design step
    (two rounds, the second reversed; device time alone)."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    rec = {"closest": [], "any": []}
    orig = CI.closest_hit, CI.any_hit

    def keep(kind, fn):
        def call(tri, o, d, maxt):
            rec[kind].append((tri.clone(), o.clone(), d.clone(),
                              maxt.clone()))
            return fn(tri, o, d, maxt)
        return call

    CI.closest_hit = keep("closest", orig[0])
    CI.any_hit = keep("any", orig[1])
    try:
        mt.render(scene, spp=spp, seed=5)
    finally:
        CI.closest_hit, CI.any_hit = orig
    torch.cuda.synchronize()
    check(len(rec["closest"]) == DEPTH and len(rec["any"]) == DEPTH,
          f"a pass made {len(rec['closest'])} closest-hit and "
          f"{len(rec['any'])} any-hit calls, expected {DEPTH} each")
    out = []
    for depth, (c, a) in enumerate(zip(rec["closest"], rec["any"])):
        got = (*CI.closest_hit(*c), CI.any_hit(*a))
        ref_c = plain_k1(*c)
        ref_a = plain_k1(*a)
        ref = (*ref_c[:4], ref_a[4])
        diff = {k: int((x != y).sum()) for k, x, y in
                zip(K1_FIELDS, got, ref)}
        check(sum(diff.values()) == 0,
              f"depth {depth}: K1 differs from the plain versions: {diff}")
        check(bool(torch.equal(got[4], ref_a[1] >= 0)),
              f"depth {depth}: any hit != the closest hit's valid")
        calls = {}
        for k, rays in (("closest", c), ("any", a)):
            for name, fn in k1_calls(rays[0])[f"mt_{k}_hit"].items():
                calls[f"{k} {name}"] = (lambda f_, r_: lambda: f_(*r_[1:]))(
                    fn, rays)
        runs = {k: [] for k in calls}
        for seq in (list(calls), list(calls)[::-1]):
            for k in seq:
                runs[k].append(device_ms(calls[k], 20))
        ms = {k: sum(v) / 2 for k, v in runs.items()}
        row = dict(depth=depth, rays=c[1].shape[0],
                   live_closest=int((c[3] > 1e-6).sum()),
                   live_any=int((a[3] > 1e-6).sum()),
                   hits=int((got[1] >= 0).sum()),
                   occluded=int(got[4].sum()), **ms)
        out.append(row)
        say(f"[render rays K1] depth {depth}: {row['rays']} rays "
            f"({row['live_closest']} live, {row['hits']} hits) closest "
            f"{ms['closest main']:.4f} ms; {row['live_any']} live shadow "
            f"rays ({row['occluded']} occluded) any {ms['any main']:.4f} ms; "
            "bit for bit equal to the plain versions; steps "
            + ", ".join(f"{k} {t:.4f}" for k, t in ms.items()
                        if not k.endswith(" main")))
    return out


def k1_rule_sweep(gen, device):
    """K1's steps at each triangle count of SWEEP_TRIS and ray count of
    SWEEP_RAYS, on random soups: every step's results equal the main
    launch's bit for bit, and the plain versions' on the first 65,536
    rays; each step timed (device time alone, two rounds, the second
    reversed) beside the launch ``launch_rule`` picks there, and the
    fastest.  Returns {"F x N": {entry: {step: ms}, "rule": ..., ...}}."""
    import torch
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    out, worst = {}, {}
    for f in SWEEP_TRIS:
        for n in SWEEP_RAYS:
            tri, o, d, maxt = soup_rays(f, n, gen, device)
            calls = k1_calls(tri)
            main = (*calls["mt_closest_hit"]["main"](o, d, maxt),
                    calls["mt_any_hit"]["main"](o, d, maxt))
            k = slice(0, 65536)
            ref = plain_k1(tri, o[k], d[k], maxt[k])
            diff = {name: int((a[k] != b).sum())
                    for name, a, b in zip(K1_FIELDS, main, ref)}
            for kind, fields in (("mt_closest_hit", slice(0, 4)),
                                 ("mt_any_hit", slice(4, 5))):
                for name, fn in calls[kind].items():
                    got = fn(o, d, maxt)
                    got = got if isinstance(got, tuple) else (got,)
                    for field, a, b in zip(K1_FIELDS[fields], got,
                                           main[fields]):
                        diff[f"{name} {field}"] = int((a != b).sum())
            torch.cuda.synchronize()
            check(sum(diff.values()) == 0, f"K1 sweep {f} x {n}: launches "
                  f"differ from the main launch or the plain versions: "
                  f"{ {k_: v for k_, v in diff.items() if v} }")
            cases = [(kind, name) for kind in calls for name in calls[kind]
                     if name != "main"]
            iters = 50 if f * n <= 2 ** 24 else 20 if f * n <= 2 ** 27 else 5
            runs = {c: [] for c in cases}
            for seq in (cases, cases[::-1]):
                for kind, name in seq:
                    fn = calls[kind][name]
                    runs[(kind, name)].append(
                        device_ms(lambda: fn(o, d, maxt), iters))
            row, parts = {}, []
            for kind, short in (("mt_closest_hit", "closest"),
                                ("mt_any_hit", "any")):
                ms = {name: sum(runs[(kind, name)]) / 2
                      for name in calls[kind] if name != "main"}
                rule = CI.launch_rule(f, n, short)
                pick = next(name for name in ms if CI.STEPS[name] == rule)
                best = min(ms, key=ms.get)
                ratio = ms[pick] / ms[best]
                worst[kind] = max(worst.get(kind, (1.0, "")),
                                  (ratio, f"{f} x {n}"))
                row[kind] = dict(ms=ms, rule=pick, fastest=best,
                                 rule_over_fastest=ratio)
                parts.append(f"{short} " + ", ".join(
                    f"{name} {t:.4f}" for name, t in ms.items())
                    + f" -> rule {pick!r}, fastest {best!r} ({ratio:.3f})")
            out[f"{f}x{n}"] = row
            say(f"[K1 rule] {f} tris x {n} rays: " + "; ".join(parts))
    say("[K1 rule] bit for bit equal to the main launch and the plain "
        "versions at every point; the rule's pick over the fastest, at "
        "worst: " + ", ".join(f"{k} {r:.3f} at {at}"
                             for k, (r, at) in worst.items()))
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
    nodes, tri, tri_k = scene.bvh_nodes, scene.bvh_tris, scene.bvh_tris_k
    order = scene.bvh.order.long()
    t, slot, u, v = CT.closest_hit(nodes, tri, o, d, maxt, tri_k=tri_k)
    occ = CT.any_hit(nodes, tri, o, d, maxt, tri_k=tri_k)
    ref = CT.closest_hit_reference(nodes, tri, o, d, maxt)
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
    plain = (t_p, slot_p, u_p, v_p, occ_p)
    for label, got in (("K2/K3", (t, slot, u, v, occ)),
                       ("reference (K2's former walk)", ref)):
        diff = {k: int((a != b).sum()) for k, a, b in
                zip(("t", "slot", "u", "v", "occ"), got, plain)}
        say(f"[K2/K3] {label} against the plain versions, bit for bit on "
            f"{o.shape[0]} rays: lanes differing {diff}  [limit 0 each]")
        check(sum(diff.values()) == 0, f"{label} differs from its plain "
              f"version: {diff}")

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
                work=(bvh_plain_work(nodes, tri, o, d, maxt, False),
                      bvh_plain_work(nodes, tri, o, d, maxt, True)))


def _ref_sorting(nodes, tri):
    """The reference (K2's former walk) as ``closest_hit`` calls a kernel:
    ``sort`` Morton-sorts the rays first and un-sorts the results."""
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT

    def call(o, d, maxt, sort):
        if not sort:
            return CT.closest_hit_reference(nodes, tri, o, d, maxt)
        p = CT._morton_order(nodes, o, d, maxt)
        out = CT.closest_hit_reference(nodes, tri, o[p], d[p], maxt[p])
        return tuple(CT._unsort(x, p) for x in out)
    return call


ORDERS = ("unsorted", "sorted", "presorted")


def time_bvh(scene, o, d, maxt, plain_ms, work, k4):
    """ms a launch of K2, the reference (K2's former walk), K3 and K4 at
    P = 2 and 4, each with the rays unsorted, Morton-sorted (the sort and
    un-sort included) and pre-sorted (the traversal alone on rays already
    in Morton order), timed in two rounds, the second in reverse order,
    and averaged; and each entry's bound on these rays from the plain
    versions' work counts.  K4 and the reference compute K2's function, so
    their bound is K2's; K4's own schedule's pops and tests are printed
    beside it."""
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    nodes, tri, tri_k = scene.bvh_nodes, scene.bvh_tris, scene.bvh_tris_k
    n = o.shape[0]
    pops, tests = work[0][:2]
    work_c = bvh_work(maxt, work[0], False)
    work_a = bvh_work(maxt, work[1], True)
    perm = CT._morton_order(nodes, o, d, maxt)
    pre = (o[perm].contiguous(), d[perm].contiguous(),
           maxt[perm].contiguous())

    def k4_of(width):
        return lambda o_, d_, m_, s_: CT.closest_hit(
            nodes, tri, o_, d_, m_, sort=s_, multi_pop=width, tri_k=tri_k)

    entries = {
        "bvh4_closest_hit": (lambda o_, d_, m_, s_: CT.closest_hit(
            nodes, tri, o_, d_, m_, sort=s_, tri_k=tri_k), work_c,
            plain_ms[0]),
        "bvh4_closest_hit_ref": (_ref_sorting(nodes, tri), work_c,
                                 plain_ms[0]),
        "bvh4_any_hit": (lambda o_, d_, m_, s_: CT.any_hit(
            nodes, tri, o_, d_, m_, sort=s_, tri_k=tri_k), work_a,
            plain_ms[1]),
        "bvh4_closest_hit_mp P=2": (k4_of(2), work_c, k4[2]["plain_ms"]),
        "bvh4_closest_hit_mp P=4": (k4_of(4), work_c, k4[4]["plain_ms"]),
    }
    cases = [(name, kind) for name in entries for kind in ORDERS]
    runs = {c: [] for c in cases}
    for seq in (cases, cases[::-1]):
        for name, kind in seq:
            fn = entries[name][0]
            args = (*pre, False) if kind == "presorted" else (
                o, d, maxt, kind == "sorted")
            runs[(name, kind)].append(cuda_ms(lambda: fn(*args), 20))
    out = {}
    for name, (_, (n_bytes, ops), p_ms) in entries.items():
        ms = {kind: sum(runs[(name, kind)]) / 2 for kind in ORDERS}
        b_ms, by = bound_ms(n_bytes, ops)
        out[name] = dict(
            ms=ms["sorted" if CT.SORT_RAYS else "unsorted"],
            ms_unsorted=ms["unsorted"], ms_sorted=ms["sorted"],
            ms_presorted=ms["presorted"],
            rounds={kind: runs[(name, kind)] for kind in ORDERS},
            plain_ms=p_ms, bound_ms=b_ms, bound_by=by)
        say(f"[time] {name} at {tri.shape[0]} tris x {n} rays: unsorted "
            f"{ms['unsorted']:.4f} ms, Morton-sorted {ms['sorted']:.4f} ms "
            f"(sort included), pre-sorted {ms['presorted']:.4f} ms "
            f"(rounds {runs[(name, 'unsorted')]}, unsorted); plain version "
            f"{p_ms:.1f} ms; bound {b_ms:.4f} ms by {by} ({ops / 1e9:.3f} "
            f"G operations, {n_bytes / 1e6:.1f} MB)")
    for name in ("bvh4_closest_hit", "bvh4_any_hit",
                 "bvh4_closest_hit_mp P=2", "bvh4_closest_hit_mp P=4"):
        fn = entries[name][0]
        t = device_ms(lambda: fn(o, d, maxt, False), 20)
        out[name]["device_ms"] = t
        say(f"[time] {name} unsorted, device time alone: {t:.4f} ms a "
            "launch")
    for width in CT.K4_WIDTHS:
        kp, kt = k4[width]["work"]
        say(f"[time] K4 P={width}: its own schedule {kp / n:.2f} pops, "
            f"{kt / n:.2f} tests a ray against K2's {pops / n:.2f} and "
            f"{tests / n:.2f}")
    k2, ref = out["bvh4_closest_hit"], out["bvh4_closest_hit_ref"]
    say(f"[speed] new K2 / reference, unsorted: "
        f"{k2['ms_unsorted'] / ref['ms_unsorted']:.3f} (aim <= 0.8); new K3 "
        f"{out['bvh4_any_hit']['ms_unsorted']:.4f} ms (aim <= 0.46)")
    return out


def time_steps(scene, o, d, maxt):
    """ms a launch of K2 and K3 at each design step
    (``cuda_traverse.STEPS``: warp-wide leaf tests alone, with the 48-byte
    rows, with the shared top on a persistent, refilling grid) on the rays
    unsorted and pre-sorted, in two rounds (the second reversed); each
    step's hits must equal the main path's bit for bit."""
    import torch
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    nodes, tri = scene.bvh_nodes, scene.bvh_tris
    perm = CT._morton_order(nodes, o, d, maxt)
    pre = (o[perm].contiguous(), d[perm].contiguous(),
           maxt[perm].contiguous())
    main = (*CT.launch_closest(nodes, scene.bvh_tris_k, o, d, maxt),
            CT.launch_any(nodes, scene.bvh_tris_k, o, d, maxt))
    vs = {f"step {k}": v for k, v in CT.STEPS.items()}
    layouts = {v.layout: CT.kernel_tris(tri, v.layout) for v in vs.values()}
    for name, v in vs.items():
        tk = layouts[v.layout]
        got = (*CT.launch_closest(nodes, tk, o, d, maxt, v),
               CT.launch_any(nodes, tk, o, d, maxt, v))
        check(all(torch.equal(a, b) for a, b in zip(got, main)),
              f"K2/K3 {name} differs from the main path's launch")
    cases = [(name, k, kind) for name in vs for k in ("K2", "K3")
             for kind in ("unsorted", "presorted")]
    runs = {c: [] for c in cases}
    for seq in (cases, cases[::-1]):
        for name, k, kind in seq:
            v = vs[name]
            fn = CT.launch_closest if k == "K2" else CT.launch_any
            rays = pre if kind == "presorted" else (o, d, maxt)
            runs[(name, k, kind)].append(cuda_ms(
                lambda: fn(nodes, layouts[v.layout], *rays, v), 20))
    out = {}
    for name, v in vs.items():
        ms = {f"{k} {kind}": sum(runs[(name, k, kind)]) / 2
              for k in ("K2", "K3") for kind in ("unsorted", "presorted")}
        out[name] = ms
        grid = "persistent, refilled" if v.persistent else "32 rays a warp"
        say(f"[steps] {name} ({v.layout}, {v.threads} threads, {grid}, "
            f"{'top in shared memory' if v.shared else 'R = 0'}, serial "
            f"{v.serial}/8): "
            + ", ".join(f"{k} {t:.4f} ms" for k, t in ms.items())
            + "; hits equal the main path's")
    return out


def time_k4_steps(scene, o, d, maxt, bound):
    """ms a launch, on the device alone, of every K4 launch of
    ``k4_calls`` at each width (the main path's and each design step),
    with K2 and the reference beside them, in two rounds (the second
    reversed); each set against ``bound``, the least time of K2's
    function on these rays, and the main path's launch against the aim
    of at most 1.25 x K2.  Returns {name: ms}, the K4 launches named
    "P=<width> <launch>"."""
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    nodes, tri, tri_k = scene.bvh_nodes, scene.bvh_tris, scene.bvh_tris_k
    calls = {"K2": lambda o_, d_, m_: CT.launch_closest(nodes, tri_k, o_,
                                                         d_, m_),
             "reference": lambda o_, d_, m_: CT.closest_hit_reference(
                 nodes, tri, o_, d_, m_)}
    for width in CT.K4_WIDTHS:
        for name, fn in k4_calls(scene, width).items():
            calls[f"P={width} {name}"] = fn
    runs = {k: [] for k in calls}
    for seq in (list(calls), list(calls)[::-1]):
        for k in seq:
            runs[k].append(device_ms(lambda: calls[k](o, d, maxt), 20))
    ms = {k: sum(v) / 2 for k, v in runs.items()}
    say(f"[K4 steps] device time alone, {o.shape[0]} rays: K2 "
        f"{ms['K2']:.4f} ms, reference {ms['reference']:.4f} ms; bound "
        f"{bound:.4f} ms")
    for width in CT.K4_WIDTHS:
        say(f"[K4 steps] P={width}: " + "; ".join(
            f"{k.split(' ', 1)[1]} {t:.4f} ms ({t / ms['K2']:.3f} x K2, "
            f"{t / ms['reference']:.3f} x the reference, {bound / t:.1%} "
            "of the bound)" for k, t in ms.items()
            if k.startswith(f"P={width} ")))
        main = ms[f"P={width} main"]
        say(f"[speed] K4 P={width}: {main / ms['K2']:.3f} x K2 (aim <= "
            f"1.25: {'met' if main <= 1.25 * ms['K2'] else 'missed'})")
    return ms


def lane_utilisation(scene, o, d, maxt):
    """Active lane-steps over 32 x warp-steps in the traversal loop and in
    the leaf tests, from the counting builds of the main path's K2 and K4
    at each width and of the reference, whose hits must equal the
    uncounted ones.  K4's traversal step is one batch position visited by
    the warp."""
    import torch
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    nodes, tri, tri_k = scene.bvh_nodes, scene.bvh_tris, scene.bvh_tris_k
    out = {}
    k4 = [(f"K4 P={w}", (lambda w_: lambda c: CT.launch_closest_mp(
        nodes, tri_k, o, d, maxt, w_, counts=c))(w),
           (lambda w_: lambda: CT.launch_closest_mp(
               nodes, tri_k, o, d, maxt, w_))(w)) for w in CT.K4_WIDTHS]
    for name, fn, plain in (
            ("K2", lambda c: CT.launch_closest(nodes, tri_k, o, d,
                                               maxt, counts=c),
             lambda: CT.launch_closest(nodes, tri_k, o, d, maxt)),
            *k4,
            ("reference", lambda c: CT.closest_hit_reference(
                nodes, tri, o, d, maxt, counts=c),
             lambda: CT.closest_hit_reference(nodes, tri, o, d, maxt))):
        counts = torch.zeros(4, dtype=torch.int64, device=o.device)
        got = fn(counts)
        check(all(torch.equal(a, b) for a, b in zip(got, plain())),
              f"the counting {name} differs from the uncounted one")
        steps, active, lsteps, lactive = (int(x) for x in counts.tolist())
        out[name] = dict(traversal=active / (32 * steps),
                         leaf=lactive / (32 * lsteps),
                         traversal_steps=steps, leaf_steps=lsteps)
        say(f"[lanes] {name}: traversal {active / (32 * steps):.3f} of the "
            f"lanes in {steps} warp-steps, leaf tests "
            f"{lactive / (32 * lsteps):.3f} in {lsteps} warp-steps "
            f"({o.shape[0]} rays)")
    return out


def render_rays(scene, spp):
    """Record the rays one ``spp`` pass hands to ``closest_hit`` and
    ``any_hit`` (wrapped here, not in the package); then, on each depth's
    batch, time the main path's K2 against the reference, K3 and K4 at
    each width (two rounds, the second reversed), and check K2 against
    the reference, K3 against the reference's valid, and K4 against its
    plain version, bit for bit, and its t and valid against K2's."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.ops import traverse as TR
    rec = {"closest": [], "any": []}
    orig = CT.closest_hit, CT.any_hit

    def keep(kind, fn):
        def call(nodes, tri, o, d, maxt, **kw):
            rec[kind].append((o.clone(), d.clone(), maxt.clone()))
            return fn(nodes, tri, o, d, maxt, **kw)
        return call

    CT.closest_hit = keep("closest", orig[0])
    CT.any_hit = keep("any", orig[1])
    try:
        mt.render(scene, spp=spp, seed=5)
    finally:
        CT.closest_hit, CT.any_hit = orig
    torch.cuda.synchronize()
    nodes, tri, tri_k = scene.bvh_nodes, scene.bvh_tris, scene.bvh_tris_k
    check(len(rec["closest"]) == DEPTH and len(rec["any"]) == DEPTH,
          f"a pass made {len(rec['closest'])} closest-hit and "
          f"{len(rec['any'])} any-hit calls, expected {DEPTH} each")
    out = []
    for depth, (c, a) in enumerate(zip(rec["closest"], rec["any"])):
        k2 = CT.launch_closest(nodes, tri_k, *c)
        ref = CT.closest_hit_reference(nodes, tri, *c)
        occ = CT.launch_any(nodes, tri_k, *a)
        occ_ref = CT.closest_hit_reference(nodes, tri, *a)[1] >= 0
        check(all(torch.equal(x, y) for x, y in zip(k2, ref))
              and torch.equal(occ, occ_ref),
              f"depth {depth}: K2/K3 differ from the reference")
        calls = {"K2": lambda: CT.launch_closest(nodes, tri_k, *c),
                 "reference": lambda: CT.closest_hit_reference(
                     nodes, tri, *c),
                 "K3": lambda: CT.launch_any(nodes, tri_k, *a)}
        for w in CT.K4_WIDTHS:
            k4 = CT.launch_closest_mp(nodes, tri_k, *c, w)
            plain = TR.bvh_ray_intersect_plain(nodes, tri, *c, multi_pop=w)
            diff = sum(int((x != y).sum()) for x, y in zip(k4, plain))
            check(diff == 0 and torch.equal(k4[0], k2[0])
                  and torch.equal(k4[1] >= 0, k2[1] >= 0),
                  f"depth {depth}: K4 P={w} differs from its plain version "
                  f"on {diff} lanes, or its t / valid from K2's")
            calls[f"K4 P={w}"] = (lambda w_: lambda: CT.launch_closest_mp(
                nodes, tri_k, *c, w_))(w)
        runs = {k: [] for k in calls}
        for seq in (list(calls), list(calls)[::-1]):
            for k in seq:
                runs[k].append(cuda_ms(calls[k], 10))
        ms = {k: sum(v) / 2 for k, v in runs.items()}
        live_c = int((c[2] > 1e-6).sum())
        live_a = int((a[2] > 1e-6).sum())
        row = dict(depth=depth, rays=c[0].shape[0], live_closest=live_c,
                   live_any=live_a, hits=int((k2[1] >= 0).sum()),
                   occluded=int(occ.sum()), **{f"{k}_ms": v
                                               for k, v in ms.items()})
        out.append(row)
        say(f"[render rays] depth {depth}: {c[0].shape[0]} rays ({live_c} "
            f"live, {row['hits']} hits) K2 {ms['K2']:.4f} ms, reference "
            f"{ms['reference']:.4f} ms ({ms['K2'] / ms['reference']:.3f}), "
            + ", ".join(f"K4 P={w} {ms[f'K4 P={w}']:.4f} ms"
                        for w in CT.K4_WIDTHS)
            + f"; {live_a} live shadow rays ({row['occluded']} occluded) K3 "
            f"{ms['K3']:.4f} ms; K2/K3 bit for bit equal to the reference, "
            "K4 to its plain version (t and valid to K2's)")
    slower = [r["depth"] for r in out if r["K2_ms"] > r["reference_ms"]]
    say(f"[speed] render rays: K2 slower than the reference at depths "
        f"{slower or 'none'}")
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


def _device_events(prof):
    """(name, device ms, count) by kernel name, read from the profiler's
    raw events: seconds for ~10^6 launches, where ``key_averages``
    takes minutes."""
    import torch
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return [(k, ms, n) for k, (ms, n) in by_name.items()]


def profile_pass(label, fn, names, cpu=True, table=True):
    """Device time by kernel over one call of ``fn`` (torch.profiler),
    with the share of the kernels whose names contain one of ``names``;
    the full table goes to standard error.  ``cpu=False`` traces the
    device alone: no host operator events, whose collection takes tens
    of seconds on a call of ~10^5 launches.  ``table=False`` sums the
    raw device events instead of ``key_averages`` (the same kernels, no
    table), for a call of ~10^6 launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    if not table:
        kernels = _device_events(prof)
        if not kernels:
            say(f"[profile] {label}: wall {wall:.1f} ms; the profiler saw "
                "no device time (not measured)")
            return None
        busy = sum(ms for _, ms, _ in kernels)
        ours = sum(ms for k, ms, _ in kernels
                   if any(nm in k for nm in names))
        n_launch = sum(n for _, _, n in kernels)
        top = sorted(kernels, key=lambda e: -e[1])[:8]
        say("[profile] %s: wall %.1f ms, device busy %.1f ms (%.1f %%), %s "
            "%.2f ms (%.1f %% of busy), %d kernel launches; top: %s" % (
                label, wall, busy, 100 * busy / wall, "/".join(names), ours,
                100 * ours / busy, n_launch,
                "; ".join(f"{k[:40]} {ms:.2f} ms x{n}" for k, ms, n in top)))
        return dict(wall=wall, busy=busy, launches=n_launch)
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


def k4_calls(scene, width):
    """Every K4 launch ``chip_smoke.py`` holds and times at one width, by
    name: the main path's (``closest_hit``) and each design step of
    ``cuda_traverse.K4_STEPS``; each takes (o, d, maxt)."""
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    nodes, tri, tri_k = scene.bvh_nodes, scene.bvh_tris, scene.bvh_tris_k
    layouts = {"pad": tri_k, "rows": tri}
    calls = {"main": lambda o, d, m: CT.closest_hit(
        nodes, tri, o, d, m, multi_pop=width, tri_k=tri_k)}
    for name, v in CT.K4_STEPS.items():
        calls[f"step {name}"] = (lambda v_: lambda o, d, m: (
            CT.launch_closest_mp(nodes, layouts[v_.layout], o, d, m, width,
                                 v_)))(v)
    return calls


def compare_k4(scene, o, d, maxt, n_brute=65536):
    """K4 at each multi-pop width against its plain version (every output
    equal, for the main path's launch and each design step), against K2
    (t and valid equal; the rays where the two keep different triangles
    at the same t counted) and, on the first ``n_brute`` rays, against
    K1's plain brute force.  Returns per width the errors, the plain
    version's ms and its work counts."""
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
        calls = k4_calls(scene, width)
        runs = {name: fn(o, d, maxt) for name, fn in calls.items()}
        got = runs["main"]
        torch.cuda.synchronize()
        CT.raise_on_overflow(o.device)
        (*plain, pops, tests), plain_ms = timed(
            lambda: TR.bvh_ray_intersect_plain(nodes, tri, o, d, maxt,
                                               counts=True,
                                               multi_pop=width))
        diffs = {name: sum(int((a != b).sum()) for a, b in zip(g, plain))
                 for name, g in runs.items()}
        say(f"[k4] P={width}: lanes differing from the plain version, by "
            "launch: " + ", ".join(f"{k} {v}" for k, v in diffs.items())
            + "  [limit 0 each]")
        check(sum(diffs.values()) == 0,
              f"K4 P={width}: a launch differs from its plain version: "
              f"{diffs}")
        n_diff = diffs["main"]
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
            if _TALLY is not None:
                _TALLY[k] = _TALLY.get(k, 0) + counts[k]
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
    """The port's ``app/optim.run("prb_hybrid", ...)`` at thres 0 (PRB's
    loss from the first iteration) for 3 iterations on
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
               max_depth=DEPTH, match_res=64, output=str, thres=0)
    losses = []
    t0 = time.perf_counter()
    opt, history = optim.run(
        "prb_hybrid", exp, iters=3,
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


class PhaseTimer:
    """CUDA events around named functions of the port, by wrapping the
    module attributes the EPSM backward calls them through (the path run
    is unchanged): ``wrap(module, attr, label)``; ``read()`` waits for
    the device and returns ms by label since the last read."""

    def __init__(self):
        self.pending, self.saved = [], []

    def wrap(self, module, attr, label):
        import torch
        fn = getattr(module, attr)

        def timed_fn(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            self.pending.append((label, start, end))
            return out

        setattr(module, attr, timed_fn)
        self.saved.append((module, attr, fn))

    def wrap_call(self, label, fn):
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        self.pending.append((label, start, end))
        return out

    def read(self):
        import torch
        torch.cuda.synchronize()
        out = {}
        for label, s, e in self.pending:
            out[label] = out.get(label, 0.0) + s.elapsed_time(e)
        self.pending = []
        return out

    def close(self):
        for module, attr, fn in reversed(self.saved):
            setattr(module, attr, fn)
        self.saved = []


def epsm_backward_timer():
    """A PhaseTimer on the stages of the EPSM backward: the logged pass,
    the first-hit derivative, the Jacobians (within calc_grad, whose rest
    is the solves), the injection, and the PRB recording pass and replay."""
    from epsm_mitsuba3_torch.ad import prb
    from epsm_mitsuba3_torch.integrators import epsm as ET
    from epsm_mitsuba3_torch.integrators import path as P
    timer = PhaseTimer()
    timer.wrap(ET, "sample_path_logged", "logged pass")
    timer.wrap(ET, "first_hit_jvp", "first hit")
    timer.wrap(ET, "_row_jacobians_all", "Jacobians")
    timer.wrap(ET, "calc_grad", "calc_grad")
    timer.wrap(ET, "inject_gradients", "injection")
    timer.wrap(P, "sample_primal_recorded", "PRB recording pass")
    timer.wrap(prb, "prb_backward", "PRB replay")
    return timer


def split_phases(ms):
    """The phase split of one EPSM iteration from a PhaseTimer's read."""
    out = dict(ms)
    out["solves"] = out.pop("calc_grad", 0.0) - out.get("Jacobians", 0.0)
    bwd = out.pop("backward", 0.0)
    out["backward, other"] = bwd - sum(
        out.get(k, 0.0) for k in ("logged pass", "first hit", "Jacobians",
                                  "solves", "injection",
                                  "PRB recording pass", "PRB replay"))
    return out


def epsm_mesh_phase():
    """[epsm mesh]: bench.py's ``manifold_iter`` at its own size. theta is
    an x-offset of every vertex (through ``set_vertices``); each iteration
    renders with the ``manifold`` integrator, matches at 128^2 with the
    Sinkhorn matcher against a 8-spp reference (seed 123) and takes the
    gradient of sum(img * g5).  A warm-up and EPSM_ITERS timed
    iterations: ms by phase (CUDA events), K1-K4 launches (exactly 4
    depth + 1 K2 and 3 depth K3 an iteration, K1 and K4 none), the
    gradient finite and non-zero, the overflow flag 0, peak memory; then
    one profiled iteration.  Returns (the timed iterations' phases and
    walls, the last launch counts, the Sinkhorn inputs)."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.ops.sinkhorn import Matcher
    from epsm_mitsuba3_torch.scenes import cornell_box_mesh
    scene = mt.load_dict(cornell_box_mesh(res=EPSM_RES, spp=EPSM_SPP,
                                          max_depth=DEPTH))
    dev = scene.device
    matcher = Matcher(EPSM_RES)
    integ = {"type": "manifold", "max_depth": DEPTH}
    with torch.no_grad():
        img_ref = mt.render(scene, spp=EPSM_SPP, seed=123,
                            integrator={"type": "path", "max_depth": DEPTH})
    gt_low = img_ref[..., :3].reshape(-1, 3)
    v0 = scene.vertices
    ex = torch.tensor([1.0, 0.0, 0.0], device=dev)
    timer = epsm_backward_timer()
    last = {}

    def iteration(seed):
        theta = torch.tensor(0.01, device=dev, requires_grad=True)
        sc = scene.set_vertices(v0 + theta * ex)
        img = timer.wrap_call("forward render", lambda: mt.render(
            sc, spp=EPSM_SPP, seed=seed, integrator=integ))
        with torch.no_grad():
            img_low = img[..., :3].reshape(-1, 3)
            g5 = timer.wrap_call("Sinkhorn match", lambda: (
                matcher.match_Sinkhorn(img_low, gt_low)))
            g5 = g5.reshape(EPSM_RES, EPSM_RES, 5)
        loss = torch.sum(img * g5)
        (g,) = timer.wrap_call("backward", lambda: torch.autograd.grad(
            loss, theta))
        last["img_low"] = img_low
        return g

    phases, walls = [], []
    try:
        torch.cuda.reset_peak_memory_stats()
        for i, run in enumerate(["warm-up"] + [f"timed {k + 1}" for k in
                                               range(EPSM_ITERS)]):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = iteration(i)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            counts = read_counts()
            ms = split_phases(timer.read())
            gval = float(g)
            say(f"[epsm mesh] {run}: {wall:.1f} ms, dL/dtheta {gval:.6g}; "
                + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
                + f" ms; launches {counts}")
            check(math.isfinite(gval) and gval != 0.0,
                  f"epsm mesh: gradient {gval} not finite and non-zero")
            expect = {"bvh4_closest_hit": 4 * DEPTH + 1,
                      "bvh4_any_hit": 3 * DEPTH, "bvh4_closest_hit_mp": 0,
                      "mt_closest_hit": 0, "mt_any_hit": 0}
            for k, n in expect.items():
                check(counts[k] == n, f"epsm mesh: {k} launched "
                      f"{counts[k]} times an iteration, expected {n}")
            CT.raise_on_overflow(dev)
            if i:
                phases.append(ms)
                walls.append(wall)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = profile_pass("epsm mesh, one manifold iteration",
                            lambda: iteration(99),
                            ("bvh4_closest", "bvh4_any"))
        timer.read()
    finally:
        timer.close()
    mean = {k: sum(p[k] for p in phases) / len(phases) for k in phases[0]}
    ws = sorted(walls)
    say(f"[epsm mesh] cornell_box_mesh {EPSM_RES}^2 x {EPSM_SPP} spp, depth "
        f"{DEPTH}, match_res {EPSM_RES}, {len(walls)} timed iterations: "
        f"wall median {ws[len(ws) // 2]:.1f} ms (range {ws[0]:.1f}-"
        f"{ws[-1]:.1f}); mean ms by phase (CUDA events): "
        + ", ".join(f"{k} {v:.1f}" for k, v in mean.items())
        + f"; peak device memory {peak:.2f} GiB; device busy "
        + (f"{prof['busy']:.1f} of {prof['wall']:.1f} ms "
           f"({100 * prof['busy'] / prof['wall']:.1f} %)" if prof
           else "not measured"))
    return dict(phases=mean, walls=walls, peak_gib=peak, profile=prof,
                counts=counts, x=last["img_low"], y=gt_low)


def epsm_cornellbox_phase():
    """[epsm cornellbox]: ``run("manifold_caustic_hybrid", cornellbox.make(
    ...), iters=CB_ITERS)`` at the experiment's published widths, thres
    CB_THRES, so that the switch to PRB's loss and the Adam reset run.
    K1 launches counted an iteration: exactly 25 closest and 18 any hits
    a manifold pass (6 + 6 forward; the logged pass 12 + 6, the first hit
    1, the recording pass 6 + 6), 6 + 6 a PRB pass, and the ground
    truth's 6 + 6 a pass in iteration 0.  Returns the counts of the run."""
    import torch
    from epsm_mitsuba3_torch.app import optim
    from epsm_mitsuba3_torch.app.exp import cornellbox
    exp = cornellbox.make(resolution=CB_RES, spp=CB_SPP, it=CB_ITERS,
                          thres=CB_THRES, max_depth=DEPTH, match_res=128)
    exp["gt_spp"] = CB_GT_SPP
    chunk = max(1, min(CB_SPP, 2_000_000 // (CB_RES * CB_RES)))
    n_pass, n_gt = -(-CB_SPP // chunk), -(-CB_GT_SPP // chunk)
    rows, total = [], {}
    zero_counts()
    torch.cuda.synchronize()
    mark = [time.perf_counter()]

    def log(it, loss, theta):
        torch.cuda.synchronize()
        now = time.perf_counter()
        counts = read_counts()
        zero_counts()
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        rows.append(dict(it=it, ms=(now - mark[0]) * 1e3, loss=loss,
                         theta=[float(theta[f"rot{i}"]) for i in range(6)],
                         counts=counts))
        mark[0] = now

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    optim.run("manifold_caustic_hybrid", exp, iters=CB_ITERS, log=log)
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for r in rows:
        manifold = r["it"] < CB_THRES
        per = (25, 18) if manifold else (DEPTH, DEPTH)
        gt = n_gt * DEPTH if r["it"] == 0 else 0
        expect = {"mt_closest_hit": n_pass * per[0] + gt,
                  "mt_any_hit": n_pass * per[1] + gt,
                  "bvh4_closest_hit": 0, "bvh4_any_hit": 0}
        say(f"[epsm cornellbox] iteration {r['it']} "
            f"({'manifold_caustic' if manifold else 'prb, Adam reset'}"
            f"{', with the ground truth' if r['it'] == 0 else ''}): "
            f"{r['ms']:.1f} ms, loss {r['loss']:.6g}, theta "
            f"{[round(x, 6) for x in r['theta']]}, launches {r['counts']}")
        for k, n in expect.items():
            check(r["counts"][k] == n, f"epsm cornellbox: {k} launched "
                  f"{r['counts'][k]} times in iteration {r['it']}, "
                  f"expected {n}")
        check(math.isfinite(r["loss"]) and all(
            math.isfinite(x) for x in r["theta"]), "epsm cornellbox: "
            "loss or theta not finite")
    check(max(abs(x - math.pi / 3) for x in rows[-1]["theta"]) > 0,
          "epsm cornellbox: theta did not move")
    say(f"[epsm cornellbox] {CB_RES}^2, six lights, depth {DEPTH}, "
        f"match_res 128, spp {CB_SPP} (published 256) in {n_pass} passes "
        f"of {chunk}, ground truth at {CB_GT_SPP} spp (default 512), "
        f"{CB_ITERS} iterations of manifold_caustic_hybrid at thres "
        f"{CB_THRES}: {wall:.1f} ms in all; K1 launches "
        f"{total.get('mt_closest_hit', 0)} closest / "
        f"{total.get('mt_any_hit', 0)} any; peak device memory "
        f"{peak:.2f} GiB")
    exp["gt_spp"] = 1
    prof = profile_pass("epsm cornellbox, one manifold_caustic iteration "
                        "(and a 1-spp ground truth)",
                        lambda: optim.run("manifold_caustic", exp, iters=1),
                        ("mt_closest", "mt_any"))
    return dict(rows=rows, total=total, wall=wall, peak_gib=peak,
                profile=prof)


def epsm_card_vs_cpu(x, y):
    """[epsm card vs cpu]: (i) one manifold_caustic gradient of theta on
    cornellbox at 32^2, spp 4, match_res 32, depth 4, on the card and on
    the CPU (the plain versions), both through one OT gradient (the
    card's matcher on the card's render): relative L2 <= 1e-3, as the
    other gradient checks; (ii) the Sinkhorn matcher at 128^2 on the
    mesh phase's inputs on the card and on the CPU in float32, and on the
    card in float64: at eps = 1e-4 float32 is itself ~1e-3 of the largest
    entry off the exact result, so the check is relative L2 <= 1e-2 and a
    largest difference within twice the larger of the two float32
    results' distances to float64."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.app import optim
    from epsm_mitsuba3_torch.app.exp import cornellbox
    from epsm_mitsuba3_torch.ops.sinkhorn import Matcher
    kw = dict(resolution=32, spp=4, match_res=32, max_depth=4)
    integ = {"type": "manifold_caustic", "max_depth": 4}
    g5 = None
    grads = {}
    for dev in ("cuda", "cpu"):
        exp = cornellbox.make(device=dev, **kw)
        if g5 is None:
            with torch.no_grad():
                gt = mt.render(exp["apply"](exp["scene"],
                                            exp["target_theta"]), spp=16,
                               seed=0, device=dev,
                               integrator={"type": "path", "max_depth": 4})
                img = mt.render(exp["apply"](exp["scene"],
                                             exp["init_theta"]), spp=4,
                                seed=0, sensor=1, device=dev, integrator=integ)
                g5 = Matcher(32).match_Sinkhorn(
                    optim._resize(img[..., :3], 32).reshape(-1, 3),
                    optim._resize(gt[..., :3], 32).reshape(-1, 3)).reshape(
                        32, 32, 5)
        theta = {k: v.clone().requires_grad_(True)
                 for k, v in exp["init_theta"].items()}
        img = mt.render(exp["apply"](exp["scene"], theta), spp=4, seed=0,
                        sensor=1, integrator=integ, device=dev)
        loss = torch.sum(img * g5.to(dev))
        gs = torch.autograd.grad(loss, list(theta.values()))
        grads[dev] = torch.stack([g.detach().cpu() for g in gs])
    err = rel_l2(grads["cuda"], grads["cpu"])
    say(f"[epsm card vs cpu] manifold_caustic dL/dtheta on cornellbox 32^2 "
        f"x 4 spp, depth 4: card {[round(float(v), 7) for v in grads['cuda']]}"
        f", cpu {[round(float(v), 7) for v in grads['cpu']]}; |g_gpu - "
        f"g_cpu| / |g_cpu| {err:.3g}  [limit 1e-3]")
    check(err <= 1e-3, f"epsm: card and CPU theta gradients differ by {err}")
    check(float(grads["cpu"].abs().max()) > 0, "epsm: zero theta gradient")

    t0 = time.perf_counter()
    g_card = Matcher(EPSM_RES).match_Sinkhorn(x, y)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    g64 = Matcher(EPSM_RES).match_Sinkhorn(x.double(), y.double())
    t0 = time.perf_counter()
    g_cpu = Matcher(EPSM_RES, device="cpu").match_Sinkhorn(x.cpu(), y.cpu())
    cpu_s = time.perf_counter() - t0
    g_card, g64 = g_card.cpu(), g64.cpu()
    top = float(g64.abs().max())

    def far(a, b):
        return float((a.double() - b.double()).abs().max()) / top

    e_cc, e_card, e_cpu = far(g_card, g_cpu), far(g_card, g64), far(g_cpu,
                                                                     g64)
    l2 = rel_l2(g_card.double(), g_cpu.double())
    say(f"[epsm card vs cpu] match_Sinkhorn at {EPSM_RES}^2 ({x.shape[0]} "
        f"points, the mesh phase's inputs): card {card_s:.2f} s, cpu "
        f"{cpu_s:.2f} s; largest |difference| / largest |g64|: card-cpu "
        f"{e_cc:.3g}, card-f64 {e_card:.3g}, cpu-f64 {e_cpu:.3g}; relative "
        f"L2 card-cpu {l2:.3g}  [limits: L2 1e-2, card-cpu <= 2 x "
        f"max(card-f64, cpu-f64)]")
    check(l2 <= 1e-2 and e_cc <= 2.0 * max(e_card, e_cpu),
          "epsm: card and CPU matchers disagree")
    return dict(theta_grad_rel_l2=err, match_rel_l2=l2, match_far=e_cc,
                card_f64=e_card, cpu_f64=e_cpu)


# ---------------------------------------------------------------------------
# [epsm experiments]: the paper's glass, rough-metal and many-object
# experiments through run(...), and K1-K3 on their own rays
# ---------------------------------------------------------------------------

def _pass_count(spp, res):
    """The passes ``run`` renders ``spp`` in at ``res``^2 (its
    ``spp_chunk``: at most 2,000,000 lanes a pass) and the chunk."""
    chunk = max(1, min(spp, 2_000_000 // (res * res)))
    return -(-spp // chunk), chunk


def _labelled_render(timer, render):
    """``app/optim.py``'s ``render`` timed by CUDA events: the ground
    truth (the ``path`` integrator) apart from the method's forward."""
    def call(*a, **kw):
        kind = (kw.get("integrator") or {}).get("type")
        label = "ground truth" if kind == "path" else "forward render"
        return timer.wrap_call(label, lambda: render(*a, **kw))
    return call


def experiment_run(name, spp, gt_spp, iters, do_profile=True,
                   each_leaf=True, match_res=EXP_MATCH, profile_table=True):
    """``run(method, <name>.make(...))`` at EXP_RES^2 and ``match_res``
    (EXP_MATCH unless given), each config's own depth and method (its scene's
    integrator), ``iters`` iterations.  ms an iteration (the ground truth
    apart), ms by phase (CUDA events), launches an iteration (each count
    exact: a manifold pass launches 4 D + 1 closest and 3 D any hits, a
    ground-truth pass D and D), the loss, theta and every theta gradient
    finite and non-zero (each leaf's, with ``each_leaf``), theta moved,
    peak device
    memory, the BVH build's seconds and set_vertices' ms; then one
    profiled iteration (with a 1-spp ground truth).  Returns the rows,
    the launch totals and the summary."""
    import importlib
    import torch
    from epsm_mitsuba3_torch.app import optim
    from epsm_mitsuba3_torch.models import scene as scene_mod
    from epsm_mitsuba3_torch.ops import bvh as bvh_mod
    mod = importlib.import_module(f"epsm_mitsuba3_torch.app.exp.{name}")
    build_s = []
    orig_build = bvh_mod.build

    def timed_build(*a, **kw):
        t0 = time.perf_counter()
        out = orig_build(*a, **kw)
        build_s.append(time.perf_counter() - t0)
        return out

    bvh_mod.build = timed_build
    try:
        t0 = time.perf_counter()
        exp = mod.make(resolution=EXP_RES, spp=spp, it=iters,
                       match_res=match_res)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        bvh_mod.build = orig_build
    exp["gt_spp"] = gt_spp
    scene = exp["scene"]
    method = dict(scene.static.integrator)["type"]
    depth = exp["max_depth"]
    n_tris = scene.faces.shape[0]
    bvh = scene.bvh is not None
    say(f"[epsm experiments] {name}: {n_tris} triangles ("
        + (f"BVH of {scene.bvh_nodes.shape[0]} BVH4 records, built in "
           f"{sum(build_s):.2f} s" if bvh else "brute force, K1")
        + f"), loaded in {load_s:.2f} s; {method}, depth {depth}, "
        f"{EXP_RES}^2 x {spp} spp, ground truth {gt_spp} spp, match_res "
        f"{match_res}, {iters} iterations")

    timer = epsm_backward_timer()
    timer.wrap(optim.Matcher, "match_Sinkhorn", "Sinkhorn match")
    timer.wrap(scene_mod.Scene, "set_vertices", "set_vertices")
    orig_render, orig_step = optim.render, optim.Adam.step
    optim.render = _labelled_render(timer, orig_render)
    grads = []

    def step(self, g):
        grads.append({k: v.detach().clone() for k, v in g.items()})
        return orig_step(self, g)

    optim.Adam.step = step
    rows, total = [], {}
    zero_counts()
    torch.cuda.synchronize()
    mark = [time.perf_counter()]

    def log(it, loss, theta):
        torch.cuda.synchronize()
        now = time.perf_counter()
        counts = read_counts()
        zero_counts()
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        ms = split_phases(timer.read())
        ms["backward, other"] = None   # run() calls autograd itself
        rows.append(dict(it=it, wall=(now - mark[0]) * 1e3, loss=loss,
                         theta={k: v.copy() for k, v in theta.items()},
                         counts=counts, phases=ms))
        mark[0] = now

    try:
        torch.cuda.reset_peak_memory_stats()
        optim.run(method, exp, iters=iters, log=log)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = None
        if do_profile:
            exp["gt_spp"] = 1
            prof = profile_pass(
                f"epsm {name}, one {method} iteration (and a 1-spp ground "
                "truth)", lambda: optim.run(method, exp, iters=1),
                ("bvh4_closest", "bvh4_any") if bvh
                else ("mt_closest", "mt_any"), cpu=False,
                table=profile_table)
            timer.read()
    finally:
        optim.render, optim.Adam.step = orig_render, orig_step
        timer.close()

    n_pass, _ = _pass_count(spp, EXP_RES)
    n_gt, _ = _pass_count(gt_spp, EXP_RES)
    closest, anyhit = (("bvh4_closest_hit", "bvh4_any_hit") if bvh
                       else ("mt_closest_hit", "mt_any_hit"))
    walls = []
    for r, g in zip(rows, grads):
        gt = n_gt * depth if r["it"] == 0 else 0
        expect = {closest: n_pass * (4 * depth + 1) + gt,
                  anyhit: n_pass * 3 * depth + gt}
        for k in ("mt_closest_hit", "mt_any_hit", "bvh4_closest_hit",
                  "bvh4_any_hit", "bvh4_closest_hit_mp"):
            expect.setdefault(k, 0)
        ph = r["phases"]
        wall = r["wall"] - ph.get("ground truth", 0.0)
        walls.append(wall)
        gsum = {k: (float(v.abs().max()), bool(torch.isfinite(v).all()
                                               and v.abs().max() < 1e30))
                for k, v in g.items()}
        say(f"[epsm experiments] {name} iteration {r['it']}"
            + (" (with the ground truth)" if r["it"] == 0 else "")
            + f": {r['wall']:.1f} ms, {wall:.1f} without the ground truth; "
            f"loss {r['loss']:.6g}; theta "
            + "; ".join(f"{k} {[round(float(x), 6) for x in v.ravel()[:6]]}"
                        for k, v in r["theta"].items())
            + "; max |dL/dtheta| "
            + ", ".join(f"{k} {m:.4g}" for k, (m, _) in gsum.items())
            + "; ms by phase "
            + ", ".join(f"{k} {v:.1f}" for k, v in ph.items()
                        if v is not None)
            + f"; launches {r['counts']}")
        for k, n in expect.items():
            check(r["counts"][k] == n, f"{name}: {k} launched "
                  f"{r['counts'][k]} times in iteration {r['it']}, "
                  f"expected {n}")
        check(math.isfinite(r["loss"]), f"{name}: loss not finite")
        for k, (m, finite) in gsum.items():
            check(finite and (m > 0 or not each_leaf), f"{name}: dL/d{k} "
                  f"not finite and non-zero ({m})")
        check(max(m for m, _ in gsum.values()) > 0, f"{name}: zero "
              "gradient")
        for k, v in r["theta"].items():
            check(bool((abs(v) < 1e30).all()), f"{name}: theta {k} not "
                  "finite")
    init = exp["init_theta"]
    moved = max(float((torch.as_tensor(rows[-1]["theta"][k])
                       - init[k].cpu()).abs().max()) for k in init)
    check(moved > 0, f"{name}: theta did not move")
    mean = {k: sum(r["phases"].get(k) or 0.0 for r in rows) / len(rows)
            for k in rows[0]["phases"] if k != "backward, other"}
    ws = sorted(walls)
    say(f"[epsm experiments] {name} summary: ms an iteration without the "
        f"ground truth median {ws[len(ws) // 2]:.1f} (range {ws[0]:.1f}-"
        f"{ws[-1]:.1f}); {n_pass} passes of a manifold backward each; mean "
        "ms by phase (CUDA events) "
        + ", ".join(f"{k} {v:.1f}" for k, v in mean.items())
        + f"; peak device memory {peak:.2f} GiB; device busy "
        + (f"{prof['busy']:.1f} of {prof['wall']:.1f} ms "
           f"({100 * prof['busy'] / prof['wall']:.1f} %)" if prof
           else "not measured")
        + f"; launches in all {total}"
        + (f"; BVH build {sum(build_s):.2f} s, set_vertices (refit + "
           f"pack_bvh4) {mean.get('set_vertices', 0.0):.1f} ms an "
           "iteration" if bvh else ""))
    return dict(rows=rows, grads=grads[:len(rows)], total=total,
                walls=walls,
                phases=mean, peak_gib=peak, profile=prof, exp=exp,
                build_s=sum(build_s), load_s=load_s, method=method)


def _record_rays(module, names, fn):
    """Run ``fn`` with ``module``'s functions ``names`` wrapped to keep
    copies of their arguments; returns {name: [args, ...]}."""
    rec = {nm: [] for nm in names}
    orig = {nm: getattr(module, nm) for nm in names}

    def keep(nm):
        def call(*a, **kw):
            rec[nm].append(([x.clone() if hasattr(x, "clone") else x
                             for x in a], dict(kw)))
            return orig[nm](*a, **kw)
        return call

    for nm in names:
        setattr(module, nm, keep(nm))
    try:
        fn()
    finally:
        for nm in names:
            setattr(module, nm, orig[nm])
    return rec


def exp_rays_k1(exp, subset=2 ** 18):
    """K1 at egg's 3,972 triangles on the rays one EXP_RES^2 forward pass
    of its manifold render hands to ``closest_hit`` / ``any_hit``: each
    depth's launches held bit for bit against the plain versions on the
    first ``subset`` rays, timed on the device alone beside the bound
    (closest hit: every live ray tests every triangle; any hit: each live
    ray's tests up to its first hit) and the plain versions on the
    subset."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    from epsm_mitsuba3_torch.ops import intersect as I
    scene = exp["apply"](exp["scene"], exp["init_theta"])
    _, chunk = _pass_count(exp["spp"], EXP_RES)
    with torch.no_grad():
        rec = _record_rays(CI, ("closest_hit", "any_hit"), lambda: mt.render(
            scene, spp=chunk, seed=5, sensor=1))
    torch.cuda.synchronize()
    depth = exp["max_depth"]
    check(len(rec["closest_hit"]) == depth and len(rec["any_hit"]) == depth,
          f"an egg pass made {len(rec['closest_hit'])} closest-hit and "
          f"{len(rec['any_hit'])} any-hit calls, expected {depth} each")
    out = []
    for d, (c, a) in enumerate(zip(rec["closest_hit"], rec["any_hit"])):
        (tri, o, dd, maxt), (tri_a, oa, da, ma) = c[0], a[0]
        f, n = tri.shape[0], o.shape[0]
        got = (*CI.closest_hit(tri, o, dd, maxt),
               CI.any_hit(tri_a, oa, da, ma))
        k = slice(0, subset)
        ref_c, plain_c_ms = timed(lambda: I.ray_intersect_brute(
            tri, o[k], dd[k], maxt[k]))
        ref_a, plain_a_ms = timed(lambda: I.ray_test_brute(
            tri_a, oa[k], da[k], ma[k]))
        ref = (*ref_c, ref_a)
        diff = {nm: int((x[k] != y).sum()) for nm, x, y in
                zip(K1_FIELDS, got, ref)}
        check(sum(diff.values()) == 0, f"egg depth {d}: K1 differs from "
              f"the plain versions on {diff}")
        ms_c = device_ms(lambda: CI.closest_hit(tri, o, dd, maxt), 10)
        ms_a = device_ms(lambda: CI.any_hit(tri_a, oa, da, ma), 10)
        live_c = int((maxt > 1e-6).sum())
        live_a = int((ma > 1e-6).sum())
        b_c, by_c = k1_bound(tri, o, dd, maxt, False)
        b_a, by_a = k1_bound(tri_a, oa, da, ma, True)
        row = dict(depth=d, rays=n, live_closest=live_c, live_any=live_a,
                   closest_ms=ms_c, any_ms=ms_a, closest_bound_ms=b_c,
                   closest_bound_by=by_c, any_bound_ms=b_a,
                   any_bound_by=by_a, plain_rays=min(n, subset),
                   closest_plain_ms=plain_c_ms, any_plain_ms=plain_a_ms)
        out.append(row)
        say(f"[egg rays K1] depth {d}: {f} tris x {n} rays ({live_c} live; "
            f"{int((got[1] >= 0).sum())} hits): closest {ms_c:.4f} ms "
            f"(bound {b_c:.4f} by {by_c}, {b_c / ms_c:.1%}); {live_a} live "
            f"shadow rays ({int(got[4].sum())} occluded): any {ms_a:.4f} ms "
            f"(bound {b_a:.4f} by {by_a}, {b_a / ms_a:.1%}); plain versions "
            f"on {min(n, subset)} of them {plain_c_ms:.1f} / "
            f"{plain_a_ms:.1f} ms; bit for bit equal there (0 lanes differ "
            f"in {', '.join(K1_FIELDS)})")
    return out


def exp_rays_k23(exp, subset=2 ** 18):
    """K2/K3 on shadow's tree (1,587,204 triangles at 400 spheres) on the
    rays one EXP_RES^2 forward pass hands to ``closest_hit`` /
    ``any_hit``: each depth's launches held bit for bit against the plain
    versions on the first ``subset`` rays, timed on the device alone
    beside the bound from the plain versions' work on all of the rays
    (their pops and triangle tests, and the records and rows read)."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.ops import traverse as TR
    scene = exp["apply"](exp["scene"], exp["init_theta"])
    _, chunk = _pass_count(exp["spp"], EXP_RES)
    with torch.no_grad():
        rec = _record_rays(CT, ("closest_hit", "any_hit"), lambda: mt.render(
            scene, spp=chunk, seed=5, sensor=1))
    torch.cuda.synchronize()
    CT.raise_on_overflow(scene.device)
    depth = exp["max_depth"]
    check(len(rec["closest_hit"]) == depth and len(rec["any_hit"]) == depth,
          f"a shadow pass made {len(rec['closest_hit'])} closest-hit and "
          f"{len(rec['any_hit'])} any-hit calls, expected {depth} each")
    nodes, tri, tri_k = scene.bvh_nodes, scene.bvh_tris, scene.bvh_tris_k
    out = []
    for d, (c, a) in enumerate(zip(rec["closest_hit"], rec["any_hit"])):
        (o, dd, maxt), kw_c = c[0][2:5], c[1]
        (oa, da, ma), kw_a = a[0][2:5], a[1]
        n = o.shape[0]
        got = (*CT.closest_hit(nodes, tri, o, dd, maxt, **kw_c),
               CT.any_hit(nodes, tri, oa, da, ma, **kw_a))
        CT.raise_on_overflow(scene.device)
        k = slice(0, subset)
        (t_p, s_p, u_p, v_p), plain_c_ms = timed(
            lambda: TR.bvh_ray_intersect_plain(nodes, tri, o[k], dd[k],
                                               maxt[k]))
        occ_p, plain_a_ms = timed(lambda: TR.bvh_ray_test_plain(
            nodes, tri, oa[k], da[k], ma[k]))
        diff = {nm: int((x[k] != y).sum()) for nm, x, y in zip(
            ("t", "slot", "u", "v", "occ"), got, (t_p, s_p, u_p, v_p,
                                                  occ_p))}
        check(sum(diff.values()) == 0, f"shadow depth {d}: K2/K3 differ "
              f"from the plain versions on {diff}")
        work_c = bvh_plain_work(nodes, tri, o, dd, maxt, False)
        work_a = bvh_plain_work(nodes, tri, oa, da, ma, True)
        pops, tests, _, rows_c = work_c
        pops_a, tests_a, _, rows_a = work_a
        ms_c = device_ms(lambda: CT.closest_hit(nodes, tri, o, dd, maxt,
                                                **kw_c), 10)
        ms_a = device_ms(lambda: CT.any_hit(nodes, tri, oa, da, ma, **kw_a),
                         10)
        bytes_c, ops_c = bvh_work(maxt, work_c, False)
        bytes_a, ops_a = bvh_work(ma, work_a, True)
        b_c, by_c = bound_ms(bytes_c, ops_c)
        b_a, by_a = bound_ms(bytes_a, ops_a)
        live_c = int((maxt > 1e-6).sum())
        live_a = int((ma > 1e-6).sum())
        row = dict(depth=d, rays=n, live_closest=live_c, live_any=live_a,
                   closest_ms=ms_c, any_ms=ms_a, closest_bound_ms=b_c,
                   closest_bound_by=by_c, any_bound_ms=b_a,
                   any_bound_by=by_a, pops=pops, tests=tests,
                   pops_any=pops_a, tests_any=tests_a, rows_read=rows_c,
                   rows_read_any=rows_a,
                   plain_rays=min(n, subset), closest_plain_ms=plain_c_ms,
                   any_plain_ms=plain_a_ms, closest_mb=bytes_c / 1e6,
                   any_mb=bytes_a / 1e6, rows_mb=tri_k.numel() * 4 / 1e6)
        out.append(row)
        say(f"[shadow rays K2/K3] depth {d}: {tri.shape[0]} tris "
            f"({row['rows_mb']:.1f} MB of 48-byte rows), {n} rays ({live_c} "
            f"live, {int((got[1] >= 0).sum())} hits; "
            f"{pops / max(live_c, 1):.2f} pops, "
            f"{tests / max(live_c, 1):.2f} tests a live ray, {rows_c} "
            f"distinct rows): K2 "
            f"{ms_c:.4f} ms (bound {b_c:.4f} by {by_c}: {ops_c / 1e6:.1f} M "
            f"operations, {bytes_c / 1e6:.1f} MB; {b_c / ms_c:.1%}); "
            f"{live_a} live shadow rays ({int(got[4].sum())} occluded; "
            f"{pops_a} pops, {tests_a} tests, {rows_a} distinct rows): K3 "
            f"{ms_a:.4f} ms (bound "
            f"{b_a:.4f} by {by_a}: {ops_a / 1e6:.1f} M operations, "
            f"{bytes_a / 1e6:.1f} MB; {b_a / ms_a:.1%}); "
            f"plain versions on {min(n, subset)} of them {plain_c_ms:.1f} / "
            f"{plain_a_ms:.1f} ms; bit for bit equal there (0 lanes differ "
            "in t, slot, u, v, occ)")
    return out


def exp_card_vs_cpu(cases=(("glossyball", 2), ("egg", 4)),
                    label="epsm experiments, card vs cpu"):
    """[epsm experiments, card vs cpu]: at 64^2 x 4 spp, match_res 32,
    each gradient of sum(img * g5) for one fixed OT gradient g5 (seeded),
    on the card and on the CPU, for ``cases`` (config, depth): by default
    glossyball's translation and roughness (manifold_caustic, depth 2)
    and egg's glass-vertex gradients (manifold_caustic, depth 4 of the
    published 6, for the CPU's time); a config's theta otherwise:
    relative L2 <= 1e-3 each."""
    import importlib
    import torch
    import epsm_mitsuba3_torch as mt
    g5 = (torch.randn((64, 64, 5), generator=torch.Generator().manual_seed(
        13)) * 0.05)
    out = {}
    for name, depth in cases:
        mod = importlib.import_module(f"epsm_mitsuba3_torch.app.exp.{name}")
        grads, secs = {}, {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            exp = mod.make(resolution=64, spp=4, match_res=32,
                           max_depth=depth, device=dev)
            integ = {"type": "manifold_caustic", "max_depth": depth}
            theta = {k: v.clone().requires_grad_(True)
                     for k, v in exp["init_theta"].items()}
            sc = exp["apply"](exp["scene"], theta)
            if name == "egg":
                v = sc.vertices.detach().clone().requires_grad_(True)
                sc = sc.with_leaves({"vertices": v})
                leaves = {"glass vertices": v}
            else:
                leaves = theta
            img = mt.render(sc, spp=4, seed=0, sensor=1, integrator=integ,
                            device=dev)
            gs = torch.autograd.grad(torch.sum(img * g5.to(dev)),
                                     list(leaves.values()))
            if name == "egg":
                s, c = exp["scene"].static.vertex_ranges[
                    list(exp["scene"].static.shape_names).index("egg")]
                gs = (gs[0][s:s + c],)
            grads[dev] = {k: g.detach().cpu() for k, g in zip(leaves, gs)}
            if dev == "cuda":
                torch.cuda.synchronize()
            secs[dev] = time.perf_counter() - t0
        for k in grads["cpu"]:
            a, b = grads["cuda"][k], grads["cpu"][k]
            err = rel_l2(a, b)
            out[f"{name} {k}"] = err
            say(f"[{label}] {name} dL/d{k} at 64^2 x "
                f"4 spp, depth {depth}: |g| {float(b.norm()):.6g}, first "
                f"entries card {[round(float(x), 7) for x in a.ravel()[:3]]}"
                f" cpu {[round(float(x), 7) for x in b.ravel()[:3]]}; |g_gpu"
                f" - g_cpu| / |g_cpu| {err:.3g}  [limit 1e-3]; card "
                f"{secs['cuda']:.1f} s, cpu {secs['cpu']:.1f} s")
            check(float(b.abs().max()) > 0, f"{name}: zero dL/d{k}")
            check(err <= 1e-3, f"{name}: card and CPU dL/d{k} differ by "
                  f"{err}")
    return out


def epsm_experiments_phase():
    """[epsm experiments]: egg, glossyball, highlight and shadow through
    ``run`` at EXP_RES^2 (EXP_CELLS: spp and ground truth cut), EXP_ITERS
    iterations each; bunny, bathroom and bedroom one iteration each at
    EXP_ONE_SPP; K1 at egg's 3,972 triangles and K2/K3 on shadow's tree on
    their own rays; the card against the CPU.  Returns the runs, the
    kernel rows and the launch totals."""
    runs, total, secs = {}, {}, {}
    k1_rows = k23_rows = None

    def clock(label, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[label] = time.perf_counter() - t0
        return out

    for name, spp, gt_spp in EXP_CELLS:
        runs[name] = clock(name, lambda: experiment_run(name, spp, gt_spp,
                                                        EXP_ITERS))
        if name == "egg":
            k1_rows = clock("K1 on egg's rays",
                            lambda: exp_rays_k1(runs[name]["exp"]))
        if name == "shadow":
            k23_rows = clock("K2/K3 on shadow's rays",
                             lambda: exp_rays_k23(runs[name]["exp"]))
        runs[name].pop("exp")
    for name in EXP_ONE:
        runs[name] = clock(name, lambda: experiment_run(
            name, EXP_ONE_SPP, EXP_ONE_SPP, 1, do_profile=False,
            each_leaf=False))
        runs[name].pop("exp")
    for r in runs.values():
        for k, n in r["total"].items():
            total[k] = total.get(k, 0) + n
    g = runs["glossyball"]["grads"]
    say("[epsm experiments] glossyball dL/dalpha an iteration: "
        + ", ".join(f"{float(x['alpha']):.6g}" for x in g)
        + "; dL/dtrans " + "; ".join(
            str([round(float(v), 6) for v in x["trans"]]) for x in g))
    cpu = clock("card vs cpu", exp_card_vs_cpu)
    say("[epsm experiments] seconds by step: "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
        + f"; {sum(secs.values()):.1f} s in all")
    return dict(runs=runs, total=total, k1=k1_rows, k23=k23_rows, cpu=cpu,
                secs=secs)


# ---------------------------------------------------------------------------
# [scene files]: the box with the mesh written to files, loaded with
# load_file, against load_dict of the same meshes; the CLI; traverse
# ---------------------------------------------------------------------------

def _write_rectangle_obj(path):
    """``shapes.rectangle()`` as an OBJ with its normals and texture
    coordinates (v written flipped: the loader flips it back)."""
    from epsm_mitsuba3_torch.models import shapes
    r = shapes.rectangle()
    with open(path, "w") as f:
        f.writelines(f"v {x} {y} {z}\n" for x, y, z in r["vertices"])
        f.writelines(f"vt {u} {1 - v}\n" for u, v in r["uvs"])
        f.writelines(f"vn {x} {y} {z}\n" for x, y, z in r["normals"])
        f.writelines(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}\n"
                     for a, b, c in r["faces"] + 1)


def _write_rectangle_serialized(path):
    """``shapes.rectangle()`` in Mitsuba's serialized format (version 4,
    float32 positions, normals and texture coordinates)."""
    import struct
    import zlib
    from epsm_mitsuba3_torch.models import shapes
    r = shapes.rectangle()
    body = (struct.pack("<I", 0x0001 | 0x0002) + b"back\x00"
            + struct.pack("<QQ", len(r["vertices"]), len(r["faces"]))
            + r["vertices"].astype("<f4").tobytes()
            + r["normals"].astype("<f4").tobytes()
            + r["uvs"].astype("<f4").tobytes()
            + r["faces"].astype("<u4").tobytes())
    with open(path, "wb") as f:
        f.write(struct.pack("<HH", 0x041C, 4) + zlib.compress(body)
                + struct.pack("<Q", 0) + struct.pack("<I", 1))


def _write_ply(path, V, F, N):
    """A binary little-endian PLY of float32 positions and normals and
    int triangles."""
    import numpy as np
    head = ["ply", "format binary_little_endian 1.0",
            f"element vertex {len(V)}"]
    head += [f"property float {c}" for c in ("x", "y", "z", "nx", "ny",
                                              "nz")]
    head += [f"element face {len(F)}",
             "property list uchar int vertex_indices", "end_header"]
    tris = np.zeros(len(F), np.dtype([("n", "u1"), ("i", "<i4", (3,))]))
    tris["n"], tris["i"] = 3, F
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        f.write(np.concatenate([V, N], -1).astype("<f4").tobytes())
        f.write(tris.tobytes())


def write_scene_files(ref, tmp):
    """The scene dict ``ref`` (cornell_box_mesh with sphere normals) as
    files in ``tmp``: the sphere a PLY, the floor an OBJ, the back wall a
    .serialized file, every shape under its key as its id, and the XML,
    its sample count the parameter ``$spp``.  Returns the XML's path."""
    import os
    from epsm_mitsuba3_torch.utils.xmlwrite import dict_to_xml
    blob = ref["blob"]
    _write_ply(os.path.join(tmp, "blob.ply"), blob["vertices"],
               blob["faces"], blob["normals"])
    _write_rectangle_obj(os.path.join(tmp, "floor.obj"))
    _write_rectangle_serialized(os.path.join(tmp, "back.serialized"))
    files = {"blob": {"type": "ply", "filename": "blob.ply"},
             "floor": {"type": "obj", "filename": "floor.obj"},
             "back": {"type": "serialized", "filename": "back.serialized"}}
    d = {}
    for key, val in ref.items():
        if isinstance(val, dict) and key not in ("sensor", "integrator"):
            val = {**val, "id": key}
            if key in files:
                val = {**files[key], **{k: v for k, v in val.items()
                                        if k not in ("type", "vertices",
                                                     "faces", "normals")}}
        d[key] = val
    text = dict_to_xml(d)
    spp = ref["sensor"]["sampler"]["sample_count"]
    text = text.replace(
        f'<integer name="sample_count" value="{spp}"/>',
        '<integer name="sample_count" value="$spp"/>').replace(
        '<scene version="3.0.0">',
        f'<scene version="3.0.0">\n    <default name="spp" value="{spp}"/>')
    path = os.path.join(tmp, "scene.xml")
    with open(path, "w") as f:
        f.write(text)
    return path


def _timed_calls(module, attr, secs):
    """Wrap ``module.attr`` to add each call's seconds to ``secs``;
    returns the restore function."""
    fn = getattr(module, attr)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        secs.append(time.perf_counter() - t0)
        return out

    setattr(module, attr, timed)
    return lambda: setattr(module, attr, fn)


def _assert_scenes_equal(label, a, b):
    """Every array of two scenes, their BVHs and K2/K3 records, equal."""
    import torch
    from epsm_mitsuba3_torch.models.scene import GEOMETRY_FIELDS
    from epsm_mitsuba3_torch.ops.bvh import ARRAY_FIELDS
    pairs = [(k, getattr(a, k), getattr(b, k))
             for k in GEOMETRY_FIELDS + ("vertex_colors", "bvh_nodes",
                                         "bvh_tris", "bvh_tris_k")]
    pairs += [(f"bsdfs.{k}", v, b.bsdfs[k]) for k, v in a.bsdfs.items()]
    pairs += [(f"emitters.{k}", v, b.emitters[k])
              for k, v in a.emitters.items()]
    pairs += [(f"bvh.{k}", getattr(a.bvh, k), getattr(b.bvh, k))
              for k in ARRAY_FIELDS]
    pairs += [(f"sensors.{i}.to_world", x.to_world, y.to_world)
              for i, (x, y) in enumerate(zip(a.sensors, b.sensors))]
    differ = [k for k, x, y in pairs if not torch.equal(x, y)]
    same_static = (a.static == b.static and a.bvh.n_levels == b.bvh.n_levels
                   and set(a.bsdfs) == set(b.bsdfs)
                   and len(a.sensors) == len(b.sensors))
    say(f"[scene files] {label}: {len(pairs)} arrays (geometry, tables, "
        f"sensors, BVH, K2/K3 records) compared, {len(differ)} differ"
        f"{': ' + ', '.join(differ) if differ else ''}; static fields "
        f"equal: {same_static}")
    check(not differ and same_static, f"{label}: the scenes differ")


def scene_files_phase(gen):
    """[scene files]: ``cornell_box_mesh(512, 16, 6)`` with its sphere's
    vertex normals (``mesh_io.compute_vertex_normals``) written to a
    temporary directory (``write_scene_files``) and loaded on the card
    with ``load_file``: its arrays, BVH and K2/K3 records equal
    ``load_dict``'s of the same meshes; both rendered at 512^2 x 16 spp
    in passes of 8 (the same seed): the images equal, K2/K3 launched 12
    times each and K1 never; the parse, mesh-load, BVH-build and render
    times; ``cli.main`` writes an EXR equal to ``render``'s image; and
    ``traverse``: the sphere moved through ``update()`` renders as the
    ``set_vertices`` path does (the sphere's smooth normals refreshed
    there by ``refresh_smooth_normals``, as ``update()`` does), and K2 on
    the re-packed tree equals K1's brute force over the moved vertices.
    Returns the times and the launch totals."""
    import os
    import tempfile
    import numpy as np
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch import cli
    from epsm_mitsuba3_torch.core import xmlparse
    from epsm_mitsuba3_torch.models import mesh_io
    from epsm_mitsuba3_torch.ops import bvh as bvh_mod
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.ops import intersect as I
    from epsm_mitsuba3_torch.ops import normals as NT
    from epsm_mitsuba3_torch.scenes import cornell_box_mesh
    ref = cornell_box_mesh(res=RES, spp=SF_SPP, max_depth=DEPTH)
    blob = ref["blob"]
    blob["normals"] = mesh_io.compute_vertex_normals(blob["vertices"],
                                                     blob["faces"])
    n_pass = SF_SPP // SF_CHUNK
    expect = {"mt_closest_hit": 0, "mt_any_hit": 0,
              "bvh4_closest_hit": DEPTH * n_pass,
              "bvh4_any_hit": DEPTH * n_pass, "bvh4_closest_hit_mp": 0}
    out = {"total": {}}

    def count(label, counts, want):
        for k, n in counts.items():
            out["total"][k] = out["total"].get(k, 0) + n
        for k, n in want.items():
            check(counts[k] == n, f"{label}: {k} launched {counts[k]} "
                  f"times, expected {n}")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = write_scene_files(ref, tmp)
        write_s = time.perf_counter() - t0
        sizes = {f: os.path.getsize(os.path.join(tmp, f))
                 for f in sorted(os.listdir(tmp))}
        t0 = time.perf_counter()
        xmlparse.parse_string(open(path).read(), base_dir=tmp)
        parse_s = time.perf_counter() - t0
        mesh_s, bvh_s = [], []
        restore = [_timed_calls(mesh_io, "load_mesh_file", mesh_s),
                   _timed_calls(bvh_mod, "build", bvh_s)]
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sc_file = mt.load_file(path)
            torch.cuda.synchronize()
            file_s = time.perf_counter() - t0
            n_bvh = len(bvh_s)
            t0 = time.perf_counter()
            sc_dict = mt.load_dict(ref)
            torch.cuda.synchronize()
            dict_s = time.perf_counter() - t0
        finally:
            for r in restore:
                r()
        say(f"[scene files] wrote {sizes} in {write_s:.2f} s; load_file "
            f"{file_s:.2f} s on {sc_file.device}: parse {parse_s * 1e3:.1f} "
            f"ms, mesh files {sum(mesh_s) * 1e3:.1f} ms ("
            + ", ".join(f"{x * 1e3:.1f}" for x in mesh_s)
            + f"), BVH build {sum(bvh_s[:n_bvh]):.2f} s; load_dict of the "
            f"same meshes {dict_s:.2f} s (its BVH build "
            f"{sum(bvh_s[n_bvh:]):.2f} s); {sc_file.faces.shape[0]} "
            f"triangles, {sc_file.bvh_nodes.shape[0]} BVH4 records; shapes "
            f"{sc_file.static.shape_names}")
        check(sc_file.static.spp == SF_SPP, "$spp not substituted")
        _assert_scenes_equal("load_file vs load_dict", sc_file, sc_dict)

        imgs, walls = {}, {}
        for label, sc in (("load_file", sc_file), ("load_dict", sc_dict)):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            imgs[label] = mt.render(sc, spp=SF_SPP, spp_chunk=SF_CHUNK,
                                    seed=0)
            torch.cuda.synchronize()
            walls[label] = (time.perf_counter() - t0) * 1e3
            counts = read_counts()
            count(f"render {label}", counts, expect)
            image_checks(imgs[label], RES)
        CT.raise_on_overflow(sc_file.device)
        same = bool(torch.equal(imgs["load_file"], imgs["load_dict"]))
        say(f"[scene files] renders {RES}^2 x {SF_SPP} spp in passes of "
            f"{SF_CHUNK}, depth {DEPTH}: load_file scene "
            f"{walls['load_file']:.1f} ms, load_dict scene "
            f"{walls['load_dict']:.1f} ms (first renders of each); images "
            f"equal bit for bit: {same}; launches {counts}")
        check(same, "the load_file and load_dict renders differ")

        exr = os.path.join(tmp, "out.exr")
        zero_counts()
        t0 = time.perf_counter()
        rc = cli.main([path, "-o", exr, "--spp", str(SF_SPP)])
        cli_s = time.perf_counter() - t0
        count("cli", read_counts(), {k: n // n_pass
                                     for k, n in expect.items()})
        img_cli = mt.read_image(exr).data
        img_ref = mt.render(sc_file, spp=SF_SPP, seed=0).cpu().numpy()
        same = bool(np.array_equal(img_cli, img_ref))
        say(f"[scene files] cli.main -o out.exr --spp {SF_SPP}: rc {rc}, "
            f"{cli_s:.2f} s (load, one {SF_SPP}-spp pass, EXR of "
            f"{os.path.getsize(exr)} bytes); read back {img_cli.shape}, "
            f"equal to render's image bit for bit: {same}")
        check(rc == 0 and same, "the CLI's EXR is not render's image")

    # traverse: move the sphere through update() and through set_vertices
    names = sc_file.static.shape_names
    s, c = sc_file.static.vertex_ranges[names.index("blob")]
    offset = torch.tensor([0.05, -0.03, 0.04], device=sc_file.device)
    params = mt.traverse(sc_file)
    check("blob.vertex_positions" in params.keys(), "no blob key")
    params["blob.vertex_positions"] = params["blob.vertex_positions"] + offset
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sc_t = params.update()
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) * 1e3
    v = sc_file.vertices.clone()
    v[s:s + c] += offset
    rows = torch.zeros(v.shape[0], dtype=torch.bool, device=v.device)
    rows[s:s + c] = True
    sc_s = NT.refresh_smooth_normals(sc_file.set_vertices(v), rows)
    same_nodes = bool(torch.equal(sc_t.bvh_nodes, sc_s.bvh_nodes)) and \
        not bool(torch.equal(sc_t.bvh_nodes, sc_file.bvh_nodes))
    imgs = {}
    for label, sc in (("update", sc_t), ("set_vertices", sc_s)):
        zero_counts()
        imgs[label] = mt.render(sc, spp=SF_SPP, spp_chunk=SF_CHUNK, seed=0)
        count(f"render {label}", read_counts(), expect)
    same = bool(torch.equal(imgs["update"], imgs["set_vertices"]))
    say(f"[scene files] traverse: {len(params.keys())} keys; update() "
        f"(positions, the sphere's smooth normals, refit + re-pack) "
        f"{update_ms:.1f} ms; records re-packed as set_vertices' and moved: "
        f"{same_nodes}; images equal bit for bit: {same}")
    check(same_nodes and same, "traverse().update() differs from "
          "set_vertices")
    o, d, maxt = main_path_rays(sc_t, gen, SF_CHUNK)
    k = slice(0, 65536)
    t, slot, u, vv = CT.closest_hit(sc_t.bvh_nodes, sc_t.bvh_tris, o[k],
                                    d[k], maxt[k])
    prim = torch.where(slot >= 0, sc_t.bvh.order[slot.clamp(min=0).long()],
                       -1)
    ref_hit = I.ray_intersect_brute(CI.pack_tris(sc_t.vertices, sc_t.faces),
                                    o[k], d[k], maxt[k])
    hold("scene files: K2 on the re-packed tree vs K1 brute force, moved "
         "sphere", (t, prim, u, vv, slot >= 0),
         (ref_hit[0], ref_hit[1].long(), ref_hit[2], ref_hit[3],
          ref_hit[1] >= 0))
    out.update(parse_s=parse_s, mesh_s=sum(mesh_s), bvh_s=sum(bvh_s[:n_bvh]),
               file_s=file_s, render_ms=walls, cli_s=cli_s,
               update_ms=update_ms)
    return out


# ---------------------------------------------------------------------------
# [glassslab]: the paper's normal-field experiment at its published widths
# ---------------------------------------------------------------------------

def glassslab_phase():
    """[glassslab]: ``run("manifold_caustic", glassslab.make(...))`` at
    512^2, spp 64, depth 4, match_res 256, a 16 x 16 grid (the published
    widths), ground truth 64 spp, GS_ITERS iterations (cut from the
    published 1,000, for the time limit): ms an iteration and by phase,
    K1 launches an iteration (exact), normal_field and its gradient
    finite and non-zero, peak memory, the device's busy share over one
    profiled iteration; then the normal_field gradient on the card
    against the CPU's at 64^2 x 4 spp."""
    run = experiment_run("glassslab", GS_SPP, GS_SPP, GS_ITERS,
                         match_res=GS_MATCH, profile_table=False)
    init = run.pop("exp")["init_theta"]["normal_field"].cpu().numpy()
    last = run["rows"][-1]["theta"]["normal_field"]
    say("[glassslab] dL/dnormal_field an iteration: "
        + "; ".join(f"max |g| {float(x['normal_field'].abs().max()):.6g}, "
                    f"|g| {float(x['normal_field'].norm()):.6g}"
                    for x in run["grads"])
        + f"; max |normal_field - init| after the last "
        f"{float(abs(last - init).max()):.6g}")
    run["cpu"] = exp_card_vs_cpu((("glassslab", 4),), "glassslab, card vs cpu")
    return run


# ---------------------------------------------------------------------------
# [camera]: reconstruction filters, sampler kinds and sensor kinds
# ---------------------------------------------------------------------------

#: launch counts summed over a phase: ``zero_counts`` adds the counts it
#: clears here while this is a dict
_TALLY = None


def camera_dict(make, rfilter=None, sampler="stratified", sensor=None,
                **kw):
    """``make(**kw)`` (a scene dict of ``epsm_mitsuba3_torch.scenes``) with
    the film's filter (None: no rfilter entry, so the hdrfilm's default
    gaussian), the sampler kind and the sensor's entries changed."""
    d = make(**kw)
    s = d["sensor"]
    if rfilter is None:
        s["film"].pop("rfilter", None)
    else:
        s["film"]["rfilter"] = {"type": rfilter}
    s["sampler"]["type"] = sampler
    s.update(sensor or {})
    return d


def batch_sensor(d):
    """``d`` with its sensor replaced by a batch sensor of two perspective
    views side by side, on a film as wide as the old one."""
    from epsm_mitsuba3_torch.core.transform import ScalarTransform4f as T
    s = d["sensor"]
    views = {f"view{i}": {
        "type": "perspective", "fov": 35.0 + 10 * i,
        "to_world": T.look_at(origin=[0.4 * i - 0.2, 1, 3.9],
                              target=[0, 1, 0], up=[0, 1, 0]).matrix}
        for i in range(2)}
    d["sensor"] = {"type": "batch", **views, "film": s["film"],
                   "sampler": s["sampler"]}
    return d


def seeded_kinds(fn):
    """(fn's result, the sampler kinds ``samplers.seed`` was asked for
    while fn ran, in order)."""
    from epsm_mitsuba3_torch.models import samplers as smp
    kinds, seed = [], smp.seed

    def spy(*a, **kw):
        kinds.append(kw.get("kind", "independent"))
        return seed(*a, **kw)

    smp.seed = spy
    try:
        return fn(), kinds
    finally:
        smp.seed = seed


def film_costs(label, spp):
    """The gaussian film of one PRB pass at 512^2 x ``spp`` on its own:
    ``_film_fn`` (the roll-sum ``splat_coalesced`` and ``develop``) and
    its adjoint ``film_adjoint``, by CUDA events and torch.profiler (ms,
    launches, the memory they add at their peak); the general scatter
    ``splat`` (the EPSM primal's film) beside it; each run twice, the
    roll-sum's results bit for bit alike, the scatter's (float atomics)
    within 1e-5 of its largest entry, the two splats within 1e-4 of the
    largest entry of each other (the scatter weighs a sample by the
    filter at px + 0.5 - x, whose float32 rounding grows with the film
    coordinate x; the roll-sum at the jitter alone)."""
    import torch
    from epsm_mitsuba3_torch.ad import prb
    from epsm_mitsuba3_torch.models import films
    from epsm_mitsuba3_torch.models.sensors import Sensor
    dev = torch.device("cuda")
    n = RES * RES * spp
    gen = torch.Generator(device=dev).manual_seed(5)
    pix = torch.arange(n, device=dev) // spp
    corner = torch.stack([pix % RES, pix // RES], -1).float()
    pos = corner + torch.rand(n, 2, device=dev, generator=gen)
    # where pixel + jitter rounds up to the next integer, the roll-sum
    # (as the reference's) splats the sample from its own pixel with
    # jitter 0: the scatter is held at those positions
    rounded = int((torch.floor(pos) != corner).any(-1).sum())
    pos_lane = corner + (pos - torch.floor(pos))
    vals = torch.rand(n, 3, device=dev, generator=gen)
    weight = torch.ones(n, 3, device=dev)
    g_img = torch.randn(RES, RES, 3, device=dev, generator=gen)
    sensor = Sensor(to_world=torch.eye(4, device=dev), width=RES, height=RES,
                    rfilter="gaussian")
    calls = {
        "film": lambda: prb._film_fn(vals, pos, weight, sensor, spp),
        "adjoint": lambda: prb.film_adjoint(g_img, pos, weight, sensor, spp,
                                            n),
        "splat": lambda: films.develop(*films.splat(pos_lane, vals, RES,
                                                    RES, "gaussian"))}
    out = {}
    for name, fn in calls.items():
        a, b = fn(), fn()
        torch.cuda.synchronize()
        ms = cuda_ms(fn, 5, warm=1)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        extra = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        prof = profile_pass(f"{label}: {name}", fn, ("roll", "index_add"),
                            cpu=False, table=False)
        diff = float((a - b).abs().max())
        out[name] = dict(ms=ms, launches=prof["launches"] if prof else None,
                         extra_mib=extra, rerun_max_abs=diff, out=a)
    check(out["film"]["rerun_max_abs"] == 0.0
          and out["adjoint"]["rerun_max_abs"] == 0.0,
          "camera: splat_coalesced is not deterministic on the card")
    top = float(out["splat"]["out"].abs().max())
    check(out["splat"]["rerun_max_abs"] <= 1e-5 * top,
          "camera: two runs of the scatter differ beyond 1e-5")
    err = float((out["film"]["out"] - out["splat"]["out"]).abs().max()) / top
    check(err <= 1e-4, f"camera: splat_coalesced and splat differ by {err}")
    say(f"[camera] {label}, {RES}^2 x {spp} spp ({n} lanes): "
        + "; ".join(f"{k} {v['ms']:.2f} ms, {v['launches']} launches, "
                    f"+{v['extra_mib']:.1f} MiB at its peak, rerun max "
                    f"|diff| {v['rerun_max_abs']:.3g}"
                    for k, v in out.items())
        + f"; splat_coalesced vs splat {err:.3g} of the largest entry "
        f"({rounded} lanes' pixel + jitter rounded to the next integer) "
        "[limits: reruns of the roll-sum 0, of the scatter 1e-5; the two "
        "1e-4]")
    for v in out.values():
        v.pop("out")
    out["rounded_lanes"] = rounded
    return out


def camera_card_vs_cpu():
    """[camera card vs cpu] at 64^2 x 4 spp, depth 6 (the gates of
    ``card_vs_cpu`` and ``grad_card_vs_cpu``): every filter with the
    independent and the stratified sampler; each sampler kind at spp 16
    and 9; each sensor kind (a thin lens of aperture 0.08, a batch sensor
    of two views); PRB gradients through a gaussian film with the
    stratified sampler and through a thin lens with a Lanczos film and
    the multijitter sampler; the manifold backward on a gaussian,
    stratified box."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.core.transform import ScalarTransform4f as T
    from epsm_mitsuba3_torch.integrators import epsm as ET
    from epsm_mitsuba3_torch.models import films, samplers, sensors
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.scenes import cornell_box
    box = dict(res=64, spp=4, max_depth=DEPTH)
    for rf in films.FILTERS:
        for smp in ("independent", "stratified"):
            card_vs_cpu(f"{rf} / {smp}", camera_dict(cornell_box, rf, smp,
                                                     **box), 4)
    for smp in samplers.KINDS:
        for spp in (16, 9):
            card_vs_cpu(f"gaussian / {smp} at spp {spp}", camera_dict(
                cornell_box, None, smp, res=64, spp=spp, max_depth=DEPTH),
                spp)
    probe = T.look_at(origin=[0.1, 1.2, 1.5], target=[0, 0.6, -1],
                      up=[0, 1, 0]).matrix
    sensor_cases = {
        "perspective": {},
        "thinlens": {"aperture_radius": 0.08, "focus_distance": 3.9},
        "orthographic": {"to_world": T.look_at(
            origin=[0, 1, 3.9], target=[0, 1, 0], up=[0, 1, 0]).scale(
                [0.9, 0.9, 1]).matrix},
        "distant": {}, "radiancemeter": {"to_world": probe},
        "irradiancemeter": {"to_world": probe}, "batch": None}
    check(set(sensor_cases) == set(sensors.KINDS), "camera: sensor kinds")
    for kind, extra in sensor_cases.items():
        d = camera_dict(cornell_box, None, "stratified", **box)
        if kind == "batch":
            d = batch_sensor(d)
        else:
            d["sensor"].update({"type": kind, **extra})
        card_vs_cpu(f"{kind} sensor, gaussian / stratified", d, 4)
    # PRB gradients through the film (face normals: vertex gradients)
    for label, rf, smp, sensor in (
            ("gaussian / stratified", None, "stratified", None),
            ("thinlens, lanczos / multijitter", "lanczos", "multijitter",
             sensor_cases["thinlens"])):
        d = camera_dict(cornell_box, rf, smp, sensor, **box)
        if sensor:
            d["sensor"]["type"] = "thinlens"
        for k in ("floor", "ceiling", "back", "left", "right"):
            d[k]["face_normals"] = True
        grad_card_vs_cpu(f"cornell_box {label}", d, 4)
    # the manifold backward on a stratified scene (independent samples)
    d = camera_dict(cornell_box, None, "stratified", **box)
    g = torch.randn(64, 64, 5, generator=torch.Generator().manual_seed(3))
    names = ("vertices", "bsdfs.reflectance")
    got = {}
    for dev in ("cuda", "cpu"):
        sc = mt.load_dict(d, device=dev)
        got[dev] = ET.render_backward(sc, names, g.to(sc.device) * 0.05, 3,
                                      DEPTH, 5, False, -1, 4)
        if dev == "cuda":
            CT.raise_on_overflow(sc.device)
    errs = {k: rel_l2(got["cuda"][k].cpu(), got["cpu"][k]) for k in names}
    say("[camera card vs cpu] manifold backward, gaussian / stratified box "
        "64^2 x 4 spp: |g_gpu - g_cpu| / |g_cpu| "
        + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
        + "  [limit 1e-3 each]")
    for k, e in errs.items():
        check(e <= 1e-3 and float(got["cpu"][k].abs().max()) > 0,
              f"camera: manifold backward {k} card vs cpu {e}")


def camera_phase():
    """[camera]: the box (K1) and cornell_box_mesh (K2/K3) at 512^2 with no
    rfilter (the hdrfilm's default gaussian) and the stratified sampler,
    at the render cells' spp (64 in passes of 4, 16 in passes of 8): a
    warm-up and TIMED_RENDERS timed renders each, launches exact, one
    profiled pass each, peak memory; the mesh's fwd+bwd cell (2 passes of
    8 spp) with the same film and sampler, and one profiled pass; the
    gaussian film of a pass on its own (``film_costs``); one warm-up and
    two timed ``manifold`` iterations of the epsm-mesh cell with a
    gaussian sensor on a stratified scene, whose forward and backward
    must seed the independent sampler; then ``camera_card_vs_cpu``.
    Returns the numbers and the K1-K4 launches of the phase."""
    global _TALLY
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops.sinkhorn import Matcher
    from epsm_mitsuba3_torch.scenes import cornell_box, cornell_box_mesh
    zero_counts()
    _TALLY = {}
    out = {}
    try:
        # -- full width renders: K1 and K2/K3 through the gaussian film --
        for label, make, spp, chunk, expect, names in (
                ("camera box", cornell_box, SPP, SPP_CHUNK,
                 {"mt_closest_hit": DEPTH * (SPP // SPP_CHUNK),
                  "mt_any_hit": DEPTH * (SPP // SPP_CHUNK),
                  "bvh4_closest_hit": 0, "bvh4_any_hit": 0},
                 ("mt_closest", "mt_any")),
                ("camera mesh", cornell_box_mesh, MESH_SPP, MESH_CHUNK,
                 {"mt_closest_hit": 0, "mt_any_hit": 0,
                  "bvh4_closest_hit": DEPTH * (MESH_SPP // MESH_CHUNK),
                  "bvh4_any_hit": DEPTH * (MESH_SPP // MESH_CHUNK)},
                 ("bvh4_closest", "bvh4_any"))):
            scene = mt.load_dict(camera_dict(make, res=RES, spp=chunk,
                                             max_depth=DEPTH))
            check(scene.sensors[0].rfilter == "gaussian"
                  and scene.static.sampler_kind == "stratified",
                  f"{label}: not a gaussian / stratified scene")
            torch.cuda.reset_peak_memory_stats()
            median, counts = render_phase(label, scene, spp, chunk, expect)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            prof = profile_pass(f"{label}, one {chunk}-spp pass",
                                lambda: mt.render(scene, spp=chunk, seed=7),
                                names + ("roll",))
            say(f"[{label}] peak device memory {peak:.2f} GiB")
            out[label] = dict(median_ms=median, counts=counts, peak_gib=peak,
                              profile=prof)
            del scene
        # -- PRB fwd+bwd: the mesh cell with the gaussian film --
        mesh = mt.load_dict(camera_dict(cornell_box_mesh, res=RES,
                                         spp=MESH_CHUNK, max_depth=DEPTH))
        median, mrays, counts, (sc, lv) = train_phase(
            "camera train mesh", mesh, MESH_CHUNK, MESH_PASSES,
            {"bvh4_closest_hit": DEPTH, "bvh4_closest_hit_mp": 0,
             "bvh4_any_hit": DEPTH, "mt_closest_hit": 0, "mt_any_hit": 0})
        prof = profile_pass(f"camera train mesh, one {MESH_CHUNK}-spp "
                            "fwd+bwd pass",
                            lambda: fwd_bwd(sc, lv, MESH_CHUNK, 99),
                            ("bvh4_closest", "bvh4_any", "roll"))
        out["camera train mesh"] = dict(median_ms=median, mrays=mrays,
                                        counts=counts, profile=prof)
        del mesh, sc, lv
        out["film"] = film_costs("gaussian film of a mesh pass", MESH_CHUNK)
        # -- EPSM: a manifold iteration, gaussian sensor, stratified scene --
        scene = mt.load_dict(camera_dict(cornell_box_mesh, res=EPSM_RES,
                                         spp=EPSM_SPP, max_depth=DEPTH))
        dev = scene.device
        with torch.no_grad():
            gt = mt.render(scene, spp=EPSM_SPP, seed=123,
                           integrator={"type": "path", "max_depth": DEPTH})
        gt_low = gt.reshape(-1, 3)
        matcher = Matcher(EPSM_RES)
        v0 = scene.vertices
        ex = torch.tensor([1.0, 0.0, 0.0], device=dev)
        integ = {"type": "manifold", "max_depth": DEPTH}

        def iteration(seed):
            theta = torch.tensor(0.01, device=dev, requires_grad=True)
            sc = scene.set_vertices(v0 + theta * ex)
            img = mt.render(sc, spp=EPSM_SPP, seed=seed, integrator=integ)
            with torch.no_grad():
                g5 = matcher.match_Sinkhorn(img[..., :3].reshape(-1, 3),
                                            gt_low).reshape(EPSM_RES,
                                                            EPSM_RES, 5)
            (g,) = torch.autograd.grad(torch.sum(img * g5), theta)
            return float(g)

        walls = []
        torch.cuda.reset_peak_memory_stats()
        for i, run in enumerate(("warm-up", "timed 1", "timed 2")):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g, kinds = seeded_kinds(lambda: iteration(i))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            counts = read_counts()
            say(f"[camera epsm] {run}: {walls[-1]:.1f} ms, dL/dtheta "
                f"{g:.6g}, sampler kinds seeded {kinds}, launches {counts}")
            check(math.isfinite(g) and g != 0.0,
                  f"camera epsm: gradient {g}")
            check(kinds == ["independent", "independent"],
                  f"camera epsm: the manifold pass seeded {kinds}, expected "
                  "the independent sampler in the forward and the backward")
            for k, n in {"bvh4_closest_hit": 4 * DEPTH + 1,
                         "bvh4_any_hit": 3 * DEPTH}.items():
                check(counts[k] == n, f"camera epsm: {k} launched "
                      f"{counts[k]} times, expected {n}")
        _, kinds = seeded_kinds(lambda: mt.render(scene, spp=1, seed=1))
        check(kinds == ["stratified"], f"camera: PRB seeded {kinds}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        say(f"[camera epsm] cornell_box_mesh {EPSM_RES}^2 x {EPSM_SPP} spp, "
            "gaussian sensor, stratified scene sampler (the manifold passes "
            f"seed independent, PRB stratified): iterations "
            f"{walls[1]:.1f} / {walls[2]:.1f} ms; peak device memory "
            f"{peak:.2f} GiB")
        out["camera epsm"] = dict(walls=walls[1:], counts=counts,
                                  peak_gib=peak)
        del scene
        camera_card_vs_cpu()
        zero_counts()
        out["total"], _TALLY = _TALLY, None
    finally:
        _TALLY = None
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on "
              "the GPU", file=sys.stderr)
        return 1
    start = time.perf_counter()
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.models import mesh_io as MIO
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
    _native.build([CI.SPEC, CT.SPEC, BT.SPEC, MIO.SPEC])
    CI.build()
    CT.build()
    say(f"[build] K1, K2/K4/K3 (nvcc), the BVH builder and the OBJ parser "
        f"(g++) built in {time.perf_counter() - t0:.1f} s")
    for lib in (CI.SPEC.name, CT.SPEC.name):
        for line in _native.build_logs.get(lib, "").splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line or "stack frame" in line:
                say(f"[build] {lib}: {line.strip()}")
    k4_regs = k4_registers(_native.build_logs.get(CT.SPEC.name, ""))
    for key, use in k4_regs.items():
        say(f"[build] K4 {key}: {use}")

    # -- 2. K1 against its plain version, at three shapes -----------------
    gen = torch.Generator(device=dev).manual_seed(1)
    box = mt.load_dict(cornell_box(res=RES, spp=SPP_CHUNK, max_depth=DEPTH))
    tri_box = CI.pack_tris(box.vertices, box.faces)
    rays_box = main_path_rays(box, gen, SPP_CHUNK)
    shapes = {
        "i": ("Cornell-box shape", tri_box, *rays_box),
        "ii": ("largest shape", *soup_rays(4096, 65536, gen, dev)),
        "iii": ("largest shape, a user's pass",
                *soup_rays(4096, 2 ** 20, gen, dev))}
    k1_err, k1_times = {}, {}
    for key, (label, *args) in shapes.items():
        k1_err[key] = compare_k1(label, *args)
        k1_times[key] = time_k1(*args, iters={"i": 50, "ii": 20,
                                              "iii": 5}[key],
                                plain=key != "iii")
    del rays_box, shapes
    k1_render = render_rays_k1(box, SPP_CHUNK)
    k1_sweep = k1_rule_sweep(gen, dev)
    times = k1_times["i"]
    c3 = k1_times["iii"]["mt_closest_hit"]
    ratio = {key: t["mt_any_hit"]["ms"] / t["mt_closest_hit"]["ms"]
             for key, t in k1_times.items()}
    say(f"[speed] closest hit at shape iii: {c3['bound_ms'] / c3['ms']:.1%} "
        "of its bound (aim >= 60 %); any / closest at ii and iii: "
        f"{ratio['ii']:.3f}, {ratio['iii']:.3f} (aim <= 0.25)")

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

    # -- 5. K4 against its plain version, K2 and the brute force; times ------
    k4 = compare_k4(mesh, *rays_mesh)
    bvh_times = time_bvh(mesh, *rays_mesh, bvh["plain_ms"], bvh["work"], k4)
    k4_steps = time_k4_steps(mesh, *rays_mesh,
                             bvh_times["bvh4_closest_hit"]["bound_ms"])
    steps = time_steps(mesh, *rays_mesh)
    lanes = lane_utilisation(mesh, *rays_mesh)
    del rays_mesh
    per_depth = render_rays(mesh, MESH_CHUNK)

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
    profile_pass(f"train mesh K4, one {MESH_CHUNK}-spp fwd+bwd pass",
                 lambda: fwd_bwd(sc_mesh, lv_mesh, MESH_CHUNK, 99, mp),
                 ("bvh4_closest", "bvh4_any"))
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

    # -- 11-13. the EPSM leg: bench.py's manifold_iter on the mesh, the
    # cornellbox experiment at its widths, card against CPU ------------------
    epsm_mesh = epsm_mesh_phase()
    epsm_cb = epsm_cornellbox_phase()
    epsm_card_vs_cpu(epsm_mesh["x"], epsm_mesh["y"])
    epsm_launches = {"launches_epsm_mesh_iteration": epsm_mesh["counts"],
                     "launches_epsm_cornellbox_run": epsm_cb["total"]}

    # -- 14. [epsm experiments]: glass, rough metal and many objects --------
    epsm_exp = epsm_experiments_phase()
    epsm_launches["launches_epsm_experiments_runs"] = epsm_exp["total"]

    # -- 15. [scene files]: XML + PLY/OBJ/serialized, the CLI, traverse ------
    t0 = time.perf_counter()
    sf = scene_files_phase(gen)
    epsm_launches["launches_scene_files_phase"] = sf["total"]
    say(f"[scene files] phase {time.perf_counter() - t0:.1f} s")

    # -- 16. [glassslab]: the normal-field experiment at its widths ----------
    t0 = time.perf_counter()
    gs = glassslab_phase()
    epsm_launches["launches_glassslab_run"] = gs["total"]
    say(f"[glassslab] phase {time.perf_counter() - t0:.1f} s")

    # -- 17. [camera]: filters, samplers and sensors on every path ----------
    t0 = time.perf_counter()
    cam = camera_phase()
    epsm_launches["launches_camera_phase"] = cam["total"]
    say(f"[camera] phase {time.perf_counter() - t0:.1f} s; launches "
        f"{cam['total']}")

    # -- kernels line: launches of the fwd+bwd cells' last timed run ----------
    kernels = []
    for i, k in enumerate(("mt_closest_hit", "mt_any_hit")):
        v = times[k]
        kernels.append({
            "name": k, "route": "cuda",
            "source": "epsm_mitsuba3_torch/csrc/mt_intersect.cu",
            "replaces": "epsm_mitsuba3_tpu/ops/pallas_intersect.py:25",
            "launches": train_box[k],
            "max_abs_err": max(e[i] for e in k1_err.values()),
            "ms": v["ms"], "plain_ms": v["plain_ms"],
            "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
            "library_ms": None,
            "steps_ms": {key: t[k]["steps_ms"]
                         for key, t in k1_times.items()},
            "ms_4096": {"65536": k1_times["ii"][k]["ms"],
                        "1048576": k1_times["iii"][k]["ms"]},
            "bound_ms_4096": {"65536": k1_times["ii"][k]["bound_ms"],
                              "1048576": k1_times["iii"][k]["bound_ms"]},
            "plain_ms_4096": {"65536": k1_times["ii"][k]["plain_ms"]},
            "render_rays_ms": [r["closest main" if i == 0 else "any main"]
                               for r in k1_render],
            "sweep_ms": {key: {"rule": row[k]["rule"], **row[k]["ms"]}
                         for key, row in k1_sweep.items()}})
    ref = bvh_times["bvh4_closest_hit_ref"]
    for i, (k, line, kk) in enumerate((("bvh4_closest_hit", 164, "K2"),
                                       ("bvh4_any_hit", 446, "K3"))):
        v = bvh_times[k]
        kernels.append({
            "name": k, "route": "cuda",
            "source": "epsm_mitsuba3_torch/csrc/bvh_traverse.cu",
            "replaces": f"epsm_mitsuba3_tpu/ops/pallas_traverse.py:{line}",
            "launches": train_mesh[k], "max_abs_err": bvh["err"][i],
            "ms": v["ms"], "ms_unsorted": v["ms_unsorted"],
            "device_ms": v["device_ms"],
            "ms_sorted": v["ms_sorted"], "ms_presorted": v["ms_presorted"],
            "plain_ms": v["plain_ms"],
            "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
            "library_ms": None,
            "steps_ms": {n: {kind.split(" ", 1)[1]: t
                             for kind, t in ms.items()
                             if kind.startswith(kk)}
                         for n, ms in steps.items()},
            "render_rays_ms": [r[f"{kk}_ms"] for r in per_depth]})
    kernels[2].update({
        "reference_ms": ref["ms_unsorted"],
        "reference_ms_sorted": ref["ms_sorted"],
        "reference_ms_presorted": ref["ms_presorted"],
        "reference_render_rays_ms": [r["reference_ms"] for r in per_depth],
        "lane_utilisation": {k: v for k, v in lanes.items()
                             if not k.startswith("K4")}})
    v, v2 = bvh_times["bvh4_closest_hit_mp P=4"], bvh_times[
        "bvh4_closest_hit_mp P=2"]
    kernels.append({
        "name": "bvh4_closest_hit_mp", "route": "cuda",
        "source": "epsm_mitsuba3_torch/csrc/bvh_traverse.cu",
        "replaces": "epsm_mitsuba3_tpu/ops/pallas_traverse.py:308",
        "multi_pop": 4, "launches": train_mp["bvh4_closest_hit_mp"],
        "max_abs_err": k4[4]["err"], "tie_rays": k4[4]["ties"],
        "ms": v["ms"], "ms_sorted": v["ms_sorted"],
        "ms_presorted": v["ms_presorted"],
        "ms_p2": v2["ms"], "ms_p2_sorted": v2["ms_sorted"],
        "ms_p2_presorted": v2["ms_presorted"], "plain_ms": v["plain_ms"],
        "device_ms": v["device_ms"], "device_ms_p2": v2["device_ms"],
        "plain_ms_p2": v2["plain_ms"],
        "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
        "schedule_pops_per_ray": k4[4]["work"][0] / (RES * RES * MESH_CHUNK),
        "schedule_tests_per_ray": k4[4]["work"][1] / (RES * RES * MESH_CHUNK),
        "schedule_p2_pops_per_ray": k4[2]["work"][0] / (RES * RES
                                                        * MESH_CHUNK),
        "schedule_p2_tests_per_ray": k4[2]["work"][1] / (RES * RES
                                                         * MESH_CHUNK),
        "launch": dataclasses.asdict(CT.K4_SCHEDULE),
        "steps_ms": {k: t for k, t in k4_steps.items() if k.startswith("P=")},
        "k2_ms_beside_steps": k4_steps["K2"],
        "registers": k4_regs,
        "lane_utilisation": {k: v for k, v in lanes.items()
                             if k.startswith("K4")},
        "render_rays_ms": [r["K4 P=4_ms"] for r in per_depth],
        "render_rays_ms_p2": [r["K4 P=2_ms"] for r in per_depth],
        "library_ms": None})
    for entry in kernels:
        for key, counts in epsm_launches.items():
            entry[key] = counts.get(entry["name"], 0)
    # each kernel on the experiments' own rays: K1 at egg's 3,972
    # triangles, K2/K3 on shadow's 1,587,204
    for entry, rows, kind in ((kernels[0], epsm_exp["k1"], "closest"),
                              (kernels[1], epsm_exp["k1"], "any"),
                              (kernels[2], epsm_exp["k23"], "closest"),
                              (kernels[3], epsm_exp["k23"], "any")):
        scene = "egg" if entry["name"].startswith("mt_") else "shadow"
        entry[f"{scene}_rays"] = [
            {"depth": r["depth"], "rays": r["rays"],
             "live": r[f"live_{kind}"], "ms": r[f"{kind}_ms"],
             "bound_ms": r[f"{kind}_bound_ms"],
             "bound_by": r[f"{kind}_bound_by"],
             "plain_ms": r[f"{kind}_plain_ms"],
             "plain_rays": r["plain_rays"]} for r in rows]
    say(f"[time] chip_smoke.py ran {time.perf_counter() - start:.1f} s, "
        f"the kernels' build included")
    say(json.dumps({"kernels": kernels}))
    say(f"[device] {gpu}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
