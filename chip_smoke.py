#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and hold every
hand-written kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (any failed check raises, and the script exits non-zero):

1. build kernel K1 (``epsm_mitsuba3_torch/csrc/mt_intersect.cu``) with
   nvcc for sm_90a and print the card's name and power limit;
2. K1's closest-hit and any-hit entries against the plain versions on the
   card, at the main path's shape (the Cornell box's 12 triangles against
   2^20 camera and bounce rays, some dead) and at the largest scene K1
   serves (4,096 triangles against 65,536 rays), and their times;
3. the main path at full width: ``render(load_dict(cornell_box(512, 64,
   6)), spp=64, spp_chunk=4)``: a warm-up and five timed renders, with
   K1's launch counts set to 0 before and read after each;
4. the same small scene rendered on the card and on the CPU.

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
#: Main-path workload: the Cornell box at 512^2, 64 spp in passes of 4,
#: max depth 6 (one closest-hit and one shadow query a bounce)
RES, SPP, SPP_CHUNK, DEPTH = 512, 64, 4, 6
TIMED_RENDERS = 5


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


def cuda_ms(fn, iters):
    """Mean ms a call of ``fn`` on the card, by CUDA events, after warm-up."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main_path_rays(scene, gen):
    """2^20 rays of the main path's kinds: camera rays (even lanes) and
    random bounce rays from the camera hits (odd lanes), some of finite
    extent; a tenth of all lanes dead (maxt = 0)."""
    import torch
    from epsm_mitsuba3_torch.integrators import common
    from epsm_mitsuba3_torch.models import samplers as smp
    sensor = scene.sensors[0]
    n = sensor.width * sensor.height * SPP_CHUNK
    sampler = smp.seed(0, n, device=scene.device)
    _, cam, _, _ = common.sample_rays(sensor, sampler, SPP_CHUNK)
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


def compare_k1(label, tri, o, d, maxt):
    """Both K1 entries against the plain versions on the same inputs."""
    import torch
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    from epsm_mitsuba3_torch.ops import intersect as I
    t, prim, u, v = CI.closest_hit(tri, o, d, maxt)
    occ = CI.any_hit(tri, o, d, maxt)
    torch.cuda.synchronize()
    t_p, prim_p, u_p, v_p = I.ray_intersect_brute(tri, o, d, maxt)
    occ_p = I.ray_test_brute(tri, o, d, maxt)
    n = o.shape[0]
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
    say(f"[K1 {label}] rays {n} tris {tri.shape[0]} hits "
        f"{int((prim_p >= 0).sum())}: prim differs on {n_diff} lanes, "
        f"valid on {n_valid_diff}, any-hit on {n_occ_diff}; "
        f"any-hit == closest valid: {self_consistent}; max |err| "
        + ", ".join(f"{k} {a:.3g} (rel {r:.3g})" for k, (a, r)
                    in errs.items())
        + "  [limits: >= 99.99 % agree, |err| <= 1e-5 * max(|ref|, 1)]")
    check(n_diff <= 1e-4 * n and n_valid_diff <= 1e-4 * n,
          f"K1 {label}: closest hit disagrees on {n_diff} lanes")
    check(n_occ_diff <= 1e-4 * n,
          f"K1 {label}: any hit disagrees on {n_occ_diff} lanes")
    check(self_consistent, f"K1 {label}: any-hit != closest-hit valid")
    for k, (_, rel) in errs.items():
        check(rel <= 1e-5, f"K1 {label}: {k} off by {rel} relative")
    return (max(a for a, _ in errs.values()),
            float((occ != occ_p).float().max()) if n else 0.0)


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


def profile_pass(scene):
    """Device time by kernel over one 4-spp pass (torch.profiler); the
    full table goes to standard error."""
    import torch
    import epsm_mitsuba3_torch as mt
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mt.render(scene, spp=SPP_CHUNK, seed=7)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    key = ("device_time_total" if hasattr(avgs[0], "device_time_total")
           else "cuda_time_total")
    # kernels only: an operator's device time repeats its kernels' time
    kernels = [e for e in avgs if getattr(e, key) > 0 and getattr(
        e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy = sum(getattr(e, key) for e in kernels) / 1e3
    k1 = sum(getattr(e, key) for e in kernels
             if "mt_closest" in e.key or "mt_any" in e.key) / 1e3
    print(avgs.table(sort_by=key, row_limit=30), file=sys.stderr)
    if not kernels:
        say(f"[profile] one pass: wall {wall:.1f} ms; the profiler saw no "
            "device time (not measured)")
        return
    top = sorted(kernels, key=lambda e: -getattr(e, key))[:8]
    say("[profile] one pass: wall %.1f ms, device busy %.1f ms (%.1f %%), "
        "K1 %.2f ms (%.1f %% of busy), %d kernel launches; top: %s" % (
            wall, busy, 100 * busy / wall, k1, 100 * k1 / busy,
            sum(e.count for e in kernels),
            "; ".join(f"{e.key[:40]} {getattr(e, key) / 1e3:.2f} ms"
                      f" x{e.count}" for e in top)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on "
              "the GPU", file=sys.stderr)
        return 1
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    from epsm_mitsuba3_torch.scenes import cornell_box

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    gpu = gpu_line()
    say(f"[device] {gpu} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {name} x{torch.cuda.device_count()}")

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    CI.build()
    say(f"[build] K1 built in {time.perf_counter() - t0:.1f} s")
    for line in CI.build_log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"[build] {line.strip()}")

    # -- 2. K1 against its plain version ------------------------------------
    gen = torch.Generator(device=dev).manual_seed(1)
    box = mt.load_dict(cornell_box(res=RES, spp=SPP_CHUNK, max_depth=DEPTH))
    tri_box = CI.pack_tris(box.vertices, box.faces)
    rays_box = main_path_rays(box, gen)
    err_box = compare_k1("main-path shape", tri_box, *rays_box)
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

    # -- 3. the main path at full width ------------------------------------
    scene = mt.load_dict(cornell_box(res=RES, spp=SPP, max_depth=DEPTH))
    n_passes = SPP // SPP_CHUNK
    expect = DEPTH * n_passes
    walls = []
    for run in ["warm-up"] + [f"timed {i + 1}" for i in range(TIMED_RENDERS)]:
        for k in CI.launches:
            CI.launches[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = mt.render(scene, spp=SPP, spp_chunk=SPP_CHUNK, seed=0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        counts = dict(CI.launches)
        say(f"[render] {run}: {walls[-1]:.1f} ms, K1 launches {counts}")
        for k in counts:
            check(counts[k] == expect,
                  f"{k} launched {counts[k]} times, expected {expect}")
        image_checks(img, RES)
    timed = sorted(walls[1:])
    median = timed[len(timed) // 2]
    rays = RES * RES * SPP_CHUNK * DEPTH * 2 * n_passes
    say(f"[render] {RES}^2 x {SPP} spp ({n_passes} passes of {SPP_CHUNK}),"
        f" depth {DEPTH}: wall median {median:.1f} ms of {len(timed)} "
        f"(min {timed[0]:.1f}, max {timed[-1]:.1f}); "
        f"{rays / (median / 1e3) / 1e6:.2f} physical Mrays/s at the median;"
        f" K1 {sum(counts.values())} launches a render, "
        + ", ".join(f"{k} {v['ms']:.4f} ms a launch (bound "
                    f"{v['bound_ms']:.4f})" for k, v in times.items()))
    profile_pass(scene)

    # -- 4. card against CPU --------------------------------------------------
    small = cornell_box(res=64, spp=4, max_depth=DEPTH)
    img_gpu = mt.render(mt.load_dict(small), spp=4, seed=0).cpu()
    img_cpu = mt.render(mt.load_dict(small, device="cpu"), spp=4, seed=0,
                        device="cpu")
    diff = (img_gpu - img_cpu).abs()
    mad, mean = float(diff.mean()), float(img_cpu.mean())
    within = float((diff.amax(-1) <= 1e-3).float().mean())
    say(f"[cpu] 64^2 x 4 spp: mean |gpu - cpu| {mad:.3g} (limit "
        f"{1e-3 * mean:.3g} = 1e-3 x mean {mean:.4f}); {100 * within:.2f} % "
        "of pixels within 1e-3 (limit 99 %)")
    check(mad <= 1e-3 * mean and within >= 0.99,
          "card and CPU renders disagree")

    # -- kernels line -------------------------------------------------------
    kernels = []
    for i, k in enumerate(("mt_closest_hit", "mt_any_hit")):
        err = max(err_box[i], err_big[i])
        v = times[k]
        kernels.append({
            "name": k, "route": "cuda",
            "source": "epsm_mitsuba3_torch/csrc/mt_intersect.cu",
            "replaces": "epsm_mitsuba3_tpu/ops/pallas_intersect.py:25",
            "launches": counts[k], "max_abs_err": err,
            "ms": v["ms"], "plain_ms": v["plain_ms"],
            "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
            "library_ms": None})
    say(json.dumps({"kernels": kernels}))
    say(f"[device] {gpu}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
