// K2, K4 and K3: closest-hit (single- and multi-pop) and any-hit traversal
// of a BVH4 with fat leaves, for Hopper.
//
// Replaces: epsm_mitsuba3_tpu/ops/pallas_traverse.py _traverse_kernel
// (:164, K2; launched by _run :547 for bvh_ray_intersect_pallas :710),
// _traverse_kernel_mp (:308, K4; the same _run when multi_pop > 1) and
// _anyhit_kernel (:446, K3; _run_anyhit :587, bvh_ray_test_pallas :986).
// Plain versions: ops/traverse.py bvh_ray_intersect_plain (multi_pop
// for K4) / bvh_ray_test_plain, which walk the tree in the same order.
//
// What bounds it: the work is data-dependent, node pops and triangle tests
// a ray.  On the main path (64,812 triangles, camera, bounce and shadow
// rays) a ray reads 44 bytes of ray and hit against a few thousand FP32
// operations of slab and Moeller-Trumbore tests, so the FP32 instruction
// rate bounds the function: the tree (1.4k records of 128 B, 182 KB) and
// the leaf-ordered triangles (2.3 MB) stay in the 50 MB L2.  The
// one-thread-a-ray walk ran at 2 % of that bound, held back twice over
// (lane utilisation from the counting builds, chip_smoke.py): a live ray
// tests ~10 triangles of fat leaves of up to 32 one after another, each a
// chain of scattered loads, while its warp's other lanes idle (7 % of the
// lanes active in the leaf loop); and a warp runs until its longest ray is
// done (32 % active in the traversal loop).
//
// Design (K2 and K3): one lane a ray, with its own stack of up to 64
// entries in local memory, walking the tree in the plain version's order:
// pop, stale-entry cull (a popped key not below the ray's current t is
// skipped), slab test of the record's 4 child boxes, then the inner
// children still entered pushed far-first, each keyed by its near
// distance.  Between the slab test and the pushes comes the leaf phase,
// in one of two ways chosen warp-wide at each step by its cost: either
// each lane tests its own leaves serially (coherent rays, where most lanes
// have a leaf), or the warp takes the lanes with leaf children in turn and
// tests the owner's children in child order, 32 triangles at a time, one
// a lane, against the owner's ray and t broadcast by shuffles (scattered
// rays).  The closest hit reduces each chunk with __reduce_min_sync on the
// bits of t (positive or +inf, so they order as unsigned ints) and takes
// the lowest lane at that t: the first of equal hits, as the plain
// version's min over a leaf and the serial loop give, since a later
// triangle at an equal t never passes t < best.  The any hit ends the
// owner's ray at the first chunk with a hit (__any_sync).  Triangles are
// rows padded to 48 bytes, three 16-byte loads each; a leaf's rows are
// contiguous (leaf order), so a chunk's loads coalesce.  The grid is
// persistent (blocks per SM from the occupancy calculator); a lane whose
// ray is done takes the next one from an atomic counter (one atomicAdd a
// warp for all its idle lanes), so the warp no longer waits for its
// longest ray.  Every lane stays in the loop until the rays run out:
// exited lanes would break the full-mask shuffles.  Each block first
// copies the records [0, R) into shared memory with cp.async, each
// record's 16-byte words swizzled by its index so that lanes reading
// different records hit different banks.  Records are in breadth-first
// order, so [0, R) is the top of the tree and every child id exceeds its
// parent's; records >= R are read from global memory.  R is a launch
// argument, from the block's shared-memory budget.  A push past the stack
// sets *overflow and is dropped; the wrapper reads the flag.  The
// Moeller-Trumbore test is K1's (mt_test.cuh); built with --fmad=false,
// with NaN-propagating min/max as torch.minimum/maximum, the kernels round
// as the plain versions do.  Ray order is left to the wrapper (Morton sort
// or none).
//
// K4 (bvh4_closest_mp_warp_kernel): K2's function and K2's walk, with the
// reference's batched pop.  K4 exists on the TPU to shorten the chain of
// dependent scalar steps a pop costs (stack read, node fetch, slab,
// push): a lane pops up to P entries (a template parameter, 2 or 4) and
// fetches the records of those not stale before it visits any of them.
// Here the batch sits on K2's machinery: the persistent grid whose lanes
// refill, the shared-memory top, the 48-byte rows, and K2's leaf phase,
// run once for each batch position b, warp-wide, with the lanes whose
// entry b is still live.  Each record is loaded and slab-tested at its
// entry's turn, the global ones prefetched into L1 at the batch's start,
// so one slab result is held: at 1,024 threads a thread has 64
// registers, and holding all P (the reference's order, kept for the
// 128-thread first design step) spilled 0.7-1.4 KB and ran 4.6-7.7 x
// slower (chip_smoke.py, PERF.md).  The loop over the batch positions is
// not unrolled, so K2's leaf phase is compiled once: unrolled P times it
// ran 1.3-3.3 x slower.
//
// The reference (bvh4_closest_mp_kernel): the former one-thread-a-ray
// walk of K2 and K4, each leaf tested serially by its lane, with the
// batched pop at P = 1, which is K2's former walk, kept to time K2 and K4
// against.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mt_test.cuh"

namespace {

constexpr int kBlock = 128;  // the one-thread-a-ray walk (the reference)
constexpr int kMaxStack = 64;
constexpr int kRecordBytes = 128;  // 32 floats, 8 float4
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoHit = 0xffffffffu;  // above the bits of any t

// Triangle layouts the warp kernels read: the (F, 9) rows [p0, e1, e2],
// or the same rows padded to 48 B, three 16-byte loads a triangle.
enum Layout { kRows = 0, kPad = 1 };

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// 1 / c with c clamped away from zero to +-1e-12 (pallas_traverse :177)
__device__ __forceinline__ float inv_dir(float c) {
  const float s = fabsf(c) > 1e-12f ? c : (c >= 0.f ? 1e-12f : -1e-12f);
  return 1.0f / s;
}

struct RayIn {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ RayIn load_ray(const float* __restrict__ o,
                                          const float* __restrict__ d,
                                          int i) {
  RayIn r;
  r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
  r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
  r.ix = inv_dir(r.dx); r.iy = inv_dir(r.dy); r.iz = inv_dir(r.dz);
  return r;
}

// One BVH4 record: child ids and counts, and the slab interval of the ray
// through each child box.
struct Node {
  int id[4], cnt[4];
  float near[4], far[4];
};

struct Rec {
  float4 q[8];
};

__device__ __forceinline__ Rec ldg_rec(const float4* __restrict__ p) {
  Rec x;
#pragma unroll
  for (int q = 0; q < 8; ++q) x.q[q] = __ldg(p + q);
  return x;
}

__device__ __forceinline__ Node slab(const Rec& x, const RayIn& r) {
  float b[24];
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const float4 v = x.q[2 + q];
    b[4 * q] = v.x; b[4 * q + 1] = v.y; b[4 * q + 2] = v.z;
    b[4 * q + 3] = v.w;
  }
  Node s;
  s.id[0] = static_cast<int>(x.q[0].x); s.id[1] = static_cast<int>(x.q[0].y);
  s.id[2] = static_cast<int>(x.q[0].z); s.id[3] = static_cast<int>(x.q[0].w);
  s.cnt[0] = static_cast<int>(x.q[1].x);
  s.cnt[1] = static_cast<int>(x.q[1].y);
  s.cnt[2] = static_cast<int>(x.q[1].z);
  s.cnt[3] = static_cast<int>(x.q[1].w);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float* bx = b + 6 * k;
    const float t0x = (bx[0] - r.ox) * r.ix, t1x = (bx[3] - r.ox) * r.ix;
    const float t0y = (bx[1] - r.oy) * r.iy, t1y = (bx[4] - r.oy) * r.iy;
    const float t0z = (bx[2] - r.oz) * r.iz, t1z = (bx[5] - r.oz) * r.iz;
    s.near[k] = max_nan(max_nan(min_nan(t0x, t1x), min_nan(t0y, t1y)),
                        min_nan(t0z, t1z));
    s.far[k] = min_nan(min_nan(max_nan(t0x, t1x), max_nan(t0y, t1y)),
                       max_nan(t0z, t1z));
  }
  return s;
}

__device__ __forceinline__ Node load_node(const float4* __restrict__ nodes,
                                          int node, const RayIn& r) {
  return slab(ldg_rec(nodes + static_cast<size_t>(node) * 8), r);
}

// Lane-utilisation counters of the counting instantiations: steps of a
// loop taken by a warp, and the lanes active in them.
struct LaneCount {
  unsigned long long trav_steps, trav_active, leaf_steps, leaf_active;
};

__device__ __forceinline__ void flush_counts(const LaneCount& c,
                                             unsigned long long* counts) {
  if (c.trav_steps) atomicAdd(counts + 0, c.trav_steps);
  if (c.trav_active) atomicAdd(counts + 1, c.trav_active);
  if (c.leaf_steps) atomicAdd(counts + 2, c.leaf_steps);
  if (c.leaf_active) atomicAdd(counts + 3, c.leaf_active);
}

// one-thread-a-ray counting: the lowest lane of those executing together
// counts a step and their number
__device__ __forceinline__ void count_converged(unsigned long long& steps,
                                                unsigned long long& active) {
  const unsigned m = __activemask();
  if ((threadIdx.x & 31) == __ffs(m) - 1) {
    steps += 1;
    active += __popc(m);
  }
}

// The inner children of a visited node still entered at the ray's current
// t, pushed far-first at stack[base..], each keyed by its near distance.
// Returns the number pushed; a push past stack_cap sets *overflow and
// pushes nothing.
__device__ __forceinline__ int push_inner(const Node& s, const bool* enter,
                                          float best_t, int* stack_node,
                                          float* stack_key, int base,
                                          int stack_cap, int* overflow) {
  bool push[4];
  int npush = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    push[k] = enter[k] && s.cnt[k] == 0 && s.near[k] < best_t;
    npush += push[k];
  }
  if (npush == 0) return 0;
  if (base + npush > stack_cap) {
    atomicOr(overflow, 1);
    return 0;
  }
  // far-first: the child of rank 0 (largest near) goes deepest
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!push[k]) continue;
    int rank = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      rank += push[j] && (s.near[j] > s.near[k] ||
                          (s.near[j] == s.near[k] && j < k));
    stack_node[base + rank] = s.id[k];
    stack_key[base + rank] = s.near[k];
  }
  return npush;
}

__device__ __forceinline__ void child_entered(const Node& s, bool* enter) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    enter[k] = (s.near[k] <= s.far[k]) & (s.far[k] > 1e-6f);
}

// The one-thread-a-ray work at one popped node (K4, reference): the leaf
// children tested in child order, triangle after triangle, against the
// current best hit, then the inner children pushed.
template <bool kCount>
__device__ __forceinline__ int visit(const Node& s, const RayIn& r,
                                     const float* __restrict__ tri,
                                     float& best_t, int& best, float& best_u,
                                     float& best_v, int* stack_node,
                                     float* stack_key, int base,
                                     int stack_cap, int* overflow,
                                     LaneCount& c) {
  bool enter[4];
  child_entered(s, enter);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!(enter[k] && s.cnt[k] > 0 && s.near[k] < best_t)) continue;
    const float* tr = tri + static_cast<size_t>(s.id[k]) * 9;
    for (int j = 0; j < s.cnt[k]; ++j) {
      if (kCount) count_converged(c.leaf_steps, c.leaf_active);
      const HitTest h =
          mt_test(tr + 9 * j, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, best_t);
      if (h.hit) {
        best_t = h.t;
        best = s.id[k] + j;
        best_u = h.u;
        best_v = h.v;
      }
    }
  }
  return push_inner(s, enter, best_t, stack_node, stack_key, base,
                    stack_cap, overflow);
}

__device__ __forceinline__ void store_hit(int i, float best_t, int best,
                                          float best_u, float best_v,
                                          float* __restrict__ t_out,
                                          float* __restrict__ u_out,
                                          float* __restrict__ v_out,
                                          int* __restrict__ slot_out) {
  const bool valid = best >= 0;
  t_out[i] = valid ? best_t : __int_as_float(0x7f800000);  // +inf
  u_out[i] = best_u;
  v_out[i] = best_v;
  slot_out[i] = best;
}

// The one-thread-a-ray walk popping up to P entries an iteration (the
// former K4, at P = 2 and 4, before K4 moved onto K2's walk).  The batch's
// entries are read first, because the pushes recycle the popped region
// from sp0; the records of the entries not already stale are then loaded
// and slab-tested together, so their loads are in flight at once; then
// each entry is visited in batch order (the stale-entry cull against the
// current t included), its pushes appended at sp0 + pos.  The entries are
// the stack's top first, so P = 1 is K2's former walk, the reference,
// the one instantiation kept.
template <int P, bool kCount>
__global__ void __launch_bounds__(kBlock)
bvh4_closest_mp_kernel(const float4* __restrict__ nodes,
                       const float* __restrict__ tri,
                       const float* __restrict__ o,
                       const float* __restrict__ d,
                       const float* __restrict__ maxt, int n_rays,
                       int stack_cap, float* __restrict__ t_out,
                       float* __restrict__ u_out, float* __restrict__ v_out,
                       int* __restrict__ slot_out, int* overflow,
                       unsigned long long* counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  LaneCount c = {0, 0, 0, 0};
  const RayIn r = load_ray(o, d, i);
  float best_t = maxt[i];
  int best = -1;
  float best_u = 0.f, best_v = 0.f;
  int stack_node[kMaxStack];
  float stack_key[kMaxStack];
  stack_node[0] = 0;
  stack_key[0] = 0.f;
  int sp = 1;
  while (sp > 0) {
    if (kCount) count_converged(c.trav_steps, c.trav_active);
    const int npop = sp < P ? sp : P;
    const int sp0 = sp - npop;
    int bnode[P];
    float bkey[P];
#pragma unroll
    for (int b = 0; b < P; ++b) {
      const int at = b < npop ? sp - 1 - b : 0;
      bnode[b] = stack_node[at];
      bkey[b] = b < npop ? stack_key[at] : __int_as_float(0x7f800000);
    }
    // t only shrinks: an entry stale now is stale at its turn too
    Node s[P];
#pragma unroll
    for (int b = 0; b < P; ++b)
      if (bkey[b] < best_t) s[b] = load_node(nodes, bnode[b], r);
    int pos = 0;
#pragma unroll
    for (int b = 0; b < P; ++b) {
      if (!(bkey[b] < best_t)) continue;  // stale: t shrank since
      pos += visit<kCount>(s[b], r, tri, best_t, best, best_u, best_v,
                           stack_node, stack_key, sp0 + pos, stack_cap,
                           overflow, c);
    }
    sp = sp0 + pos;
  }
  store_hit(i, best_t, best, best_u, best_v, t_out, u_out, v_out, slot_out);
  if (kCount) flush_counts(c, counts);
}

// -- the warp-cooperative kernels (K2, K3) ----------------------------------

struct Trace {
  const float4* nodes;   // (n4, 32) records
  int n_shared;          // records [0, n_shared) copied to shared memory
  const float* tri;      // triangles in the kernel's layout
  const float* o;
  const float* d;
  const float* maxt;
  int n_rays;
  int stack_cap;
  unsigned* next_ray;    // atomic ray counter (persistent grid), or null
  int serial_x8;         // leaf-phase switch, in eighths (serial_leaves)
  int* overflow;
  unsigned long long* counts;  // lane utilisation (counting builds only)
};

struct Hits {
  float* t;
  float* u;
  float* v;
  int* slot;
  uint8_t* occ;
};

template <int L>
__device__ __forceinline__ HitTest test_row(const float* __restrict__ tri,
                                            int j, const RayIn& r,
                                            float tmax) {
  float w[9];
  if (L == kRows) {
    const float* p = tri + static_cast<size_t>(j) * 9;
#pragma unroll
    for (int c = 0; c < 9; ++c) w[c] = __ldg(p + c);
  } else {
    const float4* p =
        reinterpret_cast<const float4*>(tri) + static_cast<size_t>(j) * 3;
    const float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w; w[4] = b.x;
    w[5] = b.y; w[6] = b.z; w[7] = b.w; w[8] = c.x;
  }
  return mt_test_values(w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8],
                        r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, tmax);
}

// Shared memory holds record i's 16-byte word q at i * 8 + (q ^ (i & 7)):
// lanes reading word q of records that differ in i & 7 hit different banks.
__device__ __forceinline__ int swizzled(int i, int q) {
  return i * 8 + (q ^ (i & 7));
}

// Copy the records [0, n_shared) into shared memory once a block, 16
// bytes a thread at a time with cp.async.
__device__ __forceinline__ void copy_top(const Trace& a, float4* top) {
  if (a.n_shared <= 0) return;  // block-uniform
  const int words = a.n_shared * 8;
  for (int q = threadIdx.x; q < words; q += blockDim.x) {
    const uint32_t dst = static_cast<uint32_t>(
        __cvta_generic_to_shared(top + swizzled(q >> 3, q & 7)));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                 "l"(a.nodes + q)
                 : "memory");
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ Rec fetch(const Trace& a, const float4* top,
                                     int node) {
  Rec x;
  if (node < a.n_shared) {
#pragma unroll
    for (int q = 0; q < 8; ++q) x.q[q] = top[swizzled(node, q)];
  } else {
    x = ldg_rec(a.nodes + static_cast<size_t>(node) * 8);
  }
  return x;
}

// The lanes without a ray take the next ones.  On a persistent grid one
// atomicAdd a warp hands out as many rays as it has idle lanes, in lane
// order, until the rays run out (``more`` turns false, warp-uniform);
// without a counter each warp takes its own 32 rays once.  Returns the
// lane's new ray, or -1.
__device__ __forceinline__ int take_ray(const Trace& a, bool idle,
                                        bool& more, int warp) {
  const int lane = threadIdx.x & 31;
  if (a.next_ray == nullptr) {
    more = false;
    const int i = warp * 32 + lane;
    return idle && i < a.n_rays ? i : -1;
  }
  const unsigned want = __ballot_sync(kFull, idle);
  if (want == 0) return -1;
  const int leader = __ffs(want) - 1;
  unsigned base = 0;
  if (lane == leader) base = atomicAdd(a.next_ray, __popc(want));
  base = __shfl_sync(kFull, base, leader);
  if (base + __popc(want) >= static_cast<unsigned>(a.n_rays)) more = false;
  const unsigned i = base + __popc(want & ((1u << lane) - 1));
  return idle && i < static_cast<unsigned>(a.n_rays) ? static_cast<int>(i)
                                                     : -1;
}

// Whether the warp tests its leaves lane by lane this step: when the
// longest lane's triangles are at most serial_x8 / 8 times the chunks of
// 32 the warp would test together.  Coherent rays (many lanes, each with
// a leaf of its own) go serially, scattered ones cooperatively; both give
// the same hits.
__device__ __forceinline__ bool serial_leaves(const Trace& a, unsigned leaf,
                                              const Node& s, int& longest) {
  int work = 0, chunks = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if ((leaf >> k) & 1u) {
      work += s.cnt[k];
      chunks += (s.cnt[k] + 31) >> 5;
    }
  }
  longest = __reduce_max_sync(kFull, work);
  const int total = __reduce_add_sync(kFull, chunks);
  return longest * 8 <= total * a.serial_x8;
}

// K2's leaf phase: each lane's entered leaf children (bits of ``leaf``),
// children in child order, a child tested when its near distance is below
// the ray's t as it stands and a triangle hit below it.  Either each lane
// tests its own triangles one after another, or the warp takes the lanes
// one by one and tests 32 of the owner's triangles at a time, one a lane.
template <int L, bool kCount>
__device__ __forceinline__ void closest_leaves(
    const Trace& a, unsigned leaf, const Node& s, const RayIn& r,
    float& best_t, int& best, float& best_u, float& best_v, LaneCount& c) {
  const int lane = threadIdx.x & 31;
  int longest;
  const bool serial = serial_leaves(a, leaf, s, longest);
  if (longest == 0) return;  // warp-uniform: no leaf this step
  if (serial) {
    int tests = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!((leaf >> k) & 1u) || !(s.near[k] < best_t)) continue;
      for (int j = 0; j < s.cnt[k]; ++j) {
        const HitTest h = test_row<L>(a.tri, s.id[k] + j, r, best_t);
        if (h.hit) {
          best_t = h.t;
          best = s.id[k] + j;
          best_u = h.u;
          best_v = h.v;
        }
      }
      tests += s.cnt[k];
    }
    if (kCount) {
      c.leaf_steps += __reduce_max_sync(kFull, tests);
      c.leaf_active += __reduce_add_sync(kFull, tests);
    }
    return;
  }
  unsigned todo = __ballot_sync(kFull, leaf != 0);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    RayIn w;
    w.ox = __shfl_sync(kFull, r.ox, src);
    w.oy = __shfl_sync(kFull, r.oy, src);
    w.oz = __shfl_sync(kFull, r.oz, src);
    w.dx = __shfl_sync(kFull, r.dx, src);
    w.dy = __shfl_sync(kFull, r.dy, src);
    w.dz = __shfl_sync(kFull, r.dz, src);
    float bt = __shfl_sync(kFull, best_t, src);
    const unsigned bits = __shfl_sync(kFull, leaf, src);
    int slot = -1;
    float hu = 0.f, hv = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!((bits >> k) & 1u)) continue;
      const float near = __shfl_sync(kFull, s.near[k], src);
      if (!(near < bt)) continue;
      const int start = __shfl_sync(kFull, s.id[k], src);
      const int cnt = __shfl_sync(kFull, s.cnt[k], src);
      for (int c0 = 0; c0 < cnt; c0 += 32) {
        const int j = c0 + lane;
        unsigned key = kNoHit;
        float tu = 0.f, tv = 0.f;
        if (j < cnt) {
          const HitTest h = test_row<L>(a.tri, start + j, w, bt);
          if (h.hit) {
            key = __float_as_uint(h.t);
            tu = h.u;
            tv = h.v;
          }
        }
        if (kCount) {
          c.leaf_steps += 1;
          c.leaf_active += cnt - c0 < 32 ? cnt - c0 : 32;
        }
        const unsigned m = __reduce_min_sync(kFull, key);
        if (m != kNoHit) {
          const int at = __ffs(__ballot_sync(kFull, key == m)) - 1;
          hu = __shfl_sync(kFull, tu, at);
          hv = __shfl_sync(kFull, tv, at);
          bt = __uint_as_float(m);
          slot = start + c0 + at;
        }
      }
    }
    if (lane == src && slot >= 0) {
      best_t = bt;
      best = slot;
      best_u = hu;
      best_v = hv;
    }
  }
}

template <int L, int T, bool kCount>
__global__ void __launch_bounds__(T)
bvh4_closest_kernel(const Trace a, const Hits h) {
  extern __shared__ float4 top[];
  copy_top(a, top);
  const int warp = blockIdx.x * (T / 32) + threadIdx.x / 32;
  LaneCount c = {0, 0, 0, 0};
  int stack_node[kMaxStack];
  float stack_key[kMaxStack];
  RayIn r = {};
  float best_t = 0.f, best_u = 0.f, best_v = 0.f;
  int best = -1, ray = -1, sp = 0;
  bool more = true;
  for (;;) {
    if (more) {
      const int i = take_ray(a, ray < 0, more, warp);
      if (i >= 0) {
        ray = i;
        r = load_ray(a.o, a.d, i);
        best_t = a.maxt[i];
        best = -1;
        best_u = best_v = 0.f;
        stack_node[0] = 0;
        stack_key[0] = 0.f;
        sp = 1;
      }
    }
    if (!__any_sync(kFull, ray >= 0)) break;
    bool have = false;
    while (sp > 0) {
      --sp;
      if (stack_key[sp] < best_t) {  // else stale: t shrank since
        have = true;
        break;
      }
    }
    Node s = {};
    bool enter[4] = {false, false, false, false};
    unsigned leaf = 0;
    if (have) {
      s = slab(fetch(a, top, stack_node[sp]), r);
      child_entered(s, enter);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        leaf |= static_cast<unsigned>(enter[k] && s.cnt[k] > 0) << k;
    }
    if (kCount) {
      c.trav_steps += 1;
      c.trav_active += __popc(__ballot_sync(kFull, have));
    }
    closest_leaves<L, kCount>(a, leaf, s, r, best_t, best, best_u, best_v,
                              c);
    if (have)
      sp += push_inner(s, enter, best_t, stack_node, stack_key, sp,
                       a.stack_cap, a.overflow);
    if (ray >= 0 && sp == 0) {
      store_hit(ray, best_t, best, best_u, best_v, h.t, h.u, h.v, h.slot);
      ray = -1;
    }
  }
  if (kCount && (threadIdx.x & 31) == 0) flush_counts(c, a.counts);
}

// How K4 fetches a batch's node records: every live one loaded, then all
// slab-tested, before the batch's first visit (the loads in flight
// together, P slab results held through the batch), or each loaded and
// slab-tested at its turn, the global ones prefetched into L1 at the
// batch's start (one slab result held).
enum Fetch { kAhead = 0, kTurn = 1 };

__device__ __forceinline__ unsigned enter_mask(const Node& s) {
  bool enter[4];
  child_entered(s, enter);
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) m |= static_cast<unsigned>(enter[k]) << k;
  return m;
}

__device__ __forceinline__ void prefetch_rec(const float4* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// Entry b of a batch held in registers, b known only at run time: the
// visit loop is not unrolled, so that K2's leaf phase is compiled once
// and not P times.
template <int P, typename V>
__device__ __forceinline__ V pick(const V (&x)[P], int b) {
  V v = x[0];
#pragma unroll
  for (int k = 1; k < P; ++k)
    if (b == k) v = x[k];
  return v;
}

// K4 (_traverse_kernel_mp) on K2's walk.  Each lane pops a batch of up to
// P entries, top first, and reads all of them before any push recycles
// their region from sp0; a batch stale throughout is dropped in the lane
// (it would push nothing), as K2 drops a stale entry.  The records of the
// entries not stale are fetched (ahead or at their turn, ``F``); then the
// warp visits batch positions b = 0..P-1 in turn: a lane whose entry b is
// still below its ray's t (the stale cull against t as it stands, after
// the leaves of entries 0..b-1) passes its leaf children to K2's leaf
// phase and pushes its inner children far-first at sp0 + pos.
template <int L, int T, int P, int F, bool kCount>
__global__ void __launch_bounds__(T)
bvh4_closest_mp_warp_kernel(const Trace a, const Hits h) {
  extern __shared__ float4 top[];
  copy_top(a, top);
  const int warp = blockIdx.x * (T / 32) + threadIdx.x / 32;
  const float inf = __int_as_float(0x7f800000);
  LaneCount c = {0, 0, 0, 0};
  int stack_node[kMaxStack];
  float stack_key[kMaxStack];
  RayIn r = {};
  float best_t = 0.f, best_u = 0.f, best_v = 0.f;
  int best = -1, ray = -1, sp = 0;
  bool more = true;
  for (;;) {
    if (more) {
      const int i = take_ray(a, ray < 0, more, warp);
      if (i >= 0) {
        ray = i;
        r = load_ray(a.o, a.d, i);
        best_t = a.maxt[i];
        best = -1;
        best_u = best_v = 0.f;
        stack_node[0] = 0;
        stack_key[0] = 0.f;
        sp = 1;
      }
    }
    if (!__any_sync(kFull, ray >= 0)) break;
    int bnode[P];
    float bkey[P];
#pragma unroll
    for (int b = 0; b < P; ++b) {
      bnode[b] = 0;
      bkey[b] = inf;
    }
    int sp0 = 0;
    while (sp > 0) {
      const int npop = sp < P ? sp : P;
      sp0 = sp - npop;
      bool live = false;
#pragma unroll
      for (int b = 0; b < P; ++b) {
        const int at = b < npop ? sp - 1 - b : 0;
        bnode[b] = stack_node[at];
        bkey[b] = b < npop ? stack_key[at] : inf;
        live |= bkey[b] < best_t;
      }
      if (live) break;
      sp = sp0;  // stale throughout: t shrank since
    }
    // t only shrinks: an entry stale now is stale at its turn too
    Node s[P];
    unsigned em[P];
    if (F == kAhead) {
      Rec x[P];
#pragma unroll
      for (int b = 0; b < P; ++b)
        if (bkey[b] < best_t) x[b] = fetch(a, top, bnode[b]);
#pragma unroll
      for (int b = 0; b < P; ++b) {
        s[b] = Node{};
        em[b] = 0;
        if (bkey[b] < best_t) {
          s[b] = slab(x[b], r);
          em[b] = enter_mask(s[b]);
        }
      }
    } else {
#pragma unroll
      for (int b = 0; b < P; ++b)
        if (bkey[b] < best_t && bnode[b] >= a.n_shared)
          prefetch_rec(a.nodes + static_cast<size_t>(bnode[b]) * 8);
    }
    int pos = 0;
#pragma unroll 1
    for (int b = 0; b < P; ++b) {
      const bool live = pick(bkey, b) < best_t;  // the stale cull
      if (!__any_sync(kFull, live)) continue;  // warp-uniform
      Node sb = {};
      unsigned eb = 0;
      if (live) {
        if (F == kAhead) {
          sb = pick(s, b);
          eb = pick(em, b);
        } else {
          sb = slab(fetch(a, top, pick(bnode, b)), r);
          eb = enter_mask(sb);
        }
      }
      bool enter[4];
      unsigned leaf = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        enter[k] = (eb >> k) & 1u;
        leaf |= static_cast<unsigned>(enter[k] && sb.cnt[k] > 0) << k;
      }
      if (kCount) {
        c.trav_steps += 1;
        c.trav_active += __popc(__ballot_sync(kFull, live));
      }
      closest_leaves<L, kCount>(a, leaf, sb, r, best_t, best, best_u, best_v,
                                c);
      if (live)
        pos += push_inner(sb, enter, best_t, stack_node, stack_key, sp0 + pos,
                          a.stack_cap, a.overflow);
    }
    sp = sp0 + pos;
    if (ray >= 0 && sp == 0) {
      store_hit(ray, best_t, best, best_u, best_v, h.t, h.u, h.v, h.slot);
      ray = -1;
    }
  }
  if (kCount && (threadIdx.x & 31) == 0) flush_counts(c, a.counts);
}

// K3's leaf phase: true on the lanes whose ray hits a triangle of an
// entered leaf child; a ray stops testing at its first hit (serially) or
// at its first chunk with a hit (cooperatively).
template <int L>
__device__ __forceinline__ bool any_leaves(const Trace& a, unsigned leaf,
                                           const Node& s, const RayIn& r,
                                           float tmax) {
  const int lane = threadIdx.x & 31;
  int longest;
  const bool serial = serial_leaves(a, leaf, s, longest);
  if (longest == 0) return false;  // warp-uniform: no leaf this step
  bool mine = false;
  if (serial) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (mine || !((leaf >> k) & 1u)) continue;
      for (int j = 0; j < s.cnt[k] && !mine; ++j)
        mine = test_row<L>(a.tri, s.id[k] + j, r, tmax).hit;
    }
    return mine;
  }
  unsigned todo = __ballot_sync(kFull, leaf != 0);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    RayIn w;
    w.ox = __shfl_sync(kFull, r.ox, src);
    w.oy = __shfl_sync(kFull, r.oy, src);
    w.oz = __shfl_sync(kFull, r.oz, src);
    w.dx = __shfl_sync(kFull, r.dx, src);
    w.dy = __shfl_sync(kFull, r.dy, src);
    w.dz = __shfl_sync(kFull, r.dz, src);
    const float tm = __shfl_sync(kFull, tmax, src);
    const unsigned bits = __shfl_sync(kFull, leaf, src);
    bool hit = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (hit || !((bits >> k) & 1u)) continue;
      const int start = __shfl_sync(kFull, s.id[k], src);
      const int cnt = __shfl_sync(kFull, s.cnt[k], src);
      for (int c0 = 0; c0 < cnt && !hit; c0 += 32) {
        const int j = c0 + lane;
        const bool mine_hit =
            j < cnt && test_row<L>(a.tri, start + j, w, tm).hit;
        hit = __any_sync(kFull, mine_hit);
      }
    }
    if (lane == src) mine = hit;
  }
  return mine;
}

template <int L, int T>
__global__ void __launch_bounds__(T)
bvh4_any_kernel(const Trace a, const Hits h) {
  extern __shared__ float4 top[];
  copy_top(a, top);
  const int warp = blockIdx.x * (T / 32) + threadIdx.x / 32;
  int stack[kMaxStack];
  RayIn r = {};
  float tmax = 0.f;
  int ray = -1, sp = 0;
  bool occluded = false, more = true;
  for (;;) {
    if (more) {
      const int i = take_ray(a, ray < 0, more, warp);
      if (i >= 0) {
        ray = i;
        r = load_ray(a.o, a.d, i);
        tmax = a.maxt[i];
        occluded = false;
        stack[0] = 0;
        sp = tmax > 1e-6f ? 1 : 0;  // a ray of no extent cannot hit
      }
    }
    if (!__any_sync(kFull, ray >= 0)) break;
    const bool have = sp > 0;
    Node s = {};
    bool enter[4] = {false, false, false, false};
    unsigned leaf = 0;
    if (have) {
      s = slab(fetch(a, top, stack[--sp]), r);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        enter[k] = (s.near[k] <= s.far[k]) & (s.far[k] > 1e-6f) &
                   (s.near[k] < tmax);
        leaf |= static_cast<unsigned>(enter[k] && s.cnt[k] > 0) << k;
      }
    }
    if (any_leaves<L>(a, leaf, s, r, tmax)) {
      occluded = true;
      sp = 0;
    } else if (have) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!(enter[k] && s.cnt[k] == 0)) continue;
        if (sp < a.stack_cap) {
          stack[sp++] = s.id[k];
        } else {
          atomicOr(a.overflow, 1);
        }
      }
    }
    if (ray >= 0 && sp == 0) {
      h.occ[ray] = occluded ? 1 : 0;
      ray = -1;
    }
  }
}

// Launch ``kern`` with T threads a block and n_shared records of dynamic
// shared memory, on a persistent grid (the blocks that fit on the card at
// once, at most one a batch of T rays) or on one block per T rays.
template <typename Kernel>
int launch(Kernel kern, int threads, const Trace& a, const Hits& h,
           int persistent, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(a.n_shared) * kRecordBytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int need = (a.n_rays + threads - 1) / threads;
  int grid = need;
  if (persistent) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid = per_sm * sms < need ? per_sm * sms : need;
  }
  kern<<<grid, threads, smem, stream>>>(a, h);
  return static_cast<int>(cudaGetLastError());
}

// The instantiations: (layout, threads) pairs.
#define EPSM_BVH_CONFIGS(X) \
  X(kRows, 128)             \
  X(kPad, 128)              \
  X(kPad, 1024)

int launch_closest(const Trace& a, const Hits& h, int layout, int threads,
                   int persistent, cudaStream_t stream) {
  const bool count = a.counts != nullptr;
#define EPSM_CASE(L, T)                                                     \
  if (layout == L && threads == T)                                          \
    return count ? launch(bvh4_closest_kernel<L, T, true>, T, a, h,         \
                          persistent, stream)                               \
                 : launch(bvh4_closest_kernel<L, T, false>, T, a, h,        \
                          persistent, stream);
  EPSM_BVH_CONFIGS(EPSM_CASE)
#undef EPSM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_any(const Trace& a, const Hits& h, int layout, int threads,
               int persistent, cudaStream_t stream) {
#define EPSM_CASE(L, T)                                                   \
  if (layout == L && threads == T)                                        \
    return launch(bvh4_any_kernel<L, T>, T, a, h, persistent, stream);
  EPSM_BVH_CONFIGS(EPSM_CASE)
#undef EPSM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4's instantiations: (layout, threads, fetch) triples, each at P = 2, 4.
#define EPSM_K4_CONFIGS(X) \
  X(kRows, 128, kAhead)    \
  X(kPad, 1024, kTurn)

template <int P>
int launch_closest_mp(const Trace& a, const Hits& h, int layout, int threads,
                      int fetch, int persistent, cudaStream_t stream) {
  const bool count = a.counts != nullptr;
#define EPSM_CASE(L, T, F)                                                  \
  if (layout == L && threads == T && fetch == F)                            \
    return count ? launch(bvh4_closest_mp_warp_kernel<L, T, P, F, true>, T, \
                          a, h, persistent, stream)                         \
                 : launch(bvh4_closest_mp_warp_kernel<L, T, P, F, false>,   \
                          T, a, h, persistent, stream);
  EPSM_K4_CONFIGS(EPSM_CASE)
#undef EPSM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename Kernel>
int static_shared(Kernel kern, int* bytes) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kern);
  if (e == cudaSuccess && static_cast<int>(attr.sharedSizeBytes) > *bytes)
    *bytes = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(e);
}

inline int blocks_for(int n) { return (n + kBlock - 1) / kBlock; }

Trace make_trace(const float* nodes, int n_shared, const float* tri,
                 const float* o, const float* d, const float* maxt,
                 int n_rays, int stack_cap, unsigned* next_ray,
                 int serial_x8, int* overflow, unsigned long long* counts) {
  Trace a;
  a.nodes = reinterpret_cast<const float4*>(nodes);
  a.n_shared = n_shared;
  a.tri = tri;
  a.o = o;
  a.d = d;
  a.maxt = maxt;
  a.n_rays = n_rays;
  a.stack_cap = stack_cap;
  a.next_ray = next_ray;
  a.serial_x8 = serial_x8;
  a.overflow = overflow;
  a.counts = counts;
  return a;
}

// A persistent grid needs the ray counter; shared records need 16-byte
// aligned nodes.
bool bad_trace(int stack_cap, int n_shared, const float* nodes,
               int persistent, const unsigned* next_ray) {
  return stack_cap < 1 || stack_cap > kMaxStack || n_shared < 0 ||
         (n_shared > 0 && reinterpret_cast<uintptr_t>(nodes) % 16 != 0) ||
         (persistent != 0) != (next_ray != nullptr);
}

}  // namespace

extern "C" {

// Closest hit through the BVH4 (K2).  nodes (n4, 32) records of pack_bvh4;
// the first n_shared of them are copied to shared memory (n_shared * 128
// bytes within bvh4_shared_budget; the nodes 16-byte aligned); tri the
// triangles in leaf order in ``layout`` (0: (F, 9) rows [p0, e1, e2], 1:
// (F, 12) rows padded to 48 B); o, d (n_rays, 3); maxt (n_rays,); all
// float32, contiguous, on the current device; stack_cap <= 64.
// ``layout`` and ``threads`` a block must be one of the compiled
// configurations.  A ``persistent`` grid holds the blocks resident at once
// and its lanes take rays from next_ray (a zeroed uint32); otherwise
// next_ray is null and each warp takes 32 rays.  A step's leaves are
// tested lane by lane when the longest lane's triangles are at most
// serial_x8 / 8 times the warp's chunks of 32, else warp-wide.  Writes t
// (+inf on a miss), u, v (0 on a miss) and slot (the row of tri, -1 on a
// miss); sets *overflow to 1 if a ray ran out of stack.  With ``counts``
// (4 zeroed uint64), counts the lane utilisation: traversal steps, their
// active lanes, leaf steps, their active lanes.  Returns the launch's
// CUDA error.
int bvh4_closest_hit(const float* nodes, int n_shared, const float* tri,
                     int layout, const float* o, const float* d,
                     const float* maxt, int n_rays, int stack_cap,
                     int threads, int persistent, unsigned* next_ray,
                     int serial_x8, float* t_out, float* u_out, float* v_out,
                     int* slot_out, int* overflow, unsigned long long* counts,
                     cudaStream_t stream) {
  if (bad_trace(stack_cap, n_shared, nodes, persistent, next_ray))
    return static_cast<int>(cudaErrorInvalidValue);
  const Trace a = make_trace(nodes, n_shared, tri, o, d, maxt, n_rays,
                             stack_cap, next_ray, serial_x8, overflow,
                             counts);
  Hits h = {t_out, u_out, v_out, slot_out, nullptr};
  return launch_closest(a, h, layout, threads, persistent, stream);
}

// Any hit (K3): occ[i] = 1 where some triangle passes the closest hit's
// test; the other arguments as bvh4_closest_hit's.
int bvh4_any_hit(const float* nodes, int n_shared, const float* tri,
                 int layout, const float* o, const float* d,
                 const float* maxt, int n_rays, int stack_cap, int threads,
                 int persistent, unsigned* next_ray, int serial_x8,
                 uint8_t* occ_out, int* overflow, cudaStream_t stream) {
  if (bad_trace(stack_cap, n_shared, nodes, persistent, next_ray))
    return static_cast<int>(cudaErrorInvalidValue);
  const Trace a = make_trace(nodes, n_shared, tri, o, d, maxt, n_rays,
                             stack_cap, next_ray, serial_x8, overflow,
                             nullptr);
  Hits h = {nullptr, nullptr, nullptr, nullptr, occ_out};
  return launch_any(a, h, layout, threads, persistent, stream);
}

// The bytes of dynamic shared memory a block of K2 or K3 may take: the
// card's opt-in limit a block less the kernels' static shared memory.
int bvh4_shared_budget(int* bytes) {
  int dev = 0, optin = 0, fixed = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int err = 0;
#define EPSM_CASE(L, T)                                                     \
  err |= static_shared(bvh4_closest_kernel<L, T, false>, &fixed);           \
  err |= static_shared(bvh4_closest_kernel<L, T, true>, &fixed);            \
  err |= static_shared(bvh4_any_kernel<L, T>, &fixed);
  EPSM_BVH_CONFIGS(EPSM_CASE)
#undef EPSM_CASE
#define EPSM_CASE(L, T, F)                                                  \
  err |= static_shared(bvh4_closest_mp_warp_kernel<L, T, 2, F, false>,      \
                       &fixed);                                             \
  err |= static_shared(bvh4_closest_mp_warp_kernel<L, T, 2, F, true>,       \
                       &fixed);                                             \
  err |= static_shared(bvh4_closest_mp_warp_kernel<L, T, 4, F, false>,      \
                       &fixed);                                             \
  err |= static_shared(bvh4_closest_mp_warp_kernel<L, T, 4, F, true>, &fixed);
  EPSM_K4_CONFIGS(EPSM_CASE)
#undef EPSM_CASE
  if (err != 0) return static_cast<int>(cudaErrorInvalidValue);
  *bytes = optin - fixed;
  return 0;
}

// K4: the closest hit popping up to multi_pop (2 or 4) entries an
// iteration, on K2's warp-cooperative walk; ``fetch`` 0 loads and
// slab-tests a batch's live records before its first visit, 1 each at its
// turn; (layout, threads, fetch) one of the compiled configurations; the
// other arguments and the results as bvh4_closest_hit's.
int bvh4_closest_hit_mp(const float* nodes, int n_shared, const float* tri,
                        int layout, const float* o, const float* d,
                        const float* maxt, int n_rays, int stack_cap,
                        int threads, int persistent, unsigned* next_ray,
                        int serial_x8, int multi_pop, int fetch,
                        float* t_out, float* u_out, float* v_out,
                        int* slot_out, int* overflow,
                        unsigned long long* counts, cudaStream_t stream) {
  if (bad_trace(stack_cap, n_shared, nodes, persistent, next_ray))
    return static_cast<int>(cudaErrorInvalidValue);
  const Trace a = make_trace(nodes, n_shared, tri, o, d, maxt, n_rays,
                             stack_cap, next_ray, serial_x8, overflow,
                             counts);
  Hits h = {t_out, u_out, v_out, slot_out, nullptr};
  if (multi_pop == 2)
    return launch_closest_mp<2>(a, h, layout, threads, fetch, persistent,
                                stream);
  if (multi_pop == 4)
    return launch_closest_mp<4>(a, h, layout, threads, fetch, persistent,
                                stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The reference: K2's former one-thread-a-ray walk (the batched pop at P =
// 1); tri the (F, 9) rows; the results and ``counts`` as
// bvh4_closest_hit's.
int bvh4_closest_hit_ref(const float* nodes, const float* tri,
                         const float* o, const float* d, const float* maxt,
                         int n_rays, int stack_cap, float* t_out,
                         float* u_out, float* v_out, int* slot_out,
                         int* overflow, unsigned long long* counts,
                         cudaStream_t stream) {
  if (stack_cap < 1 || stack_cap > kMaxStack)
    return static_cast<int>(cudaErrorInvalidValue);
  const float4* n4 = reinterpret_cast<const float4*>(nodes);
  if (counts != nullptr) {
    bvh4_closest_mp_kernel<1, true>
        <<<blocks_for(n_rays), kBlock, 0, stream>>>(
            n4, tri, o, d, maxt, n_rays, stack_cap, t_out, u_out, v_out,
            slot_out, overflow, counts);
  } else {
    bvh4_closest_mp_kernel<1, false>
        <<<blocks_for(n_rays), kBlock, 0, stream>>>(
            n4, tri, o, d, maxt, n_rays, stack_cap, t_out, u_out, v_out,
            slot_out, overflow, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
