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
// rays) a ray reads 44 bytes of ray and hit, against a few thousand FP32
// operations of slab and Moeller-Trumbore tests, so the FP32 issue rate
// bounds it: the tree (1.4k records of 128 B, 182 KB) and the leaf-ordered
// triangles (2.3 MB) stay in the 50 MB L2.  In practice divergence bounds
// it first: the 32 rays of a warp walk different paths and the warp runs
// the union of them.
//
// Design: one thread per ray, each with its own stack of up to 64 entries
// in local memory (the TPU's shared packet stack and sub-block culling
// exist because TPU lanes cannot index memory one by one; they do not
// carry over).  A node record is read as eight 16-byte loads through the
// read-only path.  The four child boxes are slab-tested at the pop; leaf
// children are tested there, up to `count` triangles from `start`; inner
// children still entered are pushed far-first, each keyed by its near
// distance, and a popped entry whose key is not below the ray's current t
// is skipped (the stale-entry cull of :222-225, per ray).  A push past the
// stack sets *overflow and is dropped; the wrapper reads the flag.  The
// any-hit entry stops a ray at its first hit.  The Moeller-Trumbore test
// is K1's (mt_test.cuh); built with --fmad=false, with NaN-propagating
// min/max as torch.minimum/maximum, the kernels round as the plain
// versions do.  Ray order is left to the wrapper (Morton sort or none).
//
// K4 exists on the TPU to shorten the chain of dependent scalar steps a
// pop costs (stack read, node fetch, slab, push).  A thread here has the
// same chain, so K4 loads the records of up to P popped entries before
// visiting any of them, with P a template parameter (2 and 4).
#include <cuda_runtime.h>
#include <stdint.h>

#include "mt_test.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kMaxStack = 64;

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

__device__ __forceinline__ Node load_node(const float4* __restrict__ nodes,
                                          int node, const RayIn& r) {
  const float4* rec = nodes + static_cast<size_t>(node) * 8;
  const float4 ids = __ldg(rec);
  const float4 cnts = __ldg(rec + 1);
  float b[24];
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const float4 x = __ldg(rec + 2 + q);
    b[4 * q] = x.x; b[4 * q + 1] = x.y; b[4 * q + 2] = x.z;
    b[4 * q + 3] = x.w;
  }
  Node s;
  s.id[0] = static_cast<int>(ids.x); s.id[1] = static_cast<int>(ids.y);
  s.id[2] = static_cast<int>(ids.z); s.id[3] = static_cast<int>(ids.w);
  s.cnt[0] = static_cast<int>(cnts.x); s.cnt[1] = static_cast<int>(cnts.y);
  s.cnt[2] = static_cast<int>(cnts.z); s.cnt[3] = static_cast<int>(cnts.w);
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

// K2's work at one popped node: the leaf children tested in child order
// against the current best hit, then the inner children still entered
// pushed far-first at stack[base..], each keyed by its near distance.
// Returns the number pushed; a push past stack_cap sets *overflow and
// pushes nothing.
__device__ __forceinline__ int visit(const Node& s, const RayIn& r,
                                     const float* __restrict__ tri,
                                     float& best_t, int& best, float& best_u,
                                     float& best_v, int* stack_node,
                                     float* stack_key, int base,
                                     int stack_cap, int* overflow) {
  bool enter[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    enter[k] = (s.near[k] <= s.far[k]) & (s.far[k] > 1e-6f);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!(enter[k] && s.cnt[k] > 0 && s.near[k] < best_t)) continue;
    const float* tr = tri + static_cast<size_t>(s.id[k]) * 9;
    for (int j = 0; j < s.cnt[k]; ++j) {
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

__global__ void __launch_bounds__(kBlock)
bvh4_closest_kernel(const float4* __restrict__ nodes,
                    const float* __restrict__ tri,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ maxt, int n_rays,
                    int stack_cap, float* __restrict__ t_out,
                    float* __restrict__ u_out, float* __restrict__ v_out,
                    int* __restrict__ slot_out, int* overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
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
    --sp;
    if (!(stack_key[sp] < best_t)) continue;  // stale: t shrank since
    const Node s = load_node(nodes, stack_node[sp], r);
    sp += visit(s, r, tri, best_t, best, best_u, best_v, stack_node,
                stack_key, sp, stack_cap, overflow);
  }
  store_hit(i, best_t, best, best_u, best_v, t_out, u_out, v_out, slot_out);
}

// K4: K2 popping up to P entries an iteration (_traverse_kernel_mp).  The
// batch's entries are read first, because the pushes recycle the popped
// region from sp0; the records of the entries not already stale are then
// loaded and slab-tested together, so their loads are in flight at once;
// then each entry is visited in batch order with K2's per-node work (the
// stale-entry cull against the current t included), its pushes appended
// at sp0 + pos.  The entries are the stack's top first, so P = 1 is K2.
template <int P>
__global__ void __launch_bounds__(kBlock)
bvh4_closest_mp_kernel(const float4* __restrict__ nodes,
                       const float* __restrict__ tri,
                       const float* __restrict__ o,
                       const float* __restrict__ d,
                       const float* __restrict__ maxt, int n_rays,
                       int stack_cap, float* __restrict__ t_out,
                       float* __restrict__ u_out, float* __restrict__ v_out,
                       int* __restrict__ slot_out, int* overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
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
      pos += visit(s[b], r, tri, best_t, best, best_u, best_v, stack_node,
                   stack_key, sp0 + pos, stack_cap, overflow);
    }
    sp = sp0 + pos;
  }
  store_hit(i, best_t, best, best_u, best_v, t_out, u_out, v_out, slot_out);
}

__global__ void __launch_bounds__(kBlock)
bvh4_any_kernel(const float4* __restrict__ nodes,
                const float* __restrict__ tri, const float* __restrict__ o,
                const float* __restrict__ d, const float* __restrict__ maxt,
                int n_rays, int stack_cap, uint8_t* __restrict__ occ_out,
                int* overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float tmax = maxt[i];
  bool occluded = false;
  if (tmax > 1e-6f) {  // a ray of no extent cannot hit
    const RayIn r = load_ray(o, d, i);
    int stack[kMaxStack];
    stack[0] = 0;
    int sp = 1;
    while (sp > 0 && !occluded) {
      const Node s = load_node(nodes, stack[--sp], r);
      bool enter[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        enter[k] = (s.near[k] <= s.far[k]) & (s.far[k] > 1e-6f) &
                   (s.near[k] < tmax);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (occluded || !(enter[k] && s.cnt[k] > 0)) continue;
        const float* tr = tri + static_cast<size_t>(s.id[k]) * 9;
        for (int j = 0; j < s.cnt[k]; ++j) {
          if (mt_test(tr + 9 * j, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, tmax)
                  .hit) {
            occluded = true;
            break;
          }
        }
      }
      if (occluded) break;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!(enter[k] && s.cnt[k] == 0)) continue;
        if (sp < stack_cap) {
          stack[sp++] = s.id[k];
        } else {
          atomicOr(overflow, 1);
        }
      }
    }
  }
  occ_out[i] = occluded ? 1 : 0;
}

inline int blocks_for(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

extern "C" {

// Closest hit through the BVH4 (K2).  nodes (n4, 32) records of pack_bvh4;
// tri (F, 9) rows [p0, e1, e2] in leaf order; o, d (n_rays, 3); maxt
// (n_rays,); all float32, contiguous, on the current device; stack_cap
// <= 64.  Writes t (+inf on a miss), u, v (0 on a miss) and slot (the
// row of tri, -1 on a miss); sets *overflow to 1 if a ray ran out of
// stack.  Returns cudaGetLastError() after the launch.
int bvh4_closest_hit(const float* nodes, const float* tri, const float* o,
                     const float* d, const float* maxt, int n_rays,
                     int stack_cap, float* t_out, float* u_out,
                     float* v_out, int* slot_out, int* overflow,
                     cudaStream_t stream) {
  if (stack_cap < 1 || stack_cap > kMaxStack)
    return static_cast<int>(cudaErrorInvalidValue);
  bvh4_closest_kernel<<<blocks_for(n_rays), kBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(nodes), tri, o, d, maxt, n_rays,
      stack_cap, t_out, u_out, v_out, slot_out, overflow);
  return static_cast<int>(cudaGetLastError());
}

// K4: the closest hit of K2, popping up to multi_pop (2 or 4) entries an
// iteration; the same arguments and results as bvh4_closest_hit.
int bvh4_closest_hit_mp(const float* nodes, const float* tri, const float* o,
                        const float* d, const float* maxt, int n_rays,
                        int stack_cap, int multi_pop, float* t_out,
                        float* u_out, float* v_out, int* slot_out,
                        int* overflow, cudaStream_t stream) {
  if (stack_cap < 1 || stack_cap > kMaxStack)
    return static_cast<int>(cudaErrorInvalidValue);
  const float4* n4 = reinterpret_cast<const float4*>(nodes);
  if (multi_pop == 2) {
    bvh4_closest_mp_kernel<2><<<blocks_for(n_rays), kBlock, 0, stream>>>(
        n4, tri, o, d, maxt, n_rays, stack_cap, t_out, u_out, v_out,
        slot_out, overflow);
  } else if (multi_pop == 4) {
    bvh4_closest_mp_kernel<4><<<blocks_for(n_rays), kBlock, 0, stream>>>(
        n4, tri, o, d, maxt, n_rays, stack_cap, t_out, u_out, v_out,
        slot_out, overflow);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Any hit: occ[i] = 1 where some triangle passes the closest hit's test.
int bvh4_any_hit(const float* nodes, const float* tri, const float* o,
                 const float* d, const float* maxt, int n_rays,
                 int stack_cap, uint8_t* occ_out, int* overflow,
                 cudaStream_t stream) {
  if (stack_cap < 1 || stack_cap > kMaxStack)
    return static_cast<int>(cudaErrorInvalidValue);
  bvh4_any_kernel<<<blocks_for(n_rays), kBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(nodes), tri, o, d, maxt, n_rays,
      stack_cap, occ_out, overflow);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
