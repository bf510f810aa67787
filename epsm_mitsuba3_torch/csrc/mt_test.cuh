// The Moeller-Trumbore ray-triangle test shared by kernels K1
// (mt_intersect.cu) and K2/K3 (bvh_traverse.cu).
//
// Triangles are rows of 9 floats [p0, e1 = p1 - p0, e2 = p2 - p0].  The
// arithmetic is that of the plain PyTorch version, ops/intersect.py
// _mt_edges, operation for operation; built with --fmad=false, the
// kernels round as the plain version does.
#pragma once

#include <cuda_runtime.h>

struct HitTest {
  float t, u, v;
  bool hit;
};

// A hit needs |det| > 1e-12, u >= -1e-6, v >= -1e-6, u + v <= 1 + 1e-6
// and 1e-6 < t < tmax.  The triangle is given as its 9 values, loaded by
// the caller in whatever layout it keeps them.
__device__ __forceinline__ HitTest mt_test_values(
    float p0x, float p0y, float p0z, float e1x, float e1y, float e1z,
    float e2x, float e2y, float e2z, float ox, float oy, float oz, float dx,
    float dy, float dz, float tmax) {
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool ok_det = fabsf(det) > 1e-12f;
  const float inv_det = ok_det ? 1.0f / det : 0.0f;
  const float tvx = ox - p0x, tvy = oy - p0y, tvz = oz - p0z;
  HitTest r;
  r.u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  r.v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
  r.t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  r.hit = (r.u >= -1e-6f) & (r.v >= -1e-6f) & (r.u + r.v <= 1.000001f) &
          ok_det & (r.t > 1e-6f) & (r.t < tmax);
  return r;
}

// The same test on a row of 9 floats; ``tr`` may point to shared or
// global memory.
__device__ __forceinline__ HitTest mt_test(const float* tr, float ox,
                                           float oy, float oz, float dx,
                                           float dy, float dz, float tmax) {
  return mt_test_values(tr[0], tr[1], tr[2], tr[3], tr[4], tr[5], tr[6],
                        tr[7], tr[8], ox, oy, oz, dx, dy, dz, tmax);
}
