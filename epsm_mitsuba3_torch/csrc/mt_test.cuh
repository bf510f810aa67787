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
// and 1e-6 < t < tmax.  ``tr`` may point to shared or global memory.
__device__ __forceinline__ HitTest mt_test(const float* tr, float ox,
                                           float oy, float oz, float dx,
                                           float dy, float dz, float tmax) {
  const float p0x = tr[0], p0y = tr[1], p0z = tr[2];
  const float e1x = tr[3], e1y = tr[4], e1z = tr[5];
  const float e2x = tr[6], e2y = tr[7], e2z = tr[8];
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
