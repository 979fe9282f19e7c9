// Moller-Trumbore of one ray against one packed 8-triangle group
// (objects.go:408-461), shared by stream.cu and traverse8.cu, and the
// addressing of the packed tables of scene/bvh8.py.
//
// The operation order is that of `mt_groups_ref` in ops/stream.py (and of the
// JAX kernels). Sources that include this header are compiled with
// -fmad=false, so no multiply-add is contracted and kernel and plain version
// agree bit for bit.
//
// Tie rules: inside a group the least t wins and, on equal t, the largest
// triangle id; the group's winner replaces the ray's best only when
// strictly smaller. A hit needs t > T_MIN, t < t_best (the best before the
// group), |det| >= 1e-12 and barycentrics inside the triangle.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define T_MIN 1e-3f
#define ENTRY_FLOATS 128  // 8 slots x 16 fields

// Float offset of slot 0, field 0 of entry m in a line-packed table: entry
// m, slot s, field f is at row (m >> 3) * 8 + s, column (m & 7) * 16 + f of
// a (rows, 128) array.
__device__ __forceinline__ size_t packed_offset(int m) {
  return ((size_t)(m >> 3) * 8) * 128 + (size_t)(m & 7) * 16;
}

// `tri` points at 8 slots of 16 floats, `stride` floats apart: fields 0-2
// v0, 3-5 e0, 6-8 e1, 9 triangle id (as a float; -1 for padding).
__device__ __forceinline__ void mt_group(const float* tri, int stride, float ox, float oy,
                                         float oz, float dx, float dy, float dz,
                                         float& t_best, int& idx) {
  float tmin = INFINITY;
  float imax = -1.0f;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const float4 a = *reinterpret_cast<const float4*>(tri + s * stride);
    const float4 b = *reinterpret_cast<const float4*>(tri + s * stride + 4);
    const float4 c = *reinterpret_cast<const float4*>(tri + s * stride + 8);
    const float v0x = a.x, v0y = a.y, v0z = a.z;
    const float e0x = a.w, e0y = b.x, e0z = b.y;
    const float e1x = b.z, e1y = b.w, e1z = c.x;
    const float tid = c.y;
    const float pvx = dy * e1z - dz * e1y;
    const float pvy = dz * e1x - dx * e1z;
    const float pvz = dx * e1y - dy * e1x;
    const float det = e0x * pvx + e0y * pvy + e0z * pvz;
    const float inv = 1.0f / (fabsf(det) < 1e-30f ? 1e-30f : det);
    const float tvx = ox - v0x;
    const float tvy = oy - v0y;
    const float tvz = oz - v0z;
    const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
    const float qvx = tvy * e0z - tvz * e0y;
    const float qvy = tvz * e0x - tvx * e0z;
    const float qvz = tvx * e0y - tvy * e0x;
    const float vv = (dx * qvx + dy * qvy + dz * qvz) * inv;
    const float tt = (e1x * qvx + e1y * qvy + e1z * qvz) * inv;
    const bool ok = fabsf(det) >= 1e-12f && uu >= 0.0f && uu <= 1.0f && vv >= 0.0f &&
                    uu + vv <= 1.0f && tt > T_MIN && tt < t_best;
    if (ok) {
      if (tt < tmin) {
        tmin = tt;
        imax = tid;
      } else if (tt == tmin) {
        imax = fmaxf(imax, tid);
      }
    }
  }
  if (tmin < t_best) {
    t_best = tmin;
    idx = (int)imax;
  }
}
