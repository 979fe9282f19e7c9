// Moller-Trumbore of one ray against one triangle and against one packed
// 8-triangle group (objects.go:408-461), cp.async helpers, the slab test, and
// the addressing of the packed tables of scene/bvh8.py. Shared by stream.cu
// and stream_round.cu (through stream_items.cuh), stream2.cu, traverse8.cu
// and traverse.cu.
//
// The operation order is that of `mt_groups_ref` in ops/stream.py (and of the
// JAX kernels). Sources that include this header are compiled with
// -fmad=false, so no multiply-add is contracted and kernel and plain version
// agree bit for bit.
//
// Tie rules of a group: inside a group the least t wins and, on equal t, the
// largest triangle id; the group's winner replaces the ray's best only when
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

// One triangle (v0, edges e0 and e1): true when the ray hits it inside
// (T_MIN, t_best); its t is left in tt either way.
__device__ __forceinline__ bool mt_hit(float v0x, float v0y, float v0z, float e0x, float e0y,
                                       float e0z, float e1x, float e1y, float e1z, float ox,
                                       float oy, float oz, float dx, float dy, float dz,
                                       float t_best, float& tt) {
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
  tt = (e1x * qvx + e1y * qvy + e1z * qvz) * inv;
  return fabsf(det) >= 1e-12f && uu >= 0.0f && uu <= 1.0f && vv >= 0.0f && uu + vv <= 1.0f &&
         tt > T_MIN && tt < t_best;
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
    float tt;
    if (mt_hit(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, ox, oy, oz, dx, dy, dz, t_best,
               tt)) {
      if (tt < tmin) {
        tmin = tt;
        imax = c.y;
      } else if (tt == tmin) {
        imax = fmaxf(imax, c.y);
      }
    }
  }
  if (tmin < t_best) {
    t_best = tmin;
    idx = (int)imax;
  }
}

// mt_group that also names the winner: when the group's least t replaces
// t_best it returns true and leaves in `slot` the slot of the largest
// triangle id at that t (the slot whose id mt_group would keep). The same
// operations in the same order as mt_group, so the same t.
__device__ __forceinline__ bool mt_group_slot(const float* tri, int stride, float ox, float oy,
                                              float oz, float dx, float dy, float dz,
                                              float& t_best, int& slot) {
  float tmin = INFINITY;
  float imax = -1.0f;
  int smax = 0;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const float4 a = *reinterpret_cast<const float4*>(tri + s * stride);
    const float4 b = *reinterpret_cast<const float4*>(tri + s * stride + 4);
    const float4 c = *reinterpret_cast<const float4*>(tri + s * stride + 8);
    float tt;
    if (mt_hit(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, ox, oy, oz, dx, dy, dz, t_best,
               tt)) {
      if (tt < tmin) {
        tmin = tt;
        imax = c.y;
        smax = s;
      } else if (tt == tmin && c.y > imax) {
        imax = c.y;
        smax = s;
      }
    }
  }
  if (tmin < t_best) {
    t_best = tmin;
    slot = smax;
    return true;
  }
  return false;
}

// Asynchronous 16-byte copies from device to shared memory (Ampere's
// cp.async, bypassing L1), committed in groups; wait_group<n> returns once
// at most n of this thread's groups are still in flight. A barrier (the
// block's or the warp's) must follow before other threads read the data.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 1 / v with |v| lifted to 1e-30 (sign kept), the slab tests' inverse
// direction.
__device__ __forceinline__ float safe_inv(float v) {
  const float tiny = 1e-30f;
  return 1.0f / (fabsf(v) < tiny ? (v < 0.0f ? -tiny : tiny) : v);
}

// Slab test of one box (aabb.go:90-113) in the operation order of the plain
// versions: near = max of the per-axis minima, far = min of the maxima.
__device__ __forceinline__ void slab(float lox, float loy, float loz, float hix, float hiy,
                                     float hiz, float ox, float oy, float oz, float ix,
                                     float iy, float iz, float& near, float& far) {
  const float tx0 = (lox - ox) * ix, tx1 = (hix - ox) * ix;
  const float ty0 = (loy - oy) * iy, ty1 = (hiy - oy) * iy;
  const float tz0 = (loz - oz) * iz, tz1 = (hiz - oz) * iz;
  near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
}

// Bits [lo_b, hi_b) of a 32-bit word, 0 <= lo_b, hi_b <= 32 (the all-ones
// form avoids a shift by 32), as ops/stream.range_bits.
__device__ __forceinline__ unsigned range_bits(int lo_b, int hi_b) {
  const unsigned hi_bits = hi_b >= 32 ? 0xffffffffu : (1u << hi_b) - 1u;
  const unsigned lo_bits = lo_b >= 32 ? 0xffffffffu : (1u << lo_b) - 1u;
  return hi_bits & ~lo_bits;
}
