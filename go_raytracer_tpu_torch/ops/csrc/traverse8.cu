// bvh8_closest: the BVH8 stack walk, for Hopper (sm_90a). Replaces the
// Pallas TPU kernel `bvh8_closest` (go_raytracer_tpu/ops/pallas/traverse8.py,
// `_traverse8_kernel`).
//
// One thread per ray, each with its own stack in local memory. A node visit
// slab-tests the eight child boxes against the ray's (T_MIN, t_best)
// interval (aabb.go:90-113) and pushes the hit children in slot order; a
// leaf visit runs Moller-Trumbore on its one or two 8-triangle groups
// (mt.cuh). Entries pop last-in first-out. Empty child slots are NaN boxes:
// the test below fails on any NaN, as the plain version's NaN-propagating
// min/max do. A ray whose cap is 0 fails every slab test at the root.
//
// What bounds it: the latency of dependent table reads. A visit reads 8 x
// 32 B of boxes or 8 x 40 B of triangles and does a few hundred float
// operations; the glue sorts rays by octant and Morton cell so the threads
// of a warp read the same entries. The tables (a few MB) sit in L2.

#include "mt.cuh"

#define BLOCK 128
#define STACK 96  // the wrapper refuses a tree that can go deeper

struct Traverse8Args {
  const float* nodes;  // packed or padded node table
  const float* tris;   // packed group table
  const float* o;      // (n, 3)
  const float* d;      // (n, 3)
  const float* t_cap;  // (n,)
  float* t_out;
  int* idx_out;
  int n, dense_nodes;
};

__global__ void __launch_bounds__(BLOCK) bvh8_closest_kernel(Traverse8Args a) {
  const int lane = blockIdx.x * BLOCK + threadIdx.x;
  if (lane >= a.n) return;
  const float ox = a.o[3 * lane], oy = a.o[3 * lane + 1], oz = a.o[3 * lane + 2];
  const float dx = a.d[3 * lane], dy = a.d[3 * lane + 1], dz = a.d[3 * lane + 2];
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  float t_best = a.t_cap[lane];
  int idx = -1;
  int stack[STACK];
  int sp = 1;
  stack[0] = 0;
  while (sp > 0) {
    const int m = stack[--sp];
    if (m >= 0) {
      const float* e = a.nodes + (a.dense_nodes ? packed_offset(m) : (size_t)m * 1024);
      const float4 p0 = __ldg(reinterpret_cast<const float4*>(e + 8));
      const float4 p1 = __ldg(reinterpret_cast<const float4*>(e + 12));
      const float push[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 lo = __ldg(reinterpret_cast<const float4*>(e + c * 128));
        const float4 hi = __ldg(reinterpret_cast<const float4*>(e + c * 128 + 4));
        // lo = (min x, min y, min z, max x), hi = (max y, max z, -, valid)
        const float tx0 = (lo.x - ox) * ix, tx1 = (lo.w - ox) * ix;
        const float ty0 = (lo.y - oy) * iy, ty1 = (hi.x - oy) * iy;
        const float tz0 = (lo.z - oz) * iz, tz1 = (hi.y - oz) * iz;
        const bool finite = tx0 == tx0 && tx1 == tx1 && ty0 == ty0 && ty1 == ty1 &&
                            tz0 == tz0 && tz1 == tz1;
        const float near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
        const float far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
        if (finite && fmaxf(near, T_MIN) < fminf(far, t_best)) stack[sp++] = (int)push[c];
      }
    } else {
      const int enc = -m - 1;
      const int g = enc >> 1;
      mt_group(a.tris + packed_offset(g), 128, ox, oy, oz, dx, dy, dz, t_best, idx);
      if (enc & 1)
        mt_group(a.tris + packed_offset(g + 1), 128, ox, oy, oz, dx, dy, dz, t_best, idx);
    }
  }
  a.t_out[lane] = t_best;
  a.idx_out[lane] = idx;
}

extern "C" int grt_bvh8_closest(const Traverse8Args* args, void* stream) {
  const Traverse8Args a = *args;
  const int nb = (a.n + BLOCK - 1) / BLOCK;
  bvh8_closest_kernel<<<nb, BLOCK, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* grt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
