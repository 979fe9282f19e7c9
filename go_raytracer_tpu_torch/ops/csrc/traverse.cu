// bvh_closest: the skip-link walk of the binary BVH, for Hopper (sm_90a).
// Replaces the Pallas TPU kernel `bvh_closest`
// (go_raytracer_tpu/ops/pallas/traverse.py, `_traverse_kernel`).
//
// The TPU kernel shares one walk per tile of 1024 rays: its node pointer is a
// scalar that descends when any ray of the tile hits the node's box. Here one
// thread walks its own ray with its own pointer: the pointer descends to
// node + 1 where the ray hits an inner node's box and jumps to the node's
// skip link otherwise (and after every leaf). A ray's own walk visits a
// subset of its tile's, in the same depth-first order, and the leaves it
// skips are those whose box it misses; so the winners are the tile walk's
// unless a triangle's t lands on the edge of its box's interval in float
// (tests/test_torch_traverse.py names any such lane).
//
// A leaf tests its triangles in order with the TPU kernel's own rule: a hit
// needs T_MIN < t < t_best strictly, so the first triangle found wins a tie
// in walk order (`mt_hit` of mt.cuh is the same arithmetic, operation for
// operation; built with -fmad=false, so t equals the plain version's bit for
// bit). Tables are plain rows: nodes [min(3), max(3), first, count, skip] and
// leaf-ordered triangles [v0, e0, e1], float32 (ops/traverse.pack_bvh).
//
// What bounds it: the latency of dependent loads. A visit reads one 36-byte
// node row and does 12 float operations of slab test; a leaf reads up to
// leaf_size triangle rows of 36 bytes. The tables (a few MB) sit in L2 and
// the glue's coherence sort makes neighbouring threads read the same rows.

#include "mt.cuh"

#define BLOCK 128

struct TraverseArgs {
  const float* nodes;  // (n_nodes, 9)
  const float* tris;   // (n_tri_rows, 9)
  const float* o;      // (n, 3)
  const float* d;      // (n, 3)
  const float* t_cap;  // (n,)
  float* t_out;
  int* idx_out;
  int n, n_nodes;
};

__global__ void __launch_bounds__(BLOCK) bvh_closest_kernel(TraverseArgs a) {
  const int lane = blockIdx.x * BLOCK + threadIdx.x;
  if (lane >= a.n) return;
  const float ox = a.o[3 * lane], oy = a.o[3 * lane + 1], oz = a.o[3 * lane + 2];
  const float dx = a.d[3 * lane], dy = a.d[3 * lane + 1], dz = a.d[3 * lane + 2];
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  const float* __restrict__ nodes = a.nodes;
  const float* __restrict__ tris = a.tris;
  float t_best = a.t_cap[lane];
  int idx = -1;
  int node = 0;
  while (node < a.n_nodes) {
    const float* r = nodes + (size_t)node * 9;
    float near, far;
    slab(__ldg(r), __ldg(r + 1), __ldg(r + 2), __ldg(r + 3), __ldg(r + 4), __ldg(r + 5), ox, oy,
         oz, ix, iy, iz, near, far);
    const bool hit = fmaxf(near, T_MIN) < fminf(far, t_best);
    const int count = (int)__ldg(r + 7);
    const int skip = (int)__ldg(r + 8);
    if (hit && count > 0) {
      const int first = (int)__ldg(r + 6);
      for (int k = 0; k < count; ++k) {
        const float* t = tris + (size_t)(first + k) * 9;
        float tt;
        if (mt_hit(__ldg(t), __ldg(t + 1), __ldg(t + 2), __ldg(t + 3), __ldg(t + 4),
                   __ldg(t + 5), __ldg(t + 6), __ldg(t + 7), __ldg(t + 8), ox, oy, oz, dx, dy,
                   dz, t_best, tt)) {
          t_best = tt;
          idx = first + k;
        }
      }
    }
    node = hit && count == 0 ? node + 1 : skip;
  }
  a.t_out[lane] = t_best;
  a.idx_out[lane] = idx;
}

extern "C" int grt_bvh_closest(const TraverseArgs* args, void* stream) {
  const TraverseArgs a = *args;
  const int nb = (a.n + BLOCK - 1) / BLOCK;
  bvh_closest_kernel<<<nb, BLOCK, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* grt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
