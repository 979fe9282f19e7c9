// bvh_closest: the skip-link walk of the binary BVH, for Hopper (sm_90a).
// Replaces the Pallas TPU kernel `bvh_closest`
// (go_raytracer_tpu/ops/pallas/traverse.py, `_traverse_kernel`).
//
// The TPU kernel shares one walk per tile of 1024 rays: its node pointer is a
// scalar that descends when any ray of the tile hits the node's box. Here each
// ray walks with its own pointer: the pointer descends to node + 1 where the
// ray hits an inner node's box and jumps to the node's skip link otherwise
// (and after every leaf). A ray's own walk visits a subset of its tile's, in
// the same depth-first order, and the leaves it skips are those whose box it
// misses; so the winners are the tile walk's unless a triangle's t lands on
// the edge of its box's interval in float (tests/test_torch_traverse.py names
// any such lane).
//
// A leaf tests its triangles with the TPU kernel's own rule: a hit needs
// T_MIN < t < t_best strictly, so the first triangle found wins a tie in walk
// order (`mt_hit` of mt.cuh is the same arithmetic, operation for operation;
// built with -fmad=false, so t equals the plain version's bit for bit).
//
// Tables (ops/traverse.pack_bvh), read with 16-byte loads: a node is 32
// bytes, float4 (min, first) and float4 (max, w) with w = skip on an inner
// node and -count on a leaf (whose skip is node + 1); a triangle is 48
// bytes, float4 (v0, 0), (e0, 0), (e1, 0), in leaf order.
//
// The design: a warp's rays (warp_rays of its lanes: 32, 16 or 8) walk in
// "while-while" steps. In the walk phase every lane that holds no leaf to
// test visits its next node (one box test), until no lane is walking (each
// has found a leaf its interval hits, or has finished) or leaf_batch lanes
// hold a leaf. Then the leaf phase tests the warp's held leaves together:
// they are laid out as rows of S lanes (S the least power of two >= the
// largest count, at most 32; a longer leaf takes several rows in order),
// 32 / S rows a step, each lane testing one triangle of one ray with that
// ray's planes and t_best fetched by __shfl_sync; the S lanes of a row
// reduce to the lex-least (t, row), which is what the sequential scan from
// the same t_best keeps (the least t below t_best, the first row in order
// on a tie); the ray's lane takes it. A lane with a held leaf walks no
// further until its leaf is tested, so its next box test sees the t_best
// the leaf produced, and every ray's walk is the plain version's step for
// step. Leaf steps per warp go from about the sum over the lanes' leaves (the
// divergent walk runs a leaf's 16-triangle body once for each lane reaching
// it at another iteration) to that sum spread over 32 lanes, and lanes with
// no ray, or done with theirs, help test the others' leaves.
//
// What bounds it: the latency of dependent loads (a visit is one node load
// and 12 float operations; a leaf step one triangle load and ~46) along the
// heaviest warps. At 65,536 sorted rays of a scene-8 level a ray visits 54
// nodes and tests 3.2 leaves on the mean, but the heaviest warp of 32 rays
// walks 231 visits and holds 429 leaves, and the kernel lasts as long as
// its heaviest warps. Fewer rays a warp (ops/traverse.WARP_RAYS, chosen on
// the card) cut the leaves a warp holds and put more warps on each SM. The
// tables (a few MB) sit in L2, and the glue's coherence sort makes
// neighbouring lanes read the same node rows.

#include "mt.cuh"

#include <climits>

#define BLOCK 128
#define FULL 0xffffffffu

struct TraverseArgs {
  const float4* nodes;  // (n_nodes, 2): (min, first), (max, w)
  const float4* tris;   // (n_tri_rows, 3): (v0, 0), (e0, 0), (e1, 0)
  const float* o;       // (n, 3)
  const float* d;       // (n, 3)
  const float* t_cap;   // (n,)
  float* t_out;
  int* idx_out;
  int n, n_nodes, leaf_batch;
  int warp_rays;  // rays per warp: 32, or 16 / 8 with the other lanes only helping
};

__global__ void __launch_bounds__(BLOCK) bvh_closest_kernel(TraverseArgs a) {
  __shared__ int s_lane[BLOCK / 32][32];  // a warp's pending lanes, by rank
  const int ln = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned below = (1u << ln) - 1u;
  const int lane = (blockIdx.x * (BLOCK / 32) + w) * a.warp_rays + ln;  // this lane's ray
  const bool live = ln < a.warp_rays && lane < a.n;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 1.0f, dy = 1.0f, dz = 1.0f, t_best = 0.0f;
  if (live) {
    ox = a.o[3 * lane];
    oy = a.o[3 * lane + 1];
    oz = a.o[3 * lane + 2];
    dx = a.d[3 * lane];
    dy = a.d[3 * lane + 1];
    dz = a.d[3 * lane + 2];
    t_best = a.t_cap[lane];
  }
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  int idx = -1;
  int node = live ? 0 : a.n_nodes;  // a lane with no ray has finished; it only helps
  bool pending = false;
  int leaf_first = 0, leaf_count = 0;
  for (;;) {
    // ---- walk until no lane is walking (or leaf_batch lanes hold a leaf) --
    for (;;) {
      const unsigned held = __ballot_sync(FULL, pending);
      if (!__any_sync(FULL, !pending && node < a.n_nodes) || __popc(held) >= a.leaf_batch)
        break;
      if (!pending && node < a.n_nodes) {
        const float4 lo = __ldg(a.nodes + 2 * node), hi = __ldg(a.nodes + 2 * node + 1);
        float near, far;
        slab(lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, ox, oy, oz, ix, iy, iz, near, far);
        const bool hit = fmaxf(near, T_MIN) < fminf(far, t_best);
        const bool leaf = hi.w < 0.0f;
        if (hit && leaf) {
          pending = true;
          leaf_first = (int)lo.w;
          leaf_count = (int)-hi.w;
        }
        node = hit || leaf ? node + 1 : (int)hi.w;
      }
    }
    const unsigned held = __ballot_sync(FULL, pending);
    if (!held) break;  // no lane walking and none holding a leaf: all finished

    // ---- test the held leaves together ------------------------------------
    const int rank = __popc(held & below);
    if (pending) s_lane[w][rank] = ln;
    __syncwarp();
    const int cmax = __reduce_max_sync(FULL, pending ? leaf_count : 0);
    int lg = 0;
    while ((1 << lg) < cmax && lg < 5) ++lg;
    const int seg = ln >> lg, sl = ln & ((1 << lg) - 1);
    const int per_step = 32 >> lg;                       // rows per step
    const int chunks = (cmax + (1 << lg) - 1) >> lg;    // rows per leaf
    const int rows = __popc(held) * chunks;
    for (int r0 = 0; r0 < rows; r0 += per_step) {
      const int row = r0 + seg;
      const bool valid = row < rows;
      const int q = valid ? row / chunks : 0;
      const int src = s_lane[w][q];
      const float sox = __shfl_sync(FULL, ox, src), soy = __shfl_sync(FULL, oy, src);
      const float soz = __shfl_sync(FULL, oz, src), sdx = __shfl_sync(FULL, dx, src);
      const float sdy = __shfl_sync(FULL, dy, src), sdz = __shfl_sync(FULL, dz, src);
      const float stb = __shfl_sync(FULL, t_best, src);
      const int sfirst = __shfl_sync(FULL, leaf_first, src);
      const int scount = __shfl_sync(FULL, leaf_count, src);
      const int k = (row - q * chunks) * (1 << lg) + sl;
      float bt = INFINITY;
      int brow = INT_MAX;
      if (valid && k < scount) {
        const float4* tr = a.tris + 3 * (size_t)(sfirst + k);
        const float4 v0 = __ldg(tr), e0 = __ldg(tr + 1), e1 = __ldg(tr + 2);
        float tt;
        if (mt_hit(v0.x, v0.y, v0.z, e0.x, e0.y, e0.z, e1.x, e1.y, e1.z, sox, soy, soz, sdx, sdy,
                   sdz, stb, tt)) {
          bt = tt;
          brow = sfirst + k;
        }
      }
      for (int off = (1 << lg) >> 1; off; off >>= 1) {  // lex-least (t, row) of the row's lanes
        const float ot = __shfl_xor_sync(FULL, bt, off);
        const int orow = __shfl_xor_sync(FULL, brow, off);
        if (ot < bt || (ot == bt && orow < brow)) {
          bt = ot;
          brow = orow;
        }
      }
      // this lane's row in the step, if any: rows [rank * chunks, +chunks)
      // meet [r0, r0 + per_step) in at most one row (chunks or per_step is 1)
      const int mine_r = max(rank * chunks, r0);
      const bool mine = pending && mine_r < min(rank * chunks + chunks, r0 + per_step);
      const int from = mine ? (mine_r - r0) << lg : ln;
      const float rt = __shfl_sync(FULL, bt, from);
      const int rrow = __shfl_sync(FULL, brow, from);
      if (mine && rrow != INT_MAX) {  // a hit below the t_best it was tested against
        t_best = rt;
        idx = rrow;
      }
    }
    __syncwarp();  // every read of s_lane precedes the next phase's writes
    pending = false;
  }
  if (live) {
    a.t_out[lane] = t_best;
    a.idx_out[lane] = idx;
  }
}

extern "C" int grt_bvh_closest(const TraverseArgs* args, void* stream) {
  const TraverseArgs a = *args;
  const int rays_per_block = (BLOCK / 32) * a.warp_rays;
  const int nb = (a.n + rays_per_block - 1) / rays_per_block;
  bvh_closest_kernel<<<nb, BLOCK, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* grt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
