// bvh8_closest: the BVH8 stack walk, for Hopper (sm_90a). Replaces the
// Pallas TPU kernel `bvh8_closest` (go_raytracer_tpu/ops/pallas/traverse8.py,
// `_traverse8_kernel`).
//
// Each ray walks the tree with its own stack. A node visit slab-tests the
// eight child boxes against the ray's (T_MIN, t_best) interval
// (aabb.go:90-113) and pushes the hit children in slot order; a leaf visit
// runs Moller-Trumbore on its one or two 8-triangle groups. Entries pop
// last-in first-out. Empty child slots are NaN boxes: the test below fails on
// any NaN, as the plain version's NaN-propagating min/max do. A ray whose cap
// is 0 fails every slab test at the root.
//
// Tables (ops/traverse8.pack_tables, the values of scene/bvh8.collapse's
// lines rearranged): a child slot is one 32-byte row, float4 (min x, min y,
// min z, max x) and float4 (max y, max z, push, valid), 8 rows a node; a
// triangle is one 48-byte row, float4 (v0, e0 x), (e0 y, e0 z, e1 x, e1 y),
// (e1 z, id, 0, 0), 8 rows a group. A node is 2 cache lines and a group 3
// (the line-packed tables spread them over 8 each).
//
// The design: a TEAM of T lanes (8, or 4 with two slots each) walks one ray,
// so a warp holds 32 / T rays. Every lane of a team holds the ray's state
// (planes, t_best, idx, stack pointer); the stack lives in shared memory, one
// row of `stride` ints per ray (stride odd, so the rays of a warp read other
// banks). The warp runs "while-while" phases (as K12, csrc/traverse.cu):
// in the walk phase every team that holds no leaf pops its top entry; a
// leaf is held for the leaf phase, which runs once no team walks or
// `leaf_batch` teams hold a leaf, so node and leaf code do not both run for
// a warp whose teams are at different kinds of entry. A team holding a leaf
// walks no further until it is tested, so its next box test sees the
// t_best the leaf produced.
//  * node visit: lane k slab-tests child slots k, k + T, ... (one row each);
//    `__ballot_sync` gives the team's 8-bit hit mask, and each hit slot c is
//    written at sp + popc(mask & ((1 << c) - 1)), sp growing by popc(mask):
//    exactly the sequential push in slot order;
//  * leaf visit: lane k tests triangles k, k + T, ... of group g, and the
//    team reduces, by xor shuffles, to the least t among the hits with
//    T_MIN < t < t_best and on equal t the largest triangle id: what the
//    sequential scan of a group keeps (mt.cuh's `mt_group`: strict `<` against
//    the running least, the largest id on a tie, the group's winner kept when
//    below the t_best from before the group). A two-group leaf (every leaf
//    of scene 8's statue) loads and tests both groups in one pass and
//    reduces them side by side; group g's winner is taken first, then group
//    g + 1's if below it, as the plain walk does (`team_leaf`).
// So every ray's walk is the plain version's step for step, ties included,
// and with -fmad=false the arithmetic is the same operation for operation:
// the results are the plain version's bit for bit.
//
// What bounds it: the chain of dependent steps of the heaviest rays, each a
// table read from L2 and a test (a ray walks 15 steps on the mean at a
// scene-8 level, the heaviest 98, which alone take ~0.047 ms on an H100),
// and instruction issue for the rest. A team spreads a visit's 8 box tests or 16 triangle tests
// over its lanes, so a step is one dependent load and one or two tests a
// lane; T = 8 puts 8x the warps of one thread a ray in flight, and a warp
// waits for the heaviest of its 32 / T rays, not of 32. The tables (under
// 4 MB) sit in L2; the glue's coherence sort makes neighbouring rays read
// the same rows.

#include "mt.cuh"

#define MAX_BLOCK 256
#define FULL 0xffffffffu

struct Traverse8Args {
  const float4* nodes;  // (8 * n_nodes, 2): a child slot a row
  const float4* tris;   // (8 * n_groups, 3): a triangle a row
  const float* o;       // (n, 3)
  const float* d;       // (n, 3)
  const float* t_cap;   // (n,)
  float* t_out;
  int* idx_out;
  int n;
  int team;        // lanes per ray: 8 or 4
  int block;       // threads per block: a multiple of 32, at most MAX_BLOCK
  int stride;      // ints of shared stack per ray (odd, >= the table's max_stack)
  int leaf_batch;  // teams of a warp holding a leaf that end its walk phase
};

// Lane k's triangles k + j * T of the groups g and g + 1 against the ray,
// every row loaded before any test: per group the least t of the lane's hits
// inside (T_MIN, t_best), the largest id on a tie (the sequential scan of
// mt_group over these slots); (INF, -1) without a hit. Rows of a group the
// team does not test are read from group g (a valid address) and ignored.
template <int T>
__device__ __forceinline__ void lane_leaf(const float4* tris, int g, bool held, bool two, int k,
                                          float ox, float oy, float oz, float dx, float dy,
                                          float dz, float t_best, float bt[2], int bid[2]) {
  constexpr int PER = 8 / T;
  float4 r[2][PER][3];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const float4* row = tris + ((size_t)(g + (two ? q : 0)) * 8 + k + j * T) * 3;
      r[q][j][0] = __ldg(row);
      r[q][j][1] = __ldg(row + 1);
      r[q][j][2] = __ldg(row + 2);
    }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    bt[q] = INFINITY;
    bid[q] = -1;
    const bool on = q == 0 ? held : two;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const float4 a = r[q][j][0], b = r[q][j][1], c = r[q][j][2];
      float tt;
      if (mt_hit(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, ox, oy, oz, dx, dy, dz, t_best,
                 tt) &&
          on) {
        const int id = (int)c.y;
        if (tt < bt[q] || (tt == bt[q] && id > bid[q])) {
          bt[q] = tt;
          bid[q] = id;
        }
      }
    }
  }
}

// The held leaf of each team: its one or two groups tested in one pass,
// both against the t_best from before the leaf, and each reduced over the
// team by xor shuffles to the least t, the largest id on a tie. Then group
// g's winner replaces t_best when below it, and group g + 1's when below
// that: what the plain walk's group-after-group scan keeps, since group
// g + 1's least t below the new t_best is its least t below the old one
// whenever that is below the new one. `held` and `two` are the same in a
// team's lanes.
template <int T>
__device__ __forceinline__ void team_leaf(const float4* tris, int g, bool held, bool two, int k,
                                          float ox, float oy, float oz, float dx, float dy,
                                          float dz, float& t_best, int& idx) {
  float bt[2];
  int bid[2];
  lane_leaf<T>(tris, g, held, two, k, ox, oy, oz, dx, dy, dz, t_best, bt, bid);
#pragma unroll
  for (int off = T / 2; off; off >>= 1)  // the team's lanes are aligned
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float ot = __shfl_xor_sync(FULL, bt[q], off);
      const int oid = __shfl_xor_sync(FULL, bid[q], off);
      if (ot < bt[q] || (ot == bt[q] && oid > bid[q])) {
        bt[q] = ot;
        bid[q] = oid;
      }
    }
#pragma unroll
  for (int q = 0; q < 2; ++q)
    if (bt[q] < t_best) {  // INF where the group was not tested
      t_best = bt[q];
      idx = bid[q];
    }
}

template <int T>
__global__ void __launch_bounds__(MAX_BLOCK) bvh8_closest_kernel(Traverse8Args a) {
  extern __shared__ int s_stack[];
  constexpr int PER = 8 / T;
  constexpr unsigned TEAM_BITS = (1u << T) - 1u;
  const int k = threadIdx.x % T;             // lane in the team = first slot
  const int shift = (threadIdx.x & 31) - k;  // the team's first bit in a ballot
  const int ray_b = threadIdx.x / T;
  const int ray = blockIdx.x * (a.block / T) + ray_b;
  int* stack = s_stack + ray_b * a.stride;
  const bool live = ray < a.n;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 1.0f, dy = 1.0f, dz = 1.0f, t_best = 0.0f;
  if (live) {
    ox = a.o[3 * ray];
    oy = a.o[3 * ray + 1];
    oz = a.o[3 * ray + 2];
    dx = a.d[3 * ray];
    dy = a.d[3 * ray + 1];
    dz = a.d[3 * ray + 2];
    t_best = a.t_cap[ray];
  }
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  int idx = -1;
  int sp = live ? 1 : 0;  // the root is pushed; a lane with no ray has finished
  bool held = false;      // a popped leaf waits for the warp's leaf phase
  int enc = 0;            // its encoding: 2 * first group + (groups - 1)
  if (k == 0) stack[0] = 0;
  __syncwarp();
  for (;;) {
    // ---- walk: every team without a held leaf pops its top entry; a node
    // is visited at once, a leaf is held. Until no team walks, or
    // leaf_batch teams hold a leaf.
    for (;;) {
      const bool walking = sp > 0 && !held;
      if (!__any_sync(FULL, walking) ||
          __popc(__ballot_sync(FULL, held && k == 0)) >= a.leaf_batch)
        break;
      int m = 0;
      if (walking) m = stack[--sp];
      __syncwarp();  // every lane has read the top before a push overwrites it
      const bool is_node = walking && m >= 0;
      if (walking && m < 0) {
        held = true;
        enc = -m - 1;
      }
      if (__any_sync(FULL, is_node)) {
        bool hit[PER];
        int push[PER];
        const float4* e = a.nodes + (size_t)(is_node ? m : 0) * 16;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          // lo = (min x, min y, min z, max x), hi = (max y, max z, push, valid)
          const float4 lo = __ldg(e + 2 * (k + j * T)), hi = __ldg(e + 2 * (k + j * T) + 1);
          const float tx0 = (lo.x - ox) * ix, tx1 = (lo.w - ox) * ix;
          const float ty0 = (lo.y - oy) * iy, ty1 = (hi.x - oy) * iy;
          const float tz0 = (lo.z - oz) * iz, tz1 = (hi.y - oz) * iz;
          const bool finite = tx0 == tx0 && tx1 == tx1 && ty0 == ty0 && ty1 == ty1 &&
                              tz0 == tz0 && tz1 == tz1;
          const float near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
          const float far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
          hit[j] = is_node && finite && fmaxf(near, T_MIN) < fminf(far, t_best);
          push[j] = (int)hi.z;
        }
        unsigned mask = 0;  // the team's hit slots: bit c for slot c
#pragma unroll
        for (int j = 0; j < PER; ++j)
          mask |= ((__ballot_sync(FULL, hit[j]) >> shift) & TEAM_BITS) << (j * T);
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int c = k + j * T;
          if (hit[j]) stack[sp + __popc(mask & ((1u << c) - 1u))] = push[j];
        }
        sp += __popc(mask);
      }
      __syncwarp();  // this step's pushes land before the next pop
    }
    if (!__any_sync(FULL, held)) break;  // no team walking or holding: all done

    // ---- the held leaves
    team_leaf<T>(a.tris, held ? enc >> 1 : 0, held, held && (enc & 1), k, ox, oy, oz, dx, dy, dz,
                 t_best, idx);
    held = false;
  }
  if (live && k == 0) {
    a.t_out[ray] = t_best;
    a.idx_out[ray] = idx;
  }
}

extern "C" int grt_bvh8_closest(const Traverse8Args* args, void* stream) {
  const Traverse8Args a = *args;
  if ((a.team != 8 && a.team != 4) || a.block % 32 || a.block <= 0 || a.block > MAX_BLOCK ||
      a.leaf_batch < 1)
    return (int)cudaErrorInvalidValue;
  const int rays_per_block = a.block / a.team;
  const int nb = (a.n + rays_per_block - 1) / rays_per_block;
  const size_t smem = (size_t)rays_per_block * a.stride * sizeof(int);
  if (a.team == 8)
    bvh8_closest_kernel<8><<<nb, a.block, smem, (cudaStream_t)stream>>>(a);
  else
    bvh8_closest_kernel<4><<<nb, a.block, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* grt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
