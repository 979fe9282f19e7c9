// stream2_rows: the persistent-block binned mesh intersector, for Hopper
// (sm_90a). Replaces the Pallas TPU kernel `stream2_rows`
// (go_raytracer_tpu/ops/pallas/stream2.py, `_stream2_kernel`).
//
// One launch runs a level's whole closest-hit traversal. A block owns BLOCK =
// 128 consecutive lanes of the coherence-sorted pool, one thread per lane,
// and loops rounds until none of its lanes has a candidate cluster left:
//   1. scan: each thread finds its lane's lex-least (near, k) over the
//      clusters whose box its interval (T_MIN, t_best) hits and whose bit in
//      the block's processed set is clear (the cluster boxes, K2 <= 1024,
//      sit in shared memory whole; the arithmetic of ops/stream.candidates);
//   2. reduce: the block's least pick a and greatest real pick (warp
//      shuffles, then one word per warp in shared memory); the block stops
//      when no lane has a pick;
//   3. stream the groups of clusters [a, b], b = min(kmax, a + range_w - 1),
//      against every lane (`stream_groups` of mt.cuh, stream_rows' code);
//   4. mark [a, b] processed for the whole block: every lane met every one
//      of those clusters, so the set is block-uniform, 32 words in shared
//      memory, and progress is strict (a leaves the set of picks).
// The TPU kernel's block is 1024 lanes, Mosaic's grid runs its blocks one
// after another, and the per-level host read of the round loop is gone; here
// the blocks run concurrently. The block size changes how many rounds a block
// makes, not the winners: a lane's winner is the least t over the triangles,
// the first group reaching it in streaming order on a tie across groups.
// Built with -fmad=false: t equals the plain version's bit for bit.
//
// What bounds it: operations. A round costs each lane 12 float operations
// per clear cluster box and 8 Moller-Trumbore tests of 46 per streamed
// group; the bytes are the rays, t and idx once, the tables once (L2 holds
// them for the blocks after the first).

#include "mt.cuh"

#define BLOCK 128
#define NWARP (BLOCK / 32)
#define MAX_K2 1024

struct Stream2Args {
  const float* lines;  // (n_groups, 128) packed group table of the cl2 partition
  const float* lo;     // (k2, 3) cluster box min
  const float* hi;     // (k2, 3) cluster box max
  const int* gs;       // (k2 + 1,) group offsets
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const float* t_in;
  const int* idx_in;
  float* t_out;
  int* idx_out;
  int* rounds;  // (n_blocks,) rounds each block made
  int n_blocks, k2, range_w, max_rounds;
};

__global__ void __launch_bounds__(BLOCK) stream2_kernel(Stream2Args a) {
  __shared__ __align__(16) float sh[STREAM_CHUNK * ENTRY_FLOATS];
  __shared__ float box[MAX_K2 * 6];
  __shared__ unsigned proc[MAX_K2 / 32];
  __shared__ int red_min[NWARP], red_max[NWARP];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = b * BLOCK + tid;
  const int k2 = a.k2;
  for (int i = tid; i < k2 * 3; i += BLOCK) {
    box[i] = a.lo[i];
    box[MAX_K2 * 3 + i] = a.hi[i];
  }
  for (int i = tid; i < MAX_K2 / 32; i += BLOCK) proc[i] = 0u;
  const float ox = a.ox[lane], oy = a.oy[lane], oz = a.oz[lane];
  const float dx = a.dx[lane], dy = a.dy[lane], dz = a.dz[lane];
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  float t_best = a.t_in[lane];
  int idx = a.idx_in[lane];
  int round = 0;
  for (;;) {
    __syncthreads();  // boxes staged, proc marked by the previous round
    // ---- 1. this lane's pick ---------------------------------------------
    float best_near = INFINITY;
    int pick = k2;
    for (int m = 0; m * 32 < k2; ++m) {
      const unsigned w = proc[m];
      const int k_end = min(32, k2 - 32 * m);
      for (int j = 0; j < k_end; ++j) {
        if ((w >> j) & 1u) continue;
        const int k = 32 * m + j;
        float near, far;
        slab(box[3 * k], box[3 * k + 1], box[3 * k + 2], box[MAX_K2 * 3 + 3 * k],
             box[MAX_K2 * 3 + 3 * k + 1], box[MAX_K2 * 3 + 3 * k + 2], ox, oy, oz, ix, iy, iz,
             near, far);
        near = fmaxf(near, T_MIN);
        if (near < fminf(far, t_best) && near < best_near) {
          best_near = near;
          pick = k;
        }
      }
    }
    // ---- 2. the block's range ---------------------------------------------
    int kmin = pick, kmax = pick < k2 ? pick : -1;
    for (int o = 16; o > 0; o >>= 1) {
      kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, o));
      kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, o));
    }
    if ((tid & 31) == 0) {
      red_min[tid >> 5] = kmin;
      red_max[tid >> 5] = kmax;
    }
    __syncthreads();
    kmin = red_min[0];
    kmax = red_max[0];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) {
      kmin = min(kmin, red_min[w]);
      kmax = max(kmax, red_max[w]);
    }
    if (kmax < 0 || round >= a.max_rounds) break;  // block-uniform
    const int ka = kmin;
    const int kb = min(kmax, ka + a.range_w - 1);
    // ---- 3. stream clusters [ka, kb] --------------------------------------
    stream_groups<BLOCK>(a.lines, __ldg(a.gs + ka), __ldg(a.gs + kb + 1), sh, ox, oy, oz, dx,
                         dy, dz, t_best, idx);
    // ---- 4. mark them processed -------------------------------------------
    __syncthreads();  // every lane's scan has read proc
    for (int m = tid; m < MAX_K2 / 32; m += BLOCK)
      proc[m] |= range_bits(min(max(ka - 32 * m, 0), 32), min(max(kb + 1 - 32 * m, 0), 32));
    ++round;
  }
  a.t_out[lane] = t_best;
  a.idx_out[lane] = idx;
  if (tid == 0) a.rounds[b] = round;
}

extern "C" int grt_stream2_rows(const Stream2Args* args, void* stream) {
  const Stream2Args a = *args;
  stream2_kernel<<<a.n_blocks, BLOCK, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* grt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
