// stream_round_rows: one fused round of the binned mesh intersector, for
// Hopper (sm_90a). Replaces the Pallas TPU kernel `stream_round_rows`
// (go_raytracer_tpu/ops/pallas/stream.py, `_round_kernel`).
//
// The block is stream.cu's: BLOCK = 128 consecutive rays of the pool that the
// glue sorted by candidate cluster, one thread per ray, and the block's group
// range [glo, ghi). Each thread
//   1. streams the range against its ray (`stream_groups` of mt.cuh: one
//      CTA per block; stream.cu instead splits the ranges across the card);
//   2. ORs the block's cluster interval [ca, cb] into its processed-bit words
//      (n_mask int32 planes, bit k of word k / 32);
//   3. scans the K <= 256 cluster boxes, staged once per block in shared
//      memory, in cluster order for its next candidate: the lex-least
//      (near, k) over the boxes whose bit is clear and that the ray's
//      interval (T_MIN, t_best) hits, with the arithmetic of
//      ops/stream.candidates (1 / safe(d), six products, min/max in the same
//      order, the T_MIN clamp; a strictly smaller near replaces, so the least
//      k wins a tie). key = K where there is none.
// Built with -fmad=false, so the rounds, winners and t equal those of the
// unfused route (stream_rows + the tensor-code scan) bit for bit.
//
// What bounds it: operations. Per ray the stream costs 8 Moller-Trumbore
// tests of 46 float operations per group of the range, and the scan 12 per
// cluster box; the bytes are the ray planes, t, idx, key and the mask words
// once each, the group range once per block (the table sits in L2).

#include "mt.cuh"

#define BLOCK 128
#define MAX_K 256

struct RoundArgs {
  const float* lines;  // (n_groups, 128) packed group table
  const float* lo;     // (k_cl, 3) cluster box min
  const float* hi;     // (k_cl, 3) cluster box max
  const int *glo, *ghi, *ca, *cb;  // (n_blocks,)
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const float* t_in;
  const int* idx_in;
  const int* masks_in;  // (n_mask, n)
  float* t_out;
  int* idx_out;
  int* key_out;
  int* masks_out;  // (n_mask, n)
  int n_blocks, n_groups, k_cl, n_mask;
};

__global__ void __launch_bounds__(BLOCK) stream_round_kernel(RoundArgs a) {
  __shared__ __align__(16) float sh[STREAM_CHUNK * ENTRY_FLOATS];
  __shared__ float box[MAX_K * 6];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int n = a.n_blocks * BLOCK;
  const int lane = b * BLOCK + tid;
  for (int i = tid; i < a.k_cl * 3; i += BLOCK) {
    box[i] = a.lo[i];
    box[MAX_K * 3 + i] = a.hi[i];
  }
  const float ox = a.ox[lane], oy = a.oy[lane], oz = a.oz[lane];
  const float dx = a.dx[lane], dy = a.dy[lane], dz = a.dz[lane];
  float t_best = a.t_in[lane];
  int idx = a.idx_in[lane];
  // ---- stream (the barriers inside also publish the staged boxes) --------
  stream_groups<BLOCK>(a.lines, max(a.glo[b], 0), min(a.ghi[b], a.n_groups), sh, ox, oy, oz,
                       dx, dy, dz, t_best, idx);
  __syncthreads();
  a.t_out[lane] = t_best;
  a.idx_out[lane] = idx;

  // ---- mark [ca, cb] in the processed bits -------------------------------
  const int ca = a.ca[b], cb = a.cb[b];
  unsigned words[MAX_K / 32];
#pragma unroll
  for (int m = 0; m < MAX_K / 32; ++m) {
    if (m < a.n_mask) {
      const int lo_b = min(max(ca - 32 * m, 0), 32);
      const int hi_b = min(max(cb + 1 - 32 * m, 0), 32);
      words[m] = (unsigned)a.masks_in[(size_t)m * n + lane] | range_bits(lo_b, hi_b);
      a.masks_out[(size_t)m * n + lane] = (int)words[m];
    }
  }

  // ---- next candidate: lex-least (near, k) over the clear boxes ----------
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  float best_near = INFINITY;
  int best_k = a.k_cl;
#pragma unroll
  for (int m = 0; m < MAX_K / 32; ++m) {
    if (m < a.n_mask) {
      const int k_end = min(32, a.k_cl - 32 * m);
      for (int j = 0; j < k_end; ++j) {
        if ((words[m] >> j) & 1u) continue;
        const int k = 32 * m + j;
        float near, far;
        slab(box[3 * k], box[3 * k + 1], box[3 * k + 2], box[MAX_K * 3 + 3 * k],
             box[MAX_K * 3 + 3 * k + 1], box[MAX_K * 3 + 3 * k + 2], ox, oy, oz, ix, iy, iz,
             near, far);
        near = fmaxf(near, T_MIN);
        if (near < fminf(far, t_best) && near < best_near) {
          best_near = near;
          best_k = k;
        }
      }
    }
  }
  a.key_out[lane] = best_k;
}

extern "C" int grt_stream_round_rows(const RoundArgs* args, void* stream) {
  const RoundArgs a = *args;
  stream_round_kernel<<<a.n_blocks, BLOCK, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* grt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
