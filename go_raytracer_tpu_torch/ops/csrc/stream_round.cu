// stream_round_rows: one fused round of the binned mesh intersector, for
// Hopper (sm_90a). Replaces the Pallas TPU kernel `stream_round_rows`
// (go_raytracer_tpu/ops/pallas/stream.py, `_round_kernel`).
//
// The block is K4's: BLOCK = 128 consecutive rays of the pool that the glue
// sorted by candidate cluster, and the block's group range [glo, ghi). A
// round is three launches:
//   1-2. the stream of K4, from stream_items.cuh (`stream_prep` scans the
//      blocks' work items of ops/stream.CH groups on the device, the
//      persistent `stream_items` grid pulls them from a counter, stages
//      octets through a cp.async ring and merges each ray's items by a
//      64-bit atomicMin on (t bits) << 32 | g << 3 | slot): the launch no
//      longer lasts as long as the block with the longest range;
//   3. `round_finish`, one thread per ray: decodes the merged (t, idx) as
//      K4's finish pass does, ORs its block's cluster interval [ca, cb] into
//      its processed-bit words (n_mask int32 planes, bit k of word k / 32),
//      and scans the K <= 256 cluster boxes, staged once per CTA in shared
//      memory, in cluster order for its next candidate: the lex-least
//      (near, k) over the boxes whose bit is clear and that the ray's
//      interval (T_MIN, t_best) hits, with the arithmetic of
//      ops/stream.candidates (1 / safe(d), six products, min/max in the same
//      order, the T_MIN clamp; a strictly smaller near replaces, so the least
//      k wins a tie). key = K where there is none.
// Why a launch of its own for step 3, and not the last item of each block
// behind a per-block done counter: the scan needs the block's merged t, so it
// waits for every item of the block either way; a block whose range is
// empty (the sentinel rays, a block past the pool's last candidate) has no
// item at all, and yet its rays need their mark and their scan; and the
// launch costs ~2 us against the stream's ~0.1 ms, while the last item of a
// block would run 128 rays x K boxes on one CTA at the tail of the grid.
// Built with -fmad=false, so the rounds, winners and t equal those of the
// unfused route (stream_rows + the tensor-code scan) bit for bit.
//
// What bounds it: operations. Per ray the stream costs 8 Moller-Trumbore
// tests of 46 float operations per group of the range, and the scan 12 per
// cluster box; the bytes are the ray planes, t, idx, key and the mask words
// once each, the group table once (it sits in L2).

#include "stream_items.cuh"

#define MAX_K 256
#define EPI_THREADS 256  // two blocks of rays per CTA of the finish pass

struct RoundArgs {
  StreamArgs s;  // the stream: table, ranges, rays, t/idx in and out, scratch
  const float* lo;  // (k_cl, 3) cluster box min
  const float* hi;  // (k_cl, 3) cluster box max
  const int *ca, *cb;  // (n_blocks,) the block's cluster interval
  const int* masks_in;  // (n_mask, n)
  int* key_out;
  int* masks_out;  // (n_mask, n)
  int k_cl, n_mask;
};

__global__ void __launch_bounds__(EPI_THREADS) round_finish(RoundArgs r) {
  __shared__ float box[MAX_K * 6];
  const StreamArgs& a = r.s;
  for (int i = threadIdx.x; i < r.k_cl * 3; i += EPI_THREADS) {
    box[i] = r.lo[i];
    box[MAX_K * 3 + i] = r.hi[i];
  }
  __syncthreads();
  const int n = a.n_blocks * BLOCK;
  const int lane = blockIdx.x * EPI_THREADS + threadIdx.x;
  if (lane >= n) return;
  const int b = lane / BLOCK;
  float t_best;
  int idx;
  decode_key(a, lane, t_best, idx);
  a.t_out[lane] = t_best;
  a.idx_out[lane] = idx;

  // ---- mark [ca, cb] in the processed bits -------------------------------
  const int ca = r.ca[b], cb = r.cb[b];
  unsigned words[MAX_K / 32];
#pragma unroll
  for (int m = 0; m < MAX_K / 32; ++m) {
    if (m < r.n_mask) {
      const int lo_b = min(max(ca - 32 * m, 0), 32);
      const int hi_b = min(max(cb + 1 - 32 * m, 0), 32);
      words[m] = (unsigned)r.masks_in[(size_t)m * n + lane] | range_bits(lo_b, hi_b);
      r.masks_out[(size_t)m * n + lane] = (int)words[m];
    }
  }

  // ---- next candidate: lex-least (near, k) over the clear boxes ----------
  const float ox = a.ox[lane], oy = a.oy[lane], oz = a.oz[lane];
  const float dx = a.dx[lane], dy = a.dy[lane], dz = a.dz[lane];
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  float best_near = INFINITY;
  int best_k = r.k_cl;
#pragma unroll
  for (int m = 0; m < MAX_K / 32; ++m) {
    if (m < r.n_mask) {
      const int k_end = min(32, r.k_cl - 32 * m);
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
  r.key_out[lane] = best_k;
}

extern "C" int grt_stream_round_rows(const RoundArgs* args, void* stream) {
  const RoundArgs r = *args;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = launch_stream_items(r.s, st);
  if (err) return (int)err;
  const int n = r.s.n_blocks * BLOCK;
  round_finish<<<(n + EPI_THREADS - 1) / EPI_THREADS, EPI_THREADS, 0, st>>>(r);
  return (int)cudaGetLastError();
}

extern "C" const char* grt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
