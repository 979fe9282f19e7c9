// The work-item stream of the binned mesh intersector, shared by K4
// (stream.cu, `stream_rows`) and K10 (stream_round.cu, `stream_round_rows`):
// a later change to the split, the staging or the merge reaches both.
//
// The glue sorts the ray pool by candidate cluster, so block b's BLOCK rays
// want one contiguous range [glo[b], ghi[b]) of packed 8-triangle groups.
// The ranges differ widely in length (a block that spans many sparse
// clusters against one that holds a single cluster), so one CTA per block
// would make the launch as long as the longest range. The work is split
// instead:
//   1. work items: an item is (block b, chunk c), the groups of b's range
//      that fall in [c * ch, (c + 1) * ch) of the global group index; `ch`
//      (ops/stream.CH) is a multiple of 8, so an item's groups are whole
//      octets of the table, each one contiguous 4 KB block (rows (m >> 3) *
//      8 .. +8, all 128 columns). `stream_prep` scans the items per block on
//      the device (no host read) and sets every ray's key to "no hit";
//   2. `stream_items`: a persistent grid (SMs x resident CTAs) pulls items
//      from a device counter, finds (b, c) by binary search in the scan, and
//      stages the item's octets into a ring of two stages with cp.async, so
//      the next item's triangles land while this one is tested. Each thread
//      holds one ray of b and tests it against the staged triangles by
//      broadcast reads (every thread reads the same shared address);
//   3. each item starts from t_in and runs mt_group over its groups in
//      ascending order; a ray that found a hit does one 64-bit atomicMin on
//      key = (float bits of t) << 32 | (g << 3 | slot), g its winning
//      group, slot the slot of that group's winner;
//   4. a finish pass (`decode_key`) reads t from the key's high word and idx
//      from field 9 of (g, slot), or keeps t_in and idx_in where the key
//      still holds its initial value (all ones: every hit has t < t_in).
//
// Why the merge equals the sequential stream of the plain version: the
// stream replaces its best only by a strictly smaller t, and inside a group
// keeps the largest id at the least t. So it ends at the least t over the
// range, t*, in the first group g* that reaches t*, with that group's
// largest id at t*. Every item tests its groups in the same order from t_in,
// so the item holding g* ends at (t*, g*, the same slot): the groups before
// g* in it have no triangle at t* or below. Any other item ends at a t >= t*
// or, at t*, with a later group. Hits satisfy T_MIN < t < t_in, so t > 0 and
// its float bits order as unsigned integers: the least key is (t*, g*, slot).
// Sources including this header are built with -fmad=false, as the plain
// version's arithmetic: t and idx equal `stream_rows_ref`'s bit for bit.

#pragma once

#include "mt.cuh"

#define BLOCK 128
#define PREP_THREADS 1024
#define OCTET_FLOATS 1024  // 8 rows x 128 columns: 8 groups

struct StreamArgs {
  const float* lines;  // (n_groups, 128) packed group table
  const int *glo, *ghi;  // (n_blocks,)
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const float* t_in;
  const int* idx_in;
  float* t_out;
  int* idx_out;
  unsigned long long* keys;  // (n_blocks * BLOCK,) scratch: each ray's best
  int* scan;  // (n_blocks + 2,) scratch: items before each block, the total, the counter
  int n_blocks, n_groups, ch;
};

__device__ __forceinline__ int range_lo(const StreamArgs& a, int b) { return max(a.glo[b], 0); }
__device__ __forceinline__ int range_hi(const StreamArgs& a, int b) {
  return min(a.ghi[b], a.n_groups);
}

// Exclusive scan of each block's item count (one CTA, tiles of
// PREP_THREADS blocks with a carry), the total, a zero counter; every CTA
// sets keys to all ones.
__global__ void __launch_bounds__(PREP_THREADS) stream_prep(StreamArgs a) {
  const int n = a.n_blocks * BLOCK;
  for (int i = blockIdx.x * PREP_THREADS + threadIdx.x; i < n; i += gridDim.x * PREP_THREADS)
    a.keys[i] = ~0ull;
  if (blockIdx.x != 0) return;
  __shared__ int warp_sum[PREP_THREADS / 32];
  const int tid = threadIdx.x, ln = tid & 31, w = tid >> 5;
  int carry = 0;  // the same in every thread
  for (int base = 0; base < a.n_blocks; base += PREP_THREADS) {
    const int b = base + tid;
    int v = 0;
    if (b < a.n_blocks) {
      const int lo = range_lo(a, b), hi = range_hi(a, b);
      v = hi > lo ? (hi - 1) / a.ch - lo / a.ch + 1 : 0;
    }
    int x = v;  // inclusive scan inside the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (ln >= o) x += y;
    }
    if (ln == 31) warp_sum[w] = x;
    __syncthreads();
    if (w == 0) {
      int s = warp_sum[ln];
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, s, o);
        if (ln >= o) s += y;
      }
      warp_sum[ln] = s;
    }
    __syncthreads();
    if (b < a.n_blocks) a.scan[b] = carry + (w ? warp_sum[w - 1] : 0) + x - v;
    carry += warp_sum[PREP_THREADS / 32 - 1];
    __syncthreads();  // every read of warp_sum precedes the next tile's writes
  }
  if (tid == 0) {
    a.scan[a.n_blocks] = carry;
    a.scan[a.n_blocks + 1] = 0;
  }
}

// The next item from the counter, as (block, first group, end group), or
// block -1 when none is left.
__device__ __forceinline__ int3 claim(const StreamArgs& a, int total) {
  const int item = atomicAdd(a.scan + a.n_blocks + 1, 1);
  if (item >= total) return make_int3(-1, 0, 0);
  int lo = 0, hi = a.n_blocks - 1;  // the last block whose first item is <= item
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(a.scan + mid) <= item) lo = mid;
    else hi = mid - 1;
  }
  const int g_lo = range_lo(a, lo), g_hi = range_hi(a, lo);
  const int chunk = g_lo / a.ch + item - __ldg(a.scan + lo);
  return make_int3(lo, max(g_lo, chunk * a.ch), min(g_hi, (chunk + 1) * a.ch));
}

// Stage the octets holding groups [it.y, it.z) into `dst`, one 16-byte copy
// per thread and step.
__device__ __forceinline__ void stage_item(const StreamArgs& a, int3 it, float* dst) {
  if (it.x < 0) return;
  const int o0 = it.y >> 3, n_vec = (((it.z - 1) >> 3) - o0 + 1) * (OCTET_FLOATS / 4);
  const float* src = a.lines + (size_t)o0 * OCTET_FLOATS;
  for (int i = threadIdx.x; i < n_vec; i += BLOCK) cp_async16(dst + 4 * i, src + 4 * i);
}

__global__ void __launch_bounds__(BLOCK) stream_items(StreamArgs a) {
  extern __shared__ __align__(16) float ring[];  // two stages of ch groups
  __shared__ int3 s_item[3];  // the items of three consecutive steps
  const int stage_floats = a.ch * ENTRY_FLOATS;
  const int total = a.scan[a.n_blocks];
  if (threadIdx.x == 0) s_item[0] = claim(a, total);
  __syncthreads();
  stage_item(a, s_item[0], ring);
  cp_async_commit();
  for (int k = 0;; ++k) {
    const int3 it = s_item[k % 3];
    if (it.x < 0) break;
    // slot (k + 1) % 3 was last read at step k - 2, before the barriers of
    // step k - 1; stage (k + 1) & 1 was last tested at step k - 1
    if (threadIdx.x == 0) s_item[(k + 1) % 3] = claim(a, total);
    __syncthreads();
    stage_item(a, s_item[(k + 1) % 3], ring + ((k + 1) & 1) * stage_floats);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of step k landed
    __syncthreads();     // and everyone's
    const float* st = ring + (k & 1) * stage_floats;
    const int o0 = it.y >> 3;
    const int lane = it.x * BLOCK + threadIdx.x;
    const float ox = a.ox[lane], oy = a.oy[lane], oz = a.oz[lane];
    const float dx = a.dx[lane], dy = a.dy[lane], dz = a.dz[lane];
    float t_best = a.t_in[lane];
    int best_g = -1, best_s = 0;
    for (int g = it.y; g < it.z; ++g) {
      int s;
      if (mt_group_slot(st + ((g >> 3) - o0) * OCTET_FLOATS + (g & 7) * 16, 128, ox, oy, oz,
                        dx, dy, dz, t_best, s)) {
        best_g = g;
        best_s = s;
      }
    }
    if (best_g >= 0)
      atomicMin(a.keys + lane, ((unsigned long long)__float_as_uint(t_best) << 32) |
                                   (unsigned)((best_g << 3) | best_s));
  }
  cp_async_wait<0>();
}

// Ray i's merged (t, idx): from its key, or t_in and idx_in where no item
// found a hit.
__device__ __forceinline__ void decode_key(const StreamArgs& a, int i, float& t, int& idx) {
  const unsigned long long key = a.keys[i];
  if (key == ~0ull) {
    t = a.t_in[i];
    idx = a.idx_in[i];
  } else {
    const unsigned low = (unsigned)key;
    t = __uint_as_float((unsigned)(key >> 32));
    idx = (int)a.lines[packed_offset(low >> 3) + (size_t)(low & 7) * 128 + 9];
  }
}

// Launch steps 1 and 2 on `st`: the item scan and the persistent item grid
// (its dynamic shared memory is the ring, two stages of ch groups). The
// caller launches its finish pass after them.
static cudaError_t launch_stream_items(const StreamArgs& a, cudaStream_t st) {
  const int n = a.n_blocks * BLOCK;
  const size_t smem = (size_t)2 * a.ch * ENTRY_FLOATS * sizeof(float);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err)
    err = cudaFuncSetAttribute(stream_items, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (!err)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stream_items, BLOCK, smem);
  if (err) return err;
  stream_prep<<<min((n + PREP_THREADS - 1) / PREP_THREADS, 2 * sms), PREP_THREADS, 0, st>>>(a);
  stream_items<<<sms * max(per_sm, 1), BLOCK, smem, st>>>(a);
  return cudaGetLastError();
}
