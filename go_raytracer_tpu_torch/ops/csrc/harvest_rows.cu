// reverse_harvest: the reverse harvest of a regen `queue` window, for Hopper
// (sm_90a). Replaces the Pallas TPU kernel `reverse_harvest`
// (go_raytracer_tpu/ops/pallas/harvest.py, `_harvest_kernel` with the
// started planes) together with the accumulator row scan that follows it
// (integrator/regen.py, write_row).
//
// Inputs as the TPU kernel takes them: the merged V planes and flag words of
// `outer * cadence` recorded levels, and the started planes STs of the
// first `refill_outer` outer rows (a path starts at inner level 0 of its
// row). Three jobs:
//   1. per lane, L = clamp?(emit ? V : V * L) backwards over all levels
//      (camera.go:330-341), L in registers, rounded as harvest.cu rounds so
//      that it stays bit-identical to its plain version;
//   2. at inner level 0 of a refill row, a started lane's finished L is
//      pulled and its recursion reset;
//   3. the rank of each started lane among its row's starts in flat lane
//      order, which the TPU kernel computes in its own body and then uses
//      to shift the row's starts to the front (its vector unit has no
//      scatter). Here `count_starts` writes each block's start count per
//      row, `scan_counts` turns every row of counts into exclusive
//      prefixes, and `harvest_rows` adds the rank inside the block from
//      warp ballots. The started lane then writes L straight to
//      acc[nis[r] - item_base + rank]: each path exactly once, nothing
//      else, so no row tails and no atomics.
//
// What bounds it: bytes. It reads 16 bytes per lane and level, 4 bytes per
// lane and refill row (twice: once to count, once to rank), and writes 12
// bytes per started path; the level loop is sequential per lane, so at
// 131072 lanes the card has 512 blocks of 256 threads in flight.
//
// `grt_harvest_rows_perm` is the same harvest for a window whose lanes were
// put in coherence order before every kernel call (the lane coherence sort,
// integrator/regen.py `coherence_sort`): perm[r][i] is the lane that the
// lane at position i of outer row r held in row r - 1. The JAX package
// unwinds each row's sort inside its XLA reverse scan, after the row's
// starts, with one lane-wide sort by perm[r] (integrator/regen.py there,
// `rev_outer` with `reorder`). Here one thread follows one lane timeline
// backwards across the sorts: it holds position p of row r, and after the
// row's levels and starts steps to p = perm[r][p]. Each perm[r] is a
// bijection, so no two threads ever meet and one launch covers the window
// without a grid-wide barrier. A moving p breaks the block ballots of
// `harvest_rows`, so `rank_starts` first writes every started lane's rank
// among its row's starts into a rank plane (-1: no start), which the walk
// reads in place of the started flags. Its bound by bytes is the harvest's
// above plus 4 bytes per lane and outer row (perm); the rank plane is this
// design's scratch, not a byte the harvest needs, and after the first sort
// the walk's loads are gathers.

#include <cuda_runtime.h>
#include <stdint.h>

#define BLOCK 256
#define NWARP (BLOCK / 32)

struct HarvestRowsArgs {
  const float* vr;
  const float* vg;
  const float* vb;
  const int* fl;   // (outer * cadence, n)
  const int* sts;  // (refill_outer, n) started flags
  const int* nis;  // (refill_outer,) item id of each row's first start
  float* acc;      // (rows, 3)
  int* cnt;        // (refill_outer, n / BLOCK) scratch
  const int* perm; // (outer, n) lane of the previous row (perm entry only)
  int* rank;       // (refill_outer, n) scratch (perm entry only)
  long long item_base;
  int n;
  int outer;
  int cadence;
  int refill_outer;
  float max_contribution;
};

// One recorded level of the clamp recursion, backwards: L = clamp?(emit ? V
// : V * L) for the record at flat index i.
__device__ __forceinline__ void level_step(const HarvestRowsArgs& a, size_t i,
                                           float& lr, float& lg, float& lb) {
  const int fl = __ldg(a.fl + i);
  const float vr = __ldg(a.vr + i), vg = __ldg(a.vg + i), vb = __ldg(a.vb + i);
  const bool emit = (fl & 2) != 0;
  // __fmul_rn keeps nvcc from fusing these products into the sum below,
  // so the kernel rounds exactly as the plain version does
  const float rr = emit ? vr : __fmul_rn(vr, lr);
  const float rg = emit ? vg : __fmul_rn(vg, lg);
  const float rb = emit ? vb : __fmul_rn(vb, lb);
  // NaN sums compare false and pass unclamped (Go parity)
  const float sum = rr + rg + rb;
  const float scale = ((fl & 1) != 0 && sum > a.max_contribution)
                          ? a.max_contribution / sum : 1.0f;
  lr = __fmul_rn(rr, scale);
  lg = __fmul_rn(rg, scale);
  lb = __fmul_rn(rb, scale);
}

// A started lane's finished L goes to its item's row, and its recursion
// starts again from zero.
__device__ __forceinline__ void write_start(const HarvestRowsArgs& a, int r,
                                            int rank, float& lr, float& lg,
                                            float& lb) {
  const long long row = (long long)__ldg(a.nis + r) - a.item_base + rank;
  float* dst = a.acc + row * 3;
  dst[0] = lr;
  dst[1] = lg;
  dst[2] = lb;
  lr = 0.0f;
  lg = 0.0f;
  lb = 0.0f;
}

// cnt[r, b] = started lanes of row r inside block b
__global__ void __launch_bounds__(BLOCK) count_starts(HarvestRowsArgs a) {
  const int r = blockIdx.y;
  const int lane = blockIdx.x * BLOCK + threadIdx.x;
  const int c = __syncthreads_count(a.sts[(size_t)r * a.n + lane] != 0);
  if (threadIdx.x == 0) a.cnt[(size_t)r * gridDim.x + blockIdx.x] = c;
}

// One block per row: cnt[r, :] becomes its exclusive prefix sum. Thread t
// owns a contiguous run of the row, so the order of the sum is fixed.
__global__ void __launch_bounds__(BLOCK) scan_counts(int* cnt, int nb) {
  __shared__ int part[BLOCK];
  int* row = cnt + (size_t)blockIdx.x * nb;
  const int per = (nb + BLOCK - 1) / BLOCK;
  const int lo = min((int)threadIdx.x * per, nb);
  const int hi = min(lo + per, nb);
  int sum = 0;
  for (int k = lo; k < hi; ++k) sum += row[k];
  part[threadIdx.x] = sum;
  __syncthreads();
  for (int off = 1; off < BLOCK; off <<= 1) {
    const int add = threadIdx.x >= off ? part[threadIdx.x - off] : 0;
    __syncthreads();
    part[threadIdx.x] += add;
    __syncthreads();
  }
  int run = part[threadIdx.x] - sum;
  for (int k = lo; k < hi; ++k) {
    const int c = row[k];
    row[k] = run;
    run += c;
  }
}

__global__ void __launch_bounds__(BLOCK) harvest_rows(HarvestRowsArgs a) {
  __shared__ int warp_starts[2][NWARP];
  const int nb = gridDim.x;
  const int lane = blockIdx.x * BLOCK + threadIdx.x;
  const int wid = threadIdx.x >> 5, lid = threadIdx.x & 31;
  float lr = 0.0f, lg = 0.0f, lb = 0.0f;
  for (int r = a.outer - 1; r >= 0; --r) {
    for (int j = a.cadence - 1; j >= 0; --j)
      level_step(a, ((size_t)r * a.cadence + j) * a.n + lane, lr, lg, lb);
    if (r < a.refill_outer) {
      // the whole block reaches this point for every refill row: rank the
      // row's starts (shared counts double-buffered by row parity, so one
      // barrier per row is enough)
      const bool started = __ldg(a.sts + (size_t)r * a.n + lane) != 0;
      const unsigned m = __ballot_sync(0xffffffffu, started);
      int* ws = warp_starts[r & 1];
      if (lid == 0) ws[wid] = __popc(m);
      __syncthreads();
      if (started) {
        int rank = __ldg(a.cnt + (size_t)r * nb + blockIdx.x) + __popc(m & ((1u << lid) - 1u));
        for (int w = 0; w < wid; ++w) rank += ws[w];
        write_start(a, r, rank, lr, lg, lb);
      }
    }
  }
}

// rank[r, lane] = the rank of the lane's start among row r's starts in flat
// lane order, -1 where the lane did not start
__global__ void __launch_bounds__(BLOCK) rank_starts(HarvestRowsArgs a) {
  __shared__ int warp_starts[NWARP];
  const int r = blockIdx.y;
  const int lane = blockIdx.x * BLOCK + threadIdx.x;
  const int wid = threadIdx.x >> 5, lid = threadIdx.x & 31;
  const size_t i = (size_t)r * a.n + lane;
  const bool started = a.sts[i] != 0;
  const unsigned m = __ballot_sync(0xffffffffu, started);
  if (lid == 0) warp_starts[wid] = __popc(m);
  __syncthreads();
  int rank = -1;
  if (started) {
    rank = a.cnt[(size_t)r * gridDim.x + blockIdx.x] + __popc(m & ((1u << lid) - 1u));
    for (int w = 0; w < wid; ++w) rank += warp_starts[w];
  }
  a.rank[i] = rank;
}

// One thread per lane timeline, followed backwards across the sorts.
__global__ void __launch_bounds__(BLOCK) harvest_rows_perm(HarvestRowsArgs a) {
  int p = blockIdx.x * BLOCK + threadIdx.x;
  float lr = 0.0f, lg = 0.0f, lb = 0.0f;
  for (int r = a.outer - 1; r >= 0; --r) {
    for (int j = a.cadence - 1; j >= 0; --j)
      level_step(a, ((size_t)r * a.cadence + j) * a.n + p, lr, lg, lb);
    if (r < a.refill_outer) {
      const int rank = __ldg(a.rank + (size_t)r * a.n + p);
      if (rank >= 0) write_start(a, r, rank, lr, lg, lb);
    }
    if (r > 0) p = __ldg(a.perm + (size_t)r * a.n + p);
  }
}

static int rank_rows(const HarvestRowsArgs& a, cudaStream_t s, bool ranks) {
  const int nb = a.n / BLOCK;
  if (a.refill_outer <= 0) return 0;
  count_starts<<<dim3(nb, a.refill_outer), BLOCK, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_counts<<<a.refill_outer, BLOCK, 0, s>>>(a.cnt, nb);
  err = cudaGetLastError();
  if (err != cudaSuccess || !ranks) return (int)err;
  rank_starts<<<dim3(nb, a.refill_outer), BLOCK, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int grt_harvest_rows_perm(const HarvestRowsArgs* args, void* stream) {
  const HarvestRowsArgs a = *args;
  cudaStream_t s = (cudaStream_t)stream;
  const int err = rank_rows(a, s, true);
  if (err) return err;
  harvest_rows_perm<<<a.n / BLOCK, BLOCK, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int grt_harvest_rows(const HarvestRowsArgs* args, void* stream) {
  const HarvestRowsArgs a = *args;
  cudaStream_t s = (cudaStream_t)stream;
  const int err = rank_rows(a, s, false);
  if (err) return err;
  harvest_rows<<<a.n / BLOCK, BLOCK, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* grt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
