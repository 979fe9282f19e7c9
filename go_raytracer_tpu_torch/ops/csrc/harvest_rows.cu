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
// `rev_outer` with `reorder`): the lanes stay in place and the state moves.
// So does this entry. After `count_starts` and `scan_counts`, one
// cooperative launch walks the rows from outer - 1 down to 0. At each row
// every thread reads L for its position i from a state buffer (coalesced),
// runs the row's records at i (coalesced, as `harvest_rows` reads them),
// ranks the row's starts with the same block ballots as `harvest_rows`,
// and scatters L to the other state buffer at perm[r][i]; a grid-wide
// barrier (`grid.sync()`) then hands the buffer to row r - 1. Each perm[r]
// is a bijection, so every slot is written once a row. Following one lane
// timeline across the sorts instead would make every load after the first
// sort a 4-byte gather that depends on the previous row's perm load, and
// would break the block ballots (a moving lane has no block). The barrier
// replaces that chain of dependent gathers, and no rank plane is needed.
// The grid is as large as can be co-resident (a launch that cannot be
// fails, and the entry returns its error); its blocks walk the 256-lane
// tiles grid-stride, and L lives in no register across rows. What a row
// reads without L (its last level's records, perm, started flag, the
// tile's start count and the row's first item) is loaded for the block's
// first tile before the barrier, so that its latency hides behind it.
//
// What bounds it: bytes, the harvest's above plus 4 bytes per lane and
// outer row (perm). The state buffers (2 x n x 16 bytes, 4 MiB at 131072
// lanes) stay in L2; their 32 bytes per lane and row (read, scatter) are
// this design's traffic, not a byte the harvest needs, and neither is the
// barrier, which every row pays whatever its work. At cadence 1 a row is
// too little work to hide either: the barrier (~1.7 us with 512 blocks on
// an H100) and the 16-byte scatter to random slots, one L2 sector a lane,
// set its time, not its bytes (PERF.md, PR 18).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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
  float4* state;   // (2, n) L of each lane, scratch (perm entry only)
  long long item_base;
  int n;
  int outer;
  int cadence;
  int refill_outer;
  float max_contribution;
};

// One recorded level: V and its flag word (bit0 clamp, bit1 emit).
struct Level {
  float vr, vg, vb;
  int fl;
};

__device__ __forceinline__ Level load_level(const HarvestRowsArgs& a,
                                            size_t i) {
  return {__ldg(a.vr + i), __ldg(a.vg + i), __ldg(a.vb + i), __ldg(a.fl + i)};
}

// One recorded level of the clamp recursion, backwards: L = clamp?(emit ? V
// : V * L).
__device__ __forceinline__ void level_step(const HarvestRowsArgs& a,
                                           const Level& v, float& lr,
                                           float& lg, float& lb) {
  const bool emit = (v.fl & 2) != 0;
  // __fmul_rn keeps nvcc from fusing these products into the sum below,
  // so the kernel rounds exactly as the plain version does
  const float rr = emit ? v.vr : __fmul_rn(v.vr, lr);
  const float rg = emit ? v.vg : __fmul_rn(v.vg, lg);
  const float rb = emit ? v.vb : __fmul_rn(v.vb, lb);
  // NaN sums compare false and pass unclamped (Go parity)
  const float sum = rr + rg + rb;
  const float scale = ((v.fl & 1) != 0 && sum > a.max_contribution)
                          ? a.max_contribution / sum : 1.0f;
  lr = __fmul_rn(rr, scale);
  lg = __fmul_rn(rg, scale);
  lb = __fmul_rn(rb, scale);
}

// The rank of a start among the starts of its 256-lane tile in flat lane
// order: those of the warps before it (shared counts) and of the lanes
// before it in its warp (ballot). Every thread of the block calls it; `ws`
// must alternate between two buffers on successive calls, so that one
// barrier a call is enough.
__device__ __forceinline__ int tile_rank(bool started, int* ws) {
  const int wid = threadIdx.x >> 5, lid = threadIdx.x & 31;
  const unsigned m = __ballot_sync(0xffffffffu, started);
  if (lid == 0) ws[wid] = __popc(m);
  __syncthreads();
  int rank = __popc(m & ((1u << lid) - 1u));
  for (int w = 0; w < wid; ++w) rank += ws[w];
  return rank;
}

// A started lane's finished L goes to acc row `slot` (its item less
// item_base), and its recursion starts again from zero.
__device__ __forceinline__ void write_start(const HarvestRowsArgs& a,
                                            long long slot, float& lr,
                                            float& lg, float& lb) {
  float* dst = a.acc + slot * 3;
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
  float lr = 0.0f, lg = 0.0f, lb = 0.0f;
  for (int r = a.outer - 1; r >= 0; --r) {
    for (int j = a.cadence - 1; j >= 0; --j)
      level_step(a, load_level(a, ((size_t)r * a.cadence + j) * a.n + lane),
                 lr, lg, lb);
    if (r < a.refill_outer) {
      // the whole block reaches this point for every refill row (shared
      // counts double-buffered by row parity)
      const bool started = __ldg(a.sts + (size_t)r * a.n + lane) != 0;
      const int rank = tile_rank(started, warp_starts[r & 1]);
      if (started)
        write_start(a, (long long)__ldg(a.nis + r) - a.item_base
                           + __ldg(a.cnt + (size_t)r * nb + blockIdx.x) + rank,
                    lr, lg, lb);
    }
  }
}

// What a (row, tile) step of `harvest_rows_perm` reads that does not depend
// on L: the row's last recorded level (the first one the step runs), the
// lane that the position held a row before, the started flag, and the acc
// slot of the tile's first start (the row's first item less item_base,
// plus the starts of the tiles before it).
struct RowIn {
  Level last;
  int perm;
  bool started;
  long long slot0;
};

__device__ __forceinline__ RowIn row_in(const HarvestRowsArgs& a, int r,
                                        int tile) {
  const int i = tile * BLOCK + threadIdx.x;
  const bool refill = r < a.refill_outer;
  RowIn w;
  w.last = load_level(a, ((size_t)r * a.cadence + a.cadence - 1) * a.n + i);
  w.perm = r > 0 ? __ldg(a.perm + (size_t)r * a.n + i) : 0;
  w.started = refill && __ldg(a.sts + (size_t)r * a.n + i) != 0;
  w.slot0 = refill ? (long long)__ldg(a.nis + r) - a.item_base
                         + __ldg(a.cnt + (size_t)r * (a.n / BLOCK) + tile)
                   : 0;
  return w;
}

// The lanes stay in place; L moves through the state buffers, one grid-wide
// barrier a row. Row r reads buffer r & 1 and writes the other one. The
// loads of the block's first tile of row r - 1 that do not depend on L go
// out before the barrier, so that their latency hides behind it.
__global__ void __launch_bounds__(BLOCK) harvest_rows_perm(HarvestRowsArgs a) {
  __shared__ int warp_starts[2][NWARP];
  cg::grid_group grid = cg::this_grid();
  const int tiles = a.n / BLOCK;
  const int first = blockIdx.x;
  RowIn w = row_in(a, a.outer - 1, first);
  int k = 0;  // (row, tile) steps of this block: picks the shared buffer
  for (int r = a.outer - 1; r >= 0; --r) {
    const float4* cur = a.state + (size_t)(r & 1) * a.n;
    float4* prev = a.state + (size_t)((r + 1) & 1) * a.n;
    for (int tile = first; tile < tiles; tile += gridDim.x, ++k) {
      const int i = tile * BLOCK + threadIdx.x;
      if (tile != first) w = row_in(a, r, tile);
      float lr = 0.0f, lg = 0.0f, lb = 0.0f;
      if (r < a.outer - 1) {
        // written by other blocks in this launch: through L2, not the
        // read-only or L1 path
        const float4 l = __ldcg(cur + i);
        lr = l.x;
        lg = l.y;
        lb = l.z;
      }
      level_step(a, w.last, lr, lg, lb);
      for (int j = a.cadence - 2; j >= 0; --j)
        level_step(a, load_level(a, ((size_t)r * a.cadence + j) * a.n + i),
                   lr, lg, lb);
      if (r < a.refill_outer) {
        const int rank = tile_rank(w.started, warp_starts[k & 1]);
        if (w.started) write_start(a, w.slot0 + rank, lr, lg, lb);
      }
      if (r > 0) __stcg(prev + w.perm, make_float4(lr, lg, lb, 0.0f));
    }
    if (r > 0) {
      w = row_in(a, r - 1, first);
      grid.sync();
    }
  }
}

// The cooperative grid of `harvest_rows_perm`: as many blocks as can be
// resident on the card at once, at most one a tile.
static int perm_grid(int n, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, harvest_rows_perm, BLOCK, 0);
  *blocks = min(per_sm * sms, n / BLOCK);
  return (int)err;
}

static int rank_rows(const HarvestRowsArgs& a, cudaStream_t s) {
  const int nb = a.n / BLOCK;
  if (a.refill_outer <= 0) return 0;
  count_starts<<<dim3(nb, a.refill_outer), BLOCK, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_counts<<<a.refill_outer, BLOCK, 0, s>>>(a.cnt, nb);
  return (int)cudaGetLastError();
}

extern "C" int grt_harvest_rows_perm(const HarvestRowsArgs* args, void* stream) {
  HarvestRowsArgs a = *args;
  cudaStream_t s = (cudaStream_t)stream;
  int blocks;
  int err = perm_grid(a.n, &blocks);
  if (!err) err = rank_rows(a, s);
  if (err) return err;
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)harvest_rows_perm,
                                          dim3(blocks), dim3(BLOCK), params,
                                          0, s);
}

extern "C" int grt_harvest_rows(const HarvestRowsArgs* args, void* stream) {
  const HarvestRowsArgs a = *args;
  cudaStream_t s = (cudaStream_t)stream;
  const int err = rank_rows(a, s);
  if (err) return err;
  harvest_rows<<<a.n / BLOCK, BLOCK, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* grt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
