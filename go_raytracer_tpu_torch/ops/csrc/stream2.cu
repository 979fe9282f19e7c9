// stream2_rows: the persistent binned mesh intersector, for Hopper (sm_90a).
// Replaces the Pallas TPU kernel `stream2_rows`
// (go_raytracer_tpu/ops/pallas/stream2.py, `_stream2_kernel`).
//
// One launch runs a level's whole closest-hit traversal. The work unit is
// UNIT = 32 consecutive lanes of the coherence-sorted pool, one warp lane
// per ray, which loops rounds until none of its lanes has a candidate
// cluster left:
//   1. scan: each lane finds its ray's lex-least (near, k) over the clusters
//      whose box its interval (T_MIN, t_best) hits and whose bit in the
//      unit's processed set is clear (the cl2 boxes, K2 <= 1024, sit in
//      shared memory; the arithmetic of ops/stream.candidates);
//   2. the unit's least pick a and greatest real pick (__reduce_min_sync,
//      __reduce_max_sync); the unit stops when no lane has a pick;
//   3. stream the groups of clusters [a, b], b = min(kmax, a + range_w - 1),
//      against every lane (mt_group of mt.cuh, in ascending group order),
//      staged through a per-warp ring of two stages of RING_GROUPS groups
//      filled with cp.async: the next stage lands while this one is tested;
//   4. mark [a, b] processed for the whole unit: every lane met every one of
//      those clusters, so the set is unit-uniform, 32 words, one register
//      per lane (lane m holds word m, read by the others with __shfl_sync),
//      and progress is strict (a leaves the set of picks).
// A unit runs on a team of TEAM warps that hold the same 32 rays: each warp
// scans every TEAM-th word of clusters and streams one contiguous slice of
// the round's groups, and the team merges per lane in shared memory at a
// named barrier of its own (no __syncthreads in the round loop). The merge
// is exact: the scan's partial picks combine as the lex-least (near, k);
// a later slice's best replaces the earlier's only when strictly smaller,
// which is what streaming the slices one after the other keeps. CTAs of
// NWARP warps are persistent (SMs x resident CTAs); each stages the cl2
// boxes once for its life, and each team pulls its next unit from a device
// counter, so a team that finishes a short unit takes another.
//
// The TPU kernel's block is 1024 lanes and its window 32 clusters, set for
// Mosaic's sequential grid; the unit, the team and the window change the
// rounds and the work a unit makes, not the winners: a lane's winner is the
// least t over the triangles, the first group reaching it in streaming
// order on a tie across groups. Built with -fmad=false: t equals the plain
// version's bit for bit.
//
// What bounds it: operations. A round costs each lane 12 float operations
// per clear cluster box and 8 Moller-Trumbore tests of 46 per streamed
// group; the bytes are the rays, t and idx once, the tables once (L2 holds
// them for the units after the first). With 65,536 lanes there are only
// 2,048 units, so the card holds every unit at once and the team is what
// puts more warps on each SM (ops/stream2.TEAM, chosen on the card).

#include "mt.cuh"

#define UNIT 32
#define NWARP 8
#define MAX_K2 1024
#define RING_GROUPS 4  // groups per stage of a warp's ring: 2 KB
#define RING_FLOATS (2 * RING_GROUPS * ENTRY_FLOATS)

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
  int* rounds;   // (n_units,) rounds each unit made
  int* counter;  // (1,) scratch: units handed out
  int n_units, k2, range_w, max_rounds, team;
};

// Groups [glo, ghi) of the table against this lane's ray, staged through
// the warp's ring `ring` (RING_FLOATS floats): each lane copies one 16-byte
// vector of each group (32 per group), the next stage lands while this one
// is tested.
__device__ __forceinline__ void stream_ring(const float* __restrict__ lines, int glo, int ghi,
                                            float* ring, int ln, float ox, float oy, float oz,
                                            float dx, float dy, float dz, float& t_best,
                                            int& idx) {
  auto issue = [&](int g0, float* dst) {
    const int ng = min(RING_GROUPS, ghi - g0);
    for (int k = 0; k < ng; ++k)
      cp_async16(dst + k * ENTRY_FLOATS + 4 * ln,
                 lines + packed_offset(g0 + k) + (size_t)(ln >> 2) * 128 + 4 * (ln & 3));
  };
  if (glo < ghi) issue(glo, ring);
  cp_async_commit();
  for (int g0 = glo, k = 0; g0 < ghi; g0 += RING_GROUPS, ++k) {
    float* cur = ring + (k & 1) * RING_GROUPS * ENTRY_FLOATS;
    if (g0 + RING_GROUPS < ghi)
      issue(g0 + RING_GROUPS, ring + ((k + 1) & 1) * RING_GROUPS * ENTRY_FLOATS);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const int ng = min(RING_GROUPS, ghi - g0);
    for (int j = 0; j < ng; ++j)
      mt_group(cur + j * ENTRY_FLOATS, 16, ox, oy, oz, dx, dy, dz, t_best, idx);
    __syncwarp();  // the stage is read before it is refilled
  }
  cp_async_wait<0>();
}

// Barrier of one team's TEAM * 32 threads (ids 1.., 0 is __syncthreads').
template <int TEAM>
__device__ __forceinline__ void team_sync(int team_id) {
  if (TEAM > 1) asm volatile("bar.sync %0, %1;\n" ::"r"(team_id + 1), "r"(TEAM * 32) : "memory");
}

template <int TEAM>
__global__ void __launch_bounds__(NWARP * 32) stream2_kernel(Stream2Args a) {
  // dynamic: the boxes (lo then hi, 3 * k2 floats each), then a ring per warp
  extern __shared__ __align__(16) float dyn[];
  __shared__ int s_unit[NWARP / TEAM];
  // per warp and lane, the partial results a team merges: the scan's
  // (near, pick) and the stream's (t, idx), in arrays of their own so that
  // each round needs two barriers
  __shared__ float s_near[NWARP][UNIT], s_t[NWARP][UNIT];
  __shared__ int s_pick[NWARP][UNIT], s_idx[NWARP][UNIT];
  const int tid = threadIdx.x, ln = tid & 31, warp = tid >> 5;
  const int tm = warp / TEAM, w = warp % TEAM, w0 = tm * TEAM;
  const int k2 = a.k2;
  float* box = dyn;
  float* my_ring = dyn + ((6 * k2 + 3) & ~3) + warp * RING_FLOATS;
  for (int i = tid; i < k2 * 3; i += NWARP * 32) {
    box[i] = a.lo[i];
    box[k2 * 3 + i] = a.hi[i];
  }
  __syncthreads();
  for (;;) {
    if (w == 0 && ln == 0) s_unit[tm] = atomicAdd(a.counter, 1);
    team_sync<TEAM>(tm);
    const int u = TEAM > 1 ? s_unit[tm] : __shfl_sync(0xffffffffu, s_unit[tm], 0);
    if (u >= a.n_units) break;  // team-uniform
    const int lane = u * UNIT + ln;
    const float ox = a.ox[lane], oy = a.oy[lane], oz = a.oz[lane];
    const float dx = a.dx[lane], dy = a.dy[lane], dz = a.dz[lane];
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    float t_best = a.t_in[lane];
    int idx = a.idx_in[lane];
    unsigned proc = 0u;  // word ln of the unit's processed set
    int round = 0;
    for (;;) {
      // ---- 1. this lane's pick, over every TEAM-th word of clusters ------
      float best_near = INFINITY;
      int pick = k2;
      for (int m = w; m * 32 < k2; m += TEAM) {
        const unsigned wd = __shfl_sync(0xffffffffu, proc, m);
        const int k_end = min(32, k2 - 32 * m);
        for (int j = 0; j < k_end; ++j) {
          if ((wd >> j) & 1u) continue;
          const int k = 32 * m + j;
          float near, far;
          slab(box[3 * k], box[3 * k + 1], box[3 * k + 2], box[k2 * 3 + 3 * k],
               box[k2 * 3 + 3 * k + 1], box[k2 * 3 + 3 * k + 2], ox, oy, oz, ix, iy, iz, near,
               far);
          near = fmaxf(near, T_MIN);
          if (near < fminf(far, t_best) && near < best_near) {
            best_near = near;
            pick = k;
          }
        }
      }
      if (TEAM > 1) {  // the lex-least (near, k) of the team's partial picks
        s_near[warp][ln] = best_near;
        s_pick[warp][ln] = pick;
        team_sync<TEAM>(tm);
        for (int v = 0; v < TEAM; ++v) {
          const float n = s_near[w0 + v][ln];
          const int k = s_pick[w0 + v][ln];
          if (n < best_near || (n == best_near && k < pick)) {
            best_near = n;
            pick = k;
          }
        }
      }
      // ---- 2. the unit's range -------------------------------------------
      const int ka = __reduce_min_sync(0xffffffffu, pick);
      const int kmax = __reduce_max_sync(0xffffffffu, pick < k2 ? pick : -1);
      if (kmax < 0 || round >= a.max_rounds) break;  // team-uniform
      const int kb = min(kmax, ka + a.range_w - 1);
      // ---- 3. stream clusters [ka, kb]: this warp's slice ------------------
      const int glo = __ldg(a.gs + ka), n_g = __ldg(a.gs + kb + 1) - glo;
      float t_w = t_best;
      int i_w = idx;
      stream_ring(a.lines, glo + n_g * w / TEAM, glo + n_g * (w + 1) / TEAM, my_ring, ln, ox, oy,
                  oz, dx, dy, dz, t_w, i_w);
      if (TEAM > 1) {  // slices in order: a later one replaces only if smaller
        s_t[warp][ln] = t_w;
        s_idx[warp][ln] = i_w;
        team_sync<TEAM>(tm);
        for (int v = 0; v < TEAM; ++v) {
          const float t = s_t[w0 + v][ln];
          if (t < t_best) {
            t_best = t;
            idx = s_idx[w0 + v][ln];
          }
        }
      } else {
        t_best = t_w;
        idx = i_w;
      }
      // ---- 4. mark them processed ----------------------------------------
      proc |= range_bits(min(max(ka - 32 * ln, 0), 32), min(max(kb + 1 - 32 * ln, 0), 32));
      ++round;
    }
    if (w == 0) {
      a.t_out[lane] = t_best;
      a.idx_out[lane] = idx;
      if (ln == 0) a.rounds[u] = round;
    }
  }
}

template <int TEAM>
static int launch(const Stream2Args& a, cudaStream_t st) {
  const size_t smem = (((size_t)6 * a.k2 + 3) & ~(size_t)3) * sizeof(float)
                      + (size_t)NWARP * RING_FLOATS * sizeof(float);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err)
    err = cudaFuncSetAttribute(stream2_kernel<TEAM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (!err)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stream2_kernel<TEAM>,
                                                        NWARP * 32, smem);
  if (!err) err = cudaMemsetAsync(a.counter, 0, sizeof(int), st);
  if (err) return (int)err;
  const int teams = NWARP / TEAM;
  const int grid = min(sms * max(per_sm, 1), (a.n_units + teams - 1) / teams);
  stream2_kernel<TEAM><<<grid, NWARP * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int grt_stream2_rows(const Stream2Args* args, void* stream) {
  const Stream2Args a = *args;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (a.team) {
    case 1: return launch<1>(a, st);
    case 2: return launch<2>(a, st);
    case 4: return launch<4>(a, st);
    case 8: return launch<8>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* grt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
