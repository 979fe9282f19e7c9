// bounce_fused_q: the in-kernel-queue bounce levels of the regen main path,
// for Hopper (sm_90a). Replaces the Pallas TPU kernel `bounce_fused_q`
// (go_raytracer_tpu/ops/pallas/bounce.py, `_fused_q_kernel`).
//
// One thread per lane, state as SoA planes. Each bounce level is one launch
// of `fused_q_level`; a call of `grt_bounce_fused_q` runs `n_inner` levels
// after one `count_dead` launch.
//
// The queue refill. The TPU kernel walks lane tiles in order and carries the
// queue cursor across them, so a level assigns
//     item(lane) = cursor_at_level_start + exclusive rank of lane among the
//                  dead lanes in flat lane order,
// and a dead lane starts that item if item < item_end and the window still
// refills at this level. Blocks on the GPU run in no order, so each level
// gets the rank from a scan instead: every block reads the per-block dead
// counts that the previous launch wrote (N/256 ints, double-buffered),
// sums those before its own, and ranks inside the block with warp ballots.
// Block 0 writes the level's take count, alive count and base, and the next
// cursor. No grid-wide sync is needed: the launch boundary orders levels.
//
// The started lane's rank within its level rides in the flag word (bits
// 3..), so the harvest kernel writes each path's radiance straight to its
// item slot with no scan and no extra plane.
//
// What bounds it: per lane and level it reads and writes the 36-byte state
// and writes a 16-byte record (about 88 bytes), and does a few hundred
// float operations per segment on cornellBox (6 quads, 2 rotated slab
// boxes, the light sample and the pdf), ~12,000 on book1 (389 sphere
// tests). Both bounds are microseconds at 131072 lanes; what it pays on
// this card is the launch per level, the divergence between lanes that
// hit different materials, and on a large table the issue of the scan's
// loads: every lane of a warp reads the same row at once. So each block
// stages the scan table in shared memory before its first branch on the
// lane (`stage_geometry`, bounce_core.cuh), and the scan reads a row with
// two or three broadcast `LDS.128`; with more than one block of 8 rows in
// a section the variant with the cull skips the blocks a ray cannot meet.
//
// `grt_bounce_fused_q_direct` replaces the Pallas TPU kernel
// `bounce_fused_q_direct` (the same file, `_fused_q_kernel_direct`): the same
// launches, but level j's records land in whole-window buffers (rec_levels,
// n) at row lvl_base[0] + j, the base read on the device from a (1,) int32
// tensor, so the host loop passes the whole buffers and a device base instead
// of slicing them per call; a row past rec_levels is not written. Every other
// row keeps its contents. What bounds it is K1's. It refuses the image
// variant (feature bit 5), as the JAX package's direct-record path excludes
// scenes with image textures.
//
// The bounce itself (closest hit, media, shading, sampling) is `bounce_core`
// in bounce_core.cuh, shared with bounce.cu; its precision note applies
// here. `fused_q_level` is compiled once per feature set of the core
// (spheres, the fr column with dielectric, media with isotropic, textures,
// the cull, the image texel) and the entry points launch the scene's variant with
// the staged geometry's dynamic shared memory. Level j draws its uniforms from
// PRNG slots j * (N_U_RAYGEN + N_U + n_media) on: five for the camera ray,
// nine for the bounce, one per medium, as the TPU kernel does. The PRNG and
// the camera ray generation are fused_common.cuh's, shared with
// bounce_fused.cu and bounce_fused_pos.cu.

#include "fused_common.cuh"

struct FusedQArgs {
  const float* prims;
  const float* lights;
  const float* med;
  const float* cam;
  const float* bg;
  const int* seed4;  // [seed, refill levels remaining, cursor, item_end]
  const float *ox_in, *oy_in, *oz_in, *dx_in, *dy_in, *dz_in, *tm_in;
  const int *alive_in, *depth_in;
  float *ox, *oy, *oz, *dx, *dy, *dz, *tm;
  int *alive, *depth;
  float *vr, *vg, *vb;  // (n_inner, n)
  int* fl;              // (n_inner, n)
  int *seg, *take, *base;  // (n_inner,)
  int* cursor_out;         // (1,)
  int* dead_cnt;           // (2, n / BLOCK) scratch
  int* cur_buf;            // (2,) scratch
  const int* lvl_base;     // (1,) record row of level 0; null: row j
  FUSED_TABLE_FIELDS
  int n, n_inner, max_depth, width, sqrt_spp, npix;
  int rec_levels;  // rows of the record buffers
};

__device__ __forceinline__ int block_sum(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[w] = v;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int k = 0; k < NWARP; ++k) t += red[k];
  return t;
}

__global__ void __launch_bounds__(BLOCK)
count_dead(const int* __restrict__ alive, int* __restrict__ dead_cnt) {
  __shared__ int red[NWARP];
  const int lane = blockIdx.x * BLOCK + threadIdx.x;
  const int c = block_sum(alive[lane] == 0 ? 1 : 0, red);
  if (threadIdx.x == 0) dead_cnt[blockIdx.x] = c;
}

template <bool SPH, bool DIEL, bool MED, bool TEX, bool CULL, bool IMG>
__global__ void __launch_bounds__(BLOCK, 4)
fused_q_level(FusedQArgs a, int j) {
  __shared__ int red[NWARP];
  __shared__ int red2[NWARP];
  __shared__ int warp_dead[NWARP];
  // the geometry into shared memory, before any branch on the lane
  const BounceTables T = fused_tables<SPH, DIEL, MED, TEX, IMG>(a);
  stage_geometry(T);
  const int nb = gridDim.x;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int* __restrict__ dcnt_in = a.dead_cnt + (j & 1) * nb;
  int* __restrict__ dcnt_out = a.dead_cnt + ((j + 1) & 1) * nb;

  // ---- dead lanes before this block, and in total -----------------------
  int before = 0, total = 0;
  for (int k = tid; k < nb; k += BLOCK) {
    const int c = dcnt_in[k];
    total += c;
    before += k < b ? c : 0;
  }
  before = block_sum(before, red);
  total = block_sum(total, red2);

  const int cursor = j == 0 ? a.seed4[2] : a.cur_buf[j & 1];
  const bool refilling = a.seed4[1] > j;
  const int item_end = a.seed4[3];
  if (b == 0 && tid == 0) {
    long long room = (long long)item_end - cursor;
    room = room < 0 ? 0 : room;
    const int nt = refilling ? (int)(total < room ? total : room) : 0;
    a.take[j] = nt;
    a.seg[j] = (a.n - total) + nt;
    a.base[j] = cursor;
    if (j == a.n_inner - 1)
      a.cursor_out[0] = cursor + nt;
    else
      a.cur_buf[(j + 1) & 1] = cursor + nt;
  }

  // ---- lane state, and its rank among the dead lanes --------------------
  const int lane = b * BLOCK + tid;
  float ox = a.ox_in[lane], oy = a.oy_in[lane], oz = a.oz_in[lane];
  float dx = a.dx_in[lane], dy = a.dy_in[lane], dz = a.dz_in[lane];
  float tm = a.tm_in[lane];
  bool alive = a.alive_in[lane] != 0;
  int depth = a.depth_in[lane];

  const unsigned m = __ballot_sync(0xffffffffu, !alive);
  const int wid = tid >> 5, lid = tid & 31;
  if (lid == 0) warp_dead[wid] = __popc(m);
  __syncthreads();
  int rank = before + __popc(m & ((1u << lid) - 1u));
  for (int w = 0; w < wid; ++w) rank += warp_dead[w];
  const long long item = (long long)cursor + rank;
  const bool take = !alive && refilling && item < item_end;

  const uint32_t seed_mix = (uint32_t)a.seed4[0] * 0x9E3779B9u;
  const uint32_t slot0 = (uint32_t)j * (N_U_RAYGEN + N_U + (uint32_t)a.n_media);
  const uint32_t ulane = (uint32_t)lane;
  const float* __restrict__ cam = a.cam;

  // ---- camera ray generation (camera.go:256-270) for started lanes -------
  if (take) {
    const int it = (int)item;
    const int stratum = it / a.npix;
    const int pixel = it - stratum * a.npix;
    const int pj = pixel / a.width;
    const int pi = pixel - pj * a.width;
    const int si = stratum / a.sqrt_spp;
    const int sj = stratum - si * a.sqrt_spp;
    camera_ray(cam, (float)pi, (float)pj, (float)si, (float)sj, ulane, seed_mix, slot0,
               a.defocus != 0, ox, oy, oz, dx, dy, dz);
    tm = u01(ulane, seed_mix, slot0 + 4);
    alive = true;
    depth = 0;
  }

  float vr = 0.0f, vg = 0.0f, vb = 0.0f;
  bool emit = false, cf = false, alive_out = false;
  if (alive) {
    float u[N_U];
#pragma unroll
    for (int k = 0; k < N_U; ++k) u[k] = u01(ulane, seed_mix, slot0 + N_U_RAYGEN + k);
    const HashMediaU um{ulane, seed_mix, slot0 + N_U_RAYGEN};
    const BounceResult r =
        bounce_core<SPH, DIEL, MED, TEX, CULL, IMG>(T, ox, oy, oz, dx, dy, dz, tm, u, nullptr, um);
    vr = r.vr;
    vg = r.vg;
    vb = r.vb;
    emit = r.emit;
    cf = r.cf;
    alive_out = r.alive;
    ox = r.ox;
    oy = r.oy;
    oz = r.oz;
    dx = r.dx;
    dy = r.dy;
    dz = r.dz;
  }

  // ---- records: merged V plane + flag bits -------------------------------
  const int row = (a.lvl_base ? a.lvl_base[0] : 0) + j;
  if (row >= 0 && row < a.rec_levels) {
    const size_t r = (size_t)row * a.n + lane;
    a.vr[r] = vr;
    a.vg[r] = vg;
    a.vb[r] = vb;
    a.fl[r] = (cf ? 1 : 0) | (emit ? 2 : 0) | (take ? 4 | ((int)(item - cursor) << 3) : 0);
  }

  // depth cap (camera.go:293-296): a path gets exactly max_depth + 1 levels
  alive_out = alive_out && depth < a.max_depth;
  if (alive) depth += 1;
  a.ox[lane] = ox;
  a.oy[lane] = oy;
  a.oz[lane] = oz;
  a.dx[lane] = dx;
  a.dy[lane] = dy;
  a.dz[lane] = dz;
  a.tm[lane] = tm;
  a.alive[lane] = alive_out ? 1 : 0;
  a.depth[lane] = depth;

  const int dead_next = block_sum(alive_out ? 0 : 1, red);
  if (tid == 0) dcnt_out[b] = dead_next;
}

static int run_levels(FusedQArgs a, cudaStream_t s) {
  const int nb = a.n / BLOCK;
  const int smem = fused_stage_bytes(a.feat, a.n_sph, a.n_quad, a.n_box);
  const int feat = with_cull(a.feat, a.n_sph, a.n_quad, a.n_box);
  count_dead<<<nb, BLOCK, 0, s>>>(a.alive_in, a.dead_cnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int j = 0; j < a.n_inner; ++j) {
#define LAUNCH_LEVEL(S, D, M, X, C, I)                                                 \
  if ((err = allow_smem((const void*)fused_q_level<S, D, M, X, C, I>, smem)) == cudaSuccess) \
  fused_q_level<S, D, M, X, C, I><<<nb, BLOCK, smem, s>>>(a, j)
    FEATURE_SWITCH(feat, LAUNCH_LEVEL)
#undef LAUNCH_LEVEL
    if (err != cudaSuccess) return (int)err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // later levels read the state this level wrote
    a.ox_in = a.ox;
    a.oy_in = a.oy;
    a.oz_in = a.oz;
    a.dx_in = a.dx;
    a.dy_in = a.dy;
    a.dz_in = a.dz;
    a.tm_in = a.tm;
    a.alive_in = a.alive;
    a.depth_in = a.depth;
  }
  return 0;
}

extern "C" int grt_bounce_fused_q(const FusedQArgs* args, void* stream) {
  FusedQArgs a = *args;
  a.lvl_base = nullptr;
  a.rec_levels = a.n_inner;
  return run_levels(a, (cudaStream_t)stream);
}

extern "C" int grt_bounce_fused_q_direct(const FusedQArgs* args, void* stream) {
  if (args->lvl_base == nullptr || (args->feat & FEAT_IMG)) return (int)cudaErrorInvalidValue;
  return run_levels(*args, (cudaStream_t)stream);
}

// Registers, dynamic and static shared bytes, resident blocks per SM and
// spill bytes of the level kernel for feature bits `feat` on a table of
// these section sizes (kernel_info's `out`).
extern "C" int grt_kernel_info(int feat, int n_sph, int n_quad, int n_box, int* out) {
  const int smem = fused_stage_bytes(feat, n_sph, n_quad, n_box);
  int err = 0;
#define INFO(S, D, M, X, C, I) err = kernel_info((const void*)fused_q_level<S, D, M, X, C, I>, BLOCK, smem, out)
  FEATURE_SWITCH(with_cull(feat, n_sph, n_quad, n_box), INFO)
#undef INFO
  return err;
}

extern "C" const char* grt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
