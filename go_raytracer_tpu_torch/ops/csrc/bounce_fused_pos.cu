// bounce_fused_pos: `n_inner` bounce levels of the regen `positional`
// schedule, with the per-lane refill at every level, for Hopper (sm_90a).
// Replaces the Pallas TPU kernel `bounce_fused_pos`
// (go_raytracer_tpu/ops/pallas/bounce.py, `_fused_pos_kernel`).
//
// Every lane owns a contiguous block of the pixel-major item index and
// carries its next item as five float32 planes holding exact small
// integers: pixel column and row (pi, pj), stratum row and column (si, sj)
// and the count of items it has left (rem). A dead lane with rem > 0 starts
// its next item at any level j < seed2[1] (the refill levels the window
// has left), so the take is a per-lane test and, as in bounce_fused.cu, one
// thread runs all levels of its lane in ONE launch with the ray in
// registers.
//
// Per level: the started flag is recorded BEFORE the bounce; a taken lane
// gets its camera ray from fresh PRNG slots (level j draws slots kj ..
// kj + k - 1, k = 14 + n_media: five for the ray generation, nine for the
// bounce, one per medium) and advances
// its item pointer by the TPU kernel's compare-and-select chain (sj, then
// si, then pi, then pj, against sqrt_spp - 0.5 and width - 0.5), in the same
// order, so the planes stay exact integers and equal the reference's; then
// one bounce, the UNMERGED records (emission E and weight W apart, the
// clamp flag, the started flag) and the depth cap. The window's reverse scan
// retreats the pointer with the inverse chain to find each path's pixel.
//
// The per-level segment count is one `__syncthreads_count` per level and
// block plus an integer atomic on seg[j] (zeroed by the entry point).
//
// What bounds it: bytes, nominally. Per lane it reads and writes the
// 56-byte state and writes a 32-byte record per level (368 bytes at 8
// levels), against a few hundred float operations per alive lane and
// level; both bounds are microseconds at 131072 lanes, and what it pays is
// divergence and the dependent chain of levels inside one thread.
//
// The bounce itself is `bounce_core` (bounce_core.cuh), whose precision note
// applies here, compiled once per feature set of the scene (fused_common.cuh's
// FEATURE_SWITCH picks the variant; an image scene's reads its texels); its staged scan reads the geometry
// that each block copies into shared memory once for all its levels. The
// PRNG and the ray generation are fused_common.cuh's.

#include "fused_common.cuh"

struct FusedPosArgs {
  const float* prims;
  const float* lights;
  const float* med;
  const float* cam;
  const float* bg;
  const int* seed2;  // [seed, refill levels remaining]
  const float *ox_in, *oy_in, *oz_in, *dx_in, *dy_in, *dz_in, *tm_in;
  const int *alive_in, *depth_in;
  const float *pi_in, *pj_in, *si_in, *sj_in, *rem_in;
  float *ox, *oy, *oz, *dx, *dy, *dz, *tm;
  int *alive, *depth;
  float *pi, *pj, *si, *sj, *rem;
  float *er, *eg, *eb, *wr, *wg, *wb;  // (n_inner, n)
  int *cf, *st;                        // (n_inner, n)
  int* seg;                            // (n_inner,)
  FUSED_TABLE_FIELDS
  int n, n_inner, max_depth, width, sqrt_spp;
};

template <bool SPH, bool DIEL, bool MED, bool TEX, bool CULL, bool IMG>
__global__ void __launch_bounds__(BLOCK, 4) bounce_fused_pos_levels(FusedPosArgs a) {
  const int lane = blockIdx.x * BLOCK + threadIdx.x;
  float ox = a.ox_in[lane], oy = a.oy_in[lane], oz = a.oz_in[lane];
  float dx = a.dx_in[lane], dy = a.dy_in[lane], dz = a.dz_in[lane];
  float tm = a.tm_in[lane];
  bool alive = a.alive_in[lane] != 0;
  int depth = a.depth_in[lane];
  float pi = a.pi_in[lane], pj = a.pj_in[lane];
  float si = a.si_in[lane], sj = a.sj_in[lane];
  float rem = a.rem_in[lane];
  // the geometry into shared memory once for all levels, before any branch
  // on the lane (the lane's loads above are in flight meanwhile)
  const BounceTables T = fused_tables<SPH, DIEL, MED, TEX, IMG>(a);
  stage_geometry(T);

  const uint32_t seed_mix = (uint32_t)a.seed2[0] * 0x9E3779B9u;
  const int refill_rem = a.seed2[1];
  const uint32_t ulane = (uint32_t)lane;
  const float s_wrap = (float)a.sqrt_spp - 0.5f;
  const float p_wrap = (float)a.width - 0.5f;

  const uint32_t slots = N_U_RAYGEN + N_U + (uint32_t)a.n_media;
  for (int j = 0; j < a.n_inner; ++j) {
    const uint32_t slot0 = (uint32_t)j * slots;
    const size_t rec = (size_t)j * a.n + lane;
    // ---- per-level refill: dead, items left, inside the refill span -------
    const bool take = !alive && rem > 0.5f && refill_rem > j;
    a.st[rec] = take ? 1 : 0;
    if (take) {
      camera_ray(a.cam, pi, pj, si, sj, ulane, seed_mix, slot0, a.defocus != 0, ox, oy, oz,
                 dx, dy, dz);
      tm = u01(ulane, seed_mix, slot0 + 4);
      alive = true;
      depth = 0;
      // advance the item pointer (pixel-major: sj fastest, then si, then the
      // pixel column pi, then the pixel row pj), by exact float carries
      float sj_n = sj + 1.0f;
      const bool wrap_s = sj_n > s_wrap;
      sj_n = wrap_s ? 0.0f : sj_n;
      float si_n = si + (wrap_s ? 1.0f : 0.0f);
      const bool wrap_i = si_n > s_wrap;
      si_n = wrap_i ? 0.0f : si_n;
      const bool adv_p = wrap_s && wrap_i;
      float pi_n = pi + (adv_p ? 1.0f : 0.0f);
      const bool wrap_p = pi_n > p_wrap;
      pi_n = wrap_p ? 0.0f : pi_n;
      const float pj_n = pj + (wrap_p ? 1.0f : 0.0f);
      pi = pi_n;
      pj = pj_n;
      si = si_n;
      sj = sj_n;
      rem = rem - 1.0f;
    }

    const int n_alive = __syncthreads_count(alive);
    if (threadIdx.x == 0 && n_alive > 0) atomicAdd(a.seg + j, n_alive);

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
    a.er[rec] = emit ? vr : 0.0f;
    a.eg[rec] = emit ? vg : 0.0f;
    a.eb[rec] = emit ? vb : 0.0f;
    a.wr[rec] = emit ? 0.0f : vr;
    a.wg[rec] = emit ? 0.0f : vg;
    a.wb[rec] = emit ? 0.0f : vb;
    a.cf[rec] = cf ? 1 : 0;

    // depth cap (camera.go:293-296): a path gets exactly max_depth + 1 levels
    alive_out = alive_out && depth < a.max_depth;
    if (alive) depth += 1;
    alive = alive_out;
  }
  a.ox[lane] = ox;
  a.oy[lane] = oy;
  a.oz[lane] = oz;
  a.dx[lane] = dx;
  a.dy[lane] = dy;
  a.dz[lane] = dz;
  a.tm[lane] = tm;
  a.alive[lane] = alive ? 1 : 0;
  a.depth[lane] = depth;
  a.pi[lane] = pi;
  a.pj[lane] = pj;
  a.si[lane] = si;
  a.sj[lane] = sj;
  a.rem[lane] = rem;
}

extern "C" int grt_bounce_fused_pos(const FusedPosArgs* args, void* stream) {
  const FusedPosArgs a = *args;
  cudaStream_t s = (cudaStream_t)stream;
  const int smem = fused_stage_bytes(a.feat, a.n_sph, a.n_quad, a.n_box);
  cudaError_t err = cudaMemsetAsync(a.seg, 0, sizeof(int) * a.n_inner, s);
  if (err != cudaSuccess) return (int)err;
#define LAUNCH_LEVELS(S, D, M, X, C, I)                                                          \
  if ((err = allow_smem((const void*)bounce_fused_pos_levels<S, D, M, X, C, I>, smem)) == cudaSuccess) \
  bounce_fused_pos_levels<S, D, M, X, C, I><<<a.n / BLOCK, BLOCK, smem, s>>>(a)
  FEATURE_SWITCH(with_cull(a.feat, a.n_sph, a.n_quad, a.n_box), LAUNCH_LEVELS)
#undef LAUNCH_LEVELS
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// kernel_info of the variant for feature bits `feat` on a table of these
// section sizes
extern "C" int grt_kernel_info(int feat, int n_sph, int n_quad, int n_box, int* out) {
  const int smem = fused_stage_bytes(feat, n_sph, n_quad, n_box);
  int err = 0;
#define INFO(S, D, M, X, C, I) \
  err = kernel_info((const void*)bounce_fused_pos_levels<S, D, M, X, C, I>, BLOCK, smem, out)
  FEATURE_SWITCH(with_cull(feat, n_sph, n_quad, n_box), INFO)
#undef INFO
  return err;
}

extern "C" const char* grt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
