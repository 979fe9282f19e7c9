// bounce_fused: `n_inner` bounce levels of the regen `queue` schedule, the
// refill decided by the caller, for Hopper (sm_90a). Replaces the Pallas
// TPU kernel `bounce_fused` (go_raytracer_tpu/ops/pallas/bounce.py,
// `_fused_kernel`).
//
// One thread per lane, state as SoA planes, all levels in ONE launch: the
// caller hands in which lanes start a path (`take`) and their pixel and
// stratum (`pi, pj, si, sj`, from its cumulative sum over the dead lanes),
// so no lane depends on another and a thread keeps its lane's ray in
// registers from the first level to the last. Level 0 blends the camera
// ray into the taken lanes; every level then runs one bounce, writes the
// merged V plane and the flag word (bit0 firefly clamp, bit1 emit) and
// applies the depth cap.
//
// The PRNG slots are the TPU kernel's: the ray generation draws slots 0-4
// once per call, level j draws slots 5 + kj .. 5 + kj + k - 1 with k = 9 +
// n_media (nine for the bounce, one per medium).
//
// The per-level segment count is the number of lanes alive before the
// level's bounce: one `__syncthreads_count` per level and block, added to
// seg[j] with an integer atomic (the entry point zeroes seg first), so the
// result does not depend on the order the blocks run in.
//
// What bounds it: bytes, nominally. Per lane it reads the 36-byte state and
// the 20-byte refill planes, writes the state back and a 16-byte record per
// level (220 bytes at 8 levels), against a few hundred float operations per
// alive lane and level; both bounds are microseconds at 131072 lanes. What
// it pays on this card is the divergence between lanes that hit different
// materials and the dependent chain of levels inside one thread.
//
// The bounce itself is `bounce_core` (bounce_core.cuh), whose precision note
// applies here, compiled once per feature set of the scene (fused_common.cuh's
// FEATURE_SWITCH picks the variant; an image scene's reads its texels); its staged scan reads the geometry
// that each block copies into shared memory once for all its levels. The
// PRNG and the ray generation are fused_common.cuh's.

#include "fused_common.cuh"

struct FusedArgs {
  const float* prims;
  const float* lights;
  const float* med;
  const float* cam;
  const float* bg;
  const int* seed;  // (1,)
  const float *ox_in, *oy_in, *oz_in, *dx_in, *dy_in, *dz_in, *tm_in;
  const int *alive_in, *depth_in;
  const int* take;                 // (n,) lanes that start a path
  const float *pi, *pj, *si, *sj;  // (n,) their pixel and stratum
  float *ox, *oy, *oz, *dx, *dy, *dz, *tm;
  int *alive, *depth;
  float *vr, *vg, *vb;  // (n_inner, n)
  int* fl;              // (n_inner, n)
  int* seg;             // (n_inner,)
  FUSED_TABLE_FIELDS
  int n, n_inner, max_depth;
};

template <bool SPH, bool DIEL, bool MED, bool TEX, bool CULL, bool IMG>
__global__ void __launch_bounds__(BLOCK, 4) bounce_fused_levels(FusedArgs a) {
  const int lane = blockIdx.x * BLOCK + threadIdx.x;
  float ox = a.ox_in[lane], oy = a.oy_in[lane], oz = a.oz_in[lane];
  float dx = a.dx_in[lane], dy = a.dy_in[lane], dz = a.dz_in[lane];
  float tm = a.tm_in[lane];
  bool alive = a.alive_in[lane] != 0;
  int depth = a.depth_in[lane];
  // the geometry into shared memory once for all levels, before any branch
  // on the lane (the lane's loads above are in flight meanwhile)
  const BounceTables T = fused_tables<SPH, DIEL, MED, TEX, IMG>(a);
  stage_geometry(T);

  const uint32_t seed_mix = (uint32_t)a.seed[0] * 0x9E3779B9u;
  const uint32_t ulane = (uint32_t)lane;

  // ---- camera ray generation for the lanes that start a path --------------
  if (a.take[lane] > 0) {
    camera_ray(a.cam, a.pi[lane], a.pj[lane], a.si[lane], a.sj[lane], ulane, seed_mix, 0,
               a.defocus != 0, ox, oy, oz, dx, dy, dz);
    tm = u01(ulane, seed_mix, 4);
    alive = true;
    depth = 0;
  }

  const uint32_t n_u = N_U + (uint32_t)a.n_media;
  for (int j = 0; j < a.n_inner; ++j) {
    const int n_alive = __syncthreads_count(alive);
    if (threadIdx.x == 0 && n_alive > 0) atomicAdd(a.seg + j, n_alive);

    float vr = 0.0f, vg = 0.0f, vb = 0.0f;
    bool emit = false, cf = false, alive_out = false;
    if (alive) {
      const uint32_t slot0 = N_U_RAYGEN + (uint32_t)j * n_u;
      float u[N_U];
#pragma unroll
      for (int k = 0; k < N_U; ++k) u[k] = u01(ulane, seed_mix, slot0 + k);
      const HashMediaU um{ulane, seed_mix, slot0};
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
    const size_t rec = (size_t)j * a.n + lane;
    a.vr[rec] = vr;
    a.vg[rec] = vg;
    a.vb[rec] = vb;
    a.fl[rec] = (cf ? 1 : 0) | (emit ? 2 : 0);

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
}

extern "C" int grt_bounce_fused(const FusedArgs* args, void* stream) {
  const FusedArgs a = *args;
  cudaStream_t s = (cudaStream_t)stream;
  const int smem = fused_stage_bytes(a.feat, a.n_sph, a.n_quad, a.n_box);
  cudaError_t err = cudaMemsetAsync(a.seg, 0, sizeof(int) * a.n_inner, s);
  if (err != cudaSuccess) return (int)err;
#define LAUNCH_LEVELS(S, D, M, X, C, I)                                                      \
  if ((err = allow_smem((const void*)bounce_fused_levels<S, D, M, X, C, I>, smem)) == cudaSuccess) \
  bounce_fused_levels<S, D, M, X, C, I><<<a.n / BLOCK, BLOCK, smem, s>>>(a)
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
  err = kernel_info((const void*)bounce_fused_levels<S, D, M, X, C, I>, BLOCK, smem, out)
  FEATURE_SWITCH(with_cull(feat, n_sph, n_quad, n_box), INFO)
#undef INFO
  return err;
}

extern "C" const char* grt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
