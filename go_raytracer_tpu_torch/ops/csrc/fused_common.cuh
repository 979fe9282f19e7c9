// What the fused regen kernels share (bounce_fused_q.cu, bounce_fused.cu,
// bounce_fused_pos.cu): the counter-based PRNG, the camera ray generation,
// the block size, the table fields and the dispatch on the scene's
// features. One thread per lane, state as SoA planes; the lane
// count is a multiple of BLOCK (checked by the wrappers).

#pragma once

#include "bounce_core.cuh"

#define BLOCK 256
#define NWARP (BLOCK / 32)
#define N_U_RAYGEN 5

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// U[0,1) from (lane, seed, slot): bit for bit the TPU kernels' _u01 and
// _u01_dyn. `seed_mix` = seed * 0x9E3779B9.
__device__ __forceinline__ float u01(uint32_t lane, uint32_t seed_mix,
                                     uint32_t slot) {
  uint32_t bits = mix32(lane ^ seed_mix ^ (slot * 0x632BE5ABu));
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// Camera ray generation (camera.go:256-270) without defocus: the ray from
// the camera centre through pixel (pi, pj) at stratum (si, sj) jittered by
// (u_jx, u_jy). cam = the (1, 20) row of ops/bounce.pack_camera.
__device__ __forceinline__ void camera_ray(const float* __restrict__ cam, float pi, float pj,
                                           float si, float sj, float u_jx, float u_jy,
                                           float& ox, float& oy, float& oz, float& dx,
                                           float& dy, float& dz) {
  const float recip = cam[18];
  const float off_x = (si + u_jx) * recip - 0.5f;
  const float off_y = (sj + u_jy) * recip - 0.5f;
  const float px = pi + off_x;
  const float py = pj + off_y;
  const float sx = cam[0] + px * cam[3] + py * cam[6];
  const float sy = cam[1] + px * cam[4] + py * cam[7];
  const float sz = cam[2] + px * cam[5] + py * cam[8];
  ox = cam[9];
  oy = cam[10];
  oz = cam[11];
  dx = sx - ox;
  dy = sy - oy;
  dz = sz - oz;
}

// The counter-based uniforms of the media: medium m of the level whose
// bounce uniforms start at slot `slot` draws slot + N_U + m. The hash is
// pure, so the core computes each one where it needs it, and no array of
// them is kept.
struct HashMediaU {
  uint32_t lane, seed_mix, slot;
  __device__ __forceinline__ float operator()(int m) const {
    return u01(lane, seed_mix, slot + N_U + (uint32_t)m);
  }
};

// The table fields every fused kernel's argument struct carries, in this
// order (ops/bounce._FUSED_TABLE_INTS mirrors them).
#define FUSED_TABLE_FIELDS                                                  \
  int p_cols, sph_base, n_sph, quad_base, n_quad, box_base, n_box;         \
  int n_lights, n_lights_live, fr_col, n_media;                            \
  int feat; /* bit 0 spheres, bit 1 the fr column, bit 2 isotropic/media */

// The dense tables of a scene inside ops/bounce.supported_statics, for the
// core compiled with these features: a section the variant lacks is
// hard-wired empty, so its code folds away.
template <bool SPH, bool DIEL, bool MED, class A>
__device__ __forceinline__ BounceTables fused_tables(const A& a) {
  BounceTables T;
  T.prims = a.prims;
  T.lights = a.lights;
  T.med = a.med;
  T.bg = a.bg;
  T.p_cols = a.p_cols;
  T.sph_base = a.sph_base;
  T.n_sph = SPH ? a.n_sph : 0;
  T.quad_base = a.quad_base;
  T.n_quad = a.n_quad;
  T.box_base = a.box_base;
  T.n_box = a.n_box;
  T.n_lights = a.n_lights;
  T.n_lights_live = a.n_lights_live;
  T.fr_col = DIEL ? a.fr_col : -1;
  T.n_media = MED ? a.n_media : 0;
  return T;
}

// Run CASE(SPH, DIEL, MED) for the feature bits of a call: one kernel
// variant per feature set, picked once per call on the host.
#define FEATURE_SWITCH(feat, CASE)            \
  switch ((feat) & 7) {                       \
    case 0: CASE(false, false, false); break; \
    case 1: CASE(true, false, false); break;  \
    case 2: CASE(false, true, false); break;  \
    case 3: CASE(true, true, false); break;   \
    case 4: CASE(false, false, true); break;  \
    case 5: CASE(true, false, true); break;   \
    case 6: CASE(false, true, true); break;   \
    default: CASE(true, true, true); break;   \
  }
