// What the fused regen kernels share (bounce_fused_q.cu, bounce_fused.cu,
// bounce_fused_pos.cu): the counter-based PRNG, the camera ray generation
// and the block size. One thread per lane, state as SoA planes; the lane
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

// The dense tables of a scene inside ops/bounce.supported_statics: quads
// and fused boxes only, no metal column.
__device__ __forceinline__ BounceTables fused_tables(const float* prims, const float* lights,
                                                     const float* bg, int p_cols,
                                                     int quad_base, int n_quad, int box_base,
                                                     int n_box, int n_lights,
                                                     int n_lights_live) {
  BounceTables T;
  T.prims = prims;
  T.lights = lights;
  T.bg = bg;
  T.p_cols = p_cols;
  T.sph_base = 0;
  T.n_sph = 0;
  T.quad_base = quad_base;
  T.n_quad = n_quad;
  T.box_base = box_base;
  T.n_box = n_box;
  T.n_lights = n_lights;
  T.n_lights_live = n_lights_live;
  T.fr_col = -1;
  return T;
}
