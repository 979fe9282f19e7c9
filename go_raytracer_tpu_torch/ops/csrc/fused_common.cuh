// What the fused regen kernels share (bounce_fused_q.cu, bounce_fused.cu,
// bounce_fused_pos.cu): the counter-based PRNG, the camera ray generation,
// the block size, the table fields, the staged geometry's bytes and the
// dispatch on the scene's features. bounce.cu (K3) takes the last four. One thread per lane, state as SoA planes; the lane
// count is a multiple of BLOCK (checked by the wrappers).

#pragma once

#include "bounce_core.cuh"

#define BLOCK 256
#define NWARP (BLOCK / 32)
#define N_U_RAYGEN 5

// U[0,1) from (lane, seed, slot): bit for bit the TPU kernels' _u01 and
// _u01_dyn. `seed_mix` = seed * 0x9E3779B9.
__device__ __forceinline__ float u01(uint32_t lane, uint32_t seed_mix,
                                     uint32_t slot) {
  uint32_t bits = mix32(lane ^ seed_mix ^ (slot * 0x632BE5ABu));
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// Camera ray generation (camera.go:256-270) from PRNG slots slot0 ..
// slot0 + 3 of the lane: the ray through pixel (pi, pj) at stratum (si, sj)
// jittered by slots 0-1, from the camera centre, or with `defocus` from the
// point of the defocus disk at radius sqrt(u2) and angle 2 pi u3 (the TPU
// kernel's polar map; slots 2-3 are drawn only then). cam = the (1, 20)
// row of ops/bounce.pack_camera: pixel00, du, dv, centre, defocus_u,
// defocus_v, 1/sqrt(spp). A call's defocus is the same on every lane, so
// the branch never diverges.
__device__ __forceinline__ void camera_ray(const float* __restrict__ cam, float pi, float pj,
                                           float si, float sj, uint32_t lane,
                                           uint32_t seed_mix, uint32_t slot0, bool defocus,
                                           float& ox, float& oy, float& oz, float& dx,
                                           float& dy, float& dz) {
  const float recip = cam[18];
  const float off_x = (si + u01(lane, seed_mix, slot0)) * recip - 0.5f;
  const float off_y = (sj + u01(lane, seed_mix, slot0 + 1)) * recip - 0.5f;
  const float px = pi + off_x;
  const float py = pj + off_y;
  const float sx = cam[0] + px * cam[3] + py * cam[6];
  const float sy = cam[1] + px * cam[4] + py * cam[7];
  const float sz = cam[2] + px * cam[5] + py * cam[8];
  if (defocus) {
    const float r = sqrtf(u01(lane, seed_mix, slot0 + 2));
    float s, c;
    __sincosf(6.2831855f * u01(lane, seed_mix, slot0 + 3), &s, &c);
    const float da = r * c, db = r * s;
    ox = cam[9] + da * cam[12] + db * cam[15];
    oy = cam[10] + da * cam[13] + db * cam[16];
    oz = cam[11] + da * cam[14] + db * cam[17];
  } else {
    ox = cam[9];
    oy = cam[10];
    oz = cam[11];
  }
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
// order (ops/bounce._FUSED_TABLE_PTRS and _FUSED_TABLE_INTS mirror them).
#define FUSED_TABLE_FIELDS                                                  \
  const float* img;   /* (n_img, img_h, img_w, 3) texels; null: no image */ \
  const int* img_wh;  /* (n_img, 2) each image's (w, h) */                 \
  const float* scan;  /* the scan table (ops/bounce.scan_layout) */        \
  int p_cols, n_sph, quad_base, n_quad, n_box;                            \
  /* (n_sph, n_quad, n_box: the rows the scan table holds) */              \
  int n_lights, n_lights_live, fr_col, n_media;                            \
  int feat; /* bits: 0 spheres, 1 the fr column, 2 media, 3 textures,  \
                5 images; (4, the cull, is with_cull's) */               \
  int texk_col, scale_col, seed_col; /* -1: the layout lacks the column */ \
  int defocus; /* camera rays from the defocus disk */                     \
  int img_h, img_w; /* the image table's padded height and width */        \
  int scan_rot; /* some box is rotated or offset */

// The dense tables of a scene inside ops/bounce.supported_statics, for the
// core compiled with these features: a section the variant lacks is
// hard-wired empty, so its code folds away.
template <bool SPH, bool DIEL, bool MED, bool TEX, bool IMG, class A>
__device__ __forceinline__ BounceTables fused_tables(const A& a) {
  BounceTables T;
  T.prims = a.prims;
  T.lights = a.lights;
  T.med = a.med;
  T.bg = a.bg;
  T.scan = reinterpret_cast<const float4*>(a.scan);
  T.rot = a.scan_rot;
  T.p_cols = a.p_cols;
  T.n_sph = SPH ? a.n_sph : 0;
  T.quad_base = a.quad_base;
  T.n_quad = a.n_quad;
  T.n_box = a.n_box;
  T.n_lights = a.n_lights;
  T.n_lights_live = a.n_lights_live;
  T.fr_col = DIEL ? a.fr_col : -1;
  T.n_media = MED ? a.n_media : 0;
  T.texk_col = TEX ? a.texk_col : -1;
  T.scale_col = TEX ? a.scale_col : -1;
  T.seed_col = TEX ? a.seed_col : -1;
  T.img = IMG ? a.img : nullptr;
  T.img_wh = IMG ? a.img_wh : nullptr;
  T.img_h = IMG ? a.img_h : 0;
  T.img_w = IMG ? a.img_w : 0;
  return T;
}

// The dynamic shared memory of a fused kernel's launch: the staged
// geometry (bounce_core.cuh) of the sections its variant scans.
inline int fused_stage_bytes(int feat, int n_sph, int n_quad, int n_box) {
  return stage_layout((feat & 1) ? n_sph : 0, n_quad, n_box).bytes;
}

// Feature bit 4, set here and not by the caller: the cull of the core's
// scan (CULL), for a table of which some section makes more than one block
// of SCAN_BLOCK rows.
#define FEAT_CULL 16
inline int with_cull(int feat, int n_sph, int n_quad, int n_box) {
  const bool many = ((feat & 1) && n_sph > SCAN_BLOCK) || n_quad > SCAN_BLOCK ||
                    n_box > SCAN_BLOCK;
  return many ? feat | FEAT_CULL : feat;
}

// Feature bit 5: the image texel (IMG), set by ops/bounce.fused_features
// for a scene with image textures, always with bit 3.
#define FEAT_IMG 32

// Run CASE(SPH, DIEL, MED, TEX, CULL, IMG) for the feature bits of a call:
// one kernel variant per feature set, picked once per call on the host
// (IMG only with TEX: 48 variants).
#define FEATURE_SWITCH3(feat, TEXV, CULLV, IMGV, CASE)           \
  switch ((feat) & 7) {                                          \
    case 0: CASE(false, false, false, TEXV, CULLV, IMGV); break; \
    case 1: CASE(true, false, false, TEXV, CULLV, IMGV); break;  \
    case 2: CASE(false, true, false, TEXV, CULLV, IMGV); break;  \
    case 3: CASE(true, true, false, TEXV, CULLV, IMGV); break;   \
    case 4: CASE(false, false, true, TEXV, CULLV, IMGV); break;  \
    case 5: CASE(true, false, true, TEXV, CULLV, IMGV); break;   \
    case 6: CASE(false, true, true, TEXV, CULLV, IMGV); break;   \
    default: CASE(true, true, true, TEXV, CULLV, IMGV); break;   \
  }
#define FEATURE_SWITCH2(feat, TEXV, IMGV, CASE)    \
  if ((feat) & FEAT_CULL) {                        \
    FEATURE_SWITCH3(feat, TEXV, true, IMGV, CASE)  \
  } else {                                         \
    FEATURE_SWITCH3(feat, TEXV, false, IMGV, CASE) \
  }
#define FEATURE_SWITCH(feat, CASE)              \
  if ((feat) & FEAT_IMG) {                      \
    FEATURE_SWITCH2(feat, true, true, CASE)     \
  } else if ((feat) & 8) {                      \
    FEATURE_SWITCH2(feat, true, false, CASE)    \
  } else {                                      \
    FEATURE_SWITCH2(feat, false, false, CASE)   \
  }
