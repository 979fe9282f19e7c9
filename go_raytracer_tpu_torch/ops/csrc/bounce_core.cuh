// One bounce of one ray (camera.go:293-331): closest hit over the packed
// primitive table (spheres, quads, fused boxes), an optional externally
// computed mesh hit folded in, constant-density media, face-forward flip,
// emission or background, mixture light/cosine/isotropic sampling with its
// pdf, and the metal and dielectric scattering. Shared by the fused regen
// kernels (bounce_fused_q.cu, bounce_fused.cu, bounce_fused_pos.cu: uniforms
// from the hash PRNG of fused_common.cuh) and bounce.cu (uniforms and the
// mesh hit from memory). Mirrors `_bounce_core_ref` in ops/bounce.py op for
// op.
//
// A mesh hit handed in by the caller (`ExtHit`, bounce.cu) carries its own
// material columns, uv and normal; it takes a row's place in everything
// after the scan: the checker, the noise and the image texel read its
// columns, as the TPU kernel's ext mode does.
//
// The core is compiled once per feature set, as the TPU kernel is traced
// once per scene's statics: SPH the sphere section and the deferred sphere
// normal, DIEL the dielectric branch, MED the media loop and isotropic
// scattering, TEX the texture value (the checker select and the noise), IMG
// (only with TEX) the image texel. A scene without them (cornellBox) runs
// code that has none of their branches or registers. Metal is a runtime
// branch of every variant.
//
// The closest-hit loops carry the winner's row, and its material columns
// are read once after them (kind, even colour, fr; with TEX also the odd
// colour, texk, scale and seed, after the hit point is known), so that no
// material column rides a candidate's update. A medium or mesh winner has
// no row and brings its own material, a solid albedo. The
// texture value is the JAX kernel's (`_bounce_core`, texture.go:25-60,
// 88-125): the checker select by the parity of floor(scale*x) +
// floor(scale*y) + floor(scale*z) (a two's-complement `& 1`, which is the
// floor-mod by 2 of negative sums too), unconditional because solid and
// noise rows pack even == odd; then, on a noise row, perlin 0.5 (1 +
// noise(scale p)), marble 0.5 (1 + sin(scale pz + 10 turb(p))) or
// turbulent turb(p), branched on texk per lane: a lane pays the 8 or 56
// hashed gradients of its own kind and no other lane pays them.
//
// The image texel (IMG). The TPU kernel cannot gather per lane, so it
// writes each lane's diffuse pdf ratio, uv and image id as four more record
// planes, and XLA patches the weight to texel(u, v) * ratio afterwards
// (`patch_image_weight_planes`). The card can gather: a diffuse lane whose
// row has an image texture reads its texel here, three loads from a table
// that fits in L2 (the earth map is 6.3 MB as float32), and shades with it
// in the albedo's place, so its record is that patched weight and the
// kernels write no extra plane. The uv is the winning quad's (alpha, beta),
// kept by the scan in this variant only, or a sphere's from its pre-flip
// outward normal through the TPU kernel's atan2/acos polynomial; the
// polynomial, the uv and the texel index have their roundings written out
// (`__fmul_rn`, `__fadd_rn`, `__fdiv_rn`, `__fsqrt_rn`) so that nvcc
// contracts none of them and the index is the plain version's from the
// same normal.
//
// Table layouts (ops/bounce.py): primitive row = 13 geometry columns then
// the material block (kind, even rgb, odd rgb, [texk], [fr], [scale],
// [seed]); light row = L_COLS; medium row = M_COLS.
//
// The staged scan. Every lane tests the primitive rows of its scan, and all
// lanes of a warp read the same row at the same time, so what paces the
// closest-hit loop is the issue of its loads, not their bytes. The host
// builds, once per table, the scan's own table (ops/bounce.scan_layout):
// per section (spheres, quads, boxes) its rows in the scan's order, in
// blocks of SCAN_BLOCK, each block led by its bounds {lo, pad} {hi, 0}, and
// each row as float4s that a warp reads with one broadcast load each:
//   sphere {c0.xyz, r^2} {cd.xyz, row}                        2 x 16 B
//   quad   {n.xyz, D} {alpha.xyz, alpha0} {beta.xyz, beta0}   3 x 16 B
//   box    {lo.xyz, cos} {hi.xyz, sin} {offset.xyz, row}      3 x 16 B
// Spheres run in the Morton order of their swept boxes' centres, so that a
// block's bounds are tight (in declaration order where they make one block);
// quads and boxes in declaration order (book2's grid of boxes is already
// tight so). `row` is the declaration row, exact
// in float32; inactive spheres and boxes are left out, and an inactive quad
// (kind -1) keeps its place with a zero normal, so its `|dn| >= 1e-8`
// fails as its kind test did. The material columns stay in the row-major
// table and are read once, for the winner, after the loops. Each block
// first copies the prefix of the scan table that fits in STAGE_BYTES into
// dynamic shared memory (`stage_geometry`, the counterpart of the TPU
// kernel's table in VMEM; book2's 1,006 spheres, quad and 400 boxes take
// 57,104 B, all of it), and reads a block past that prefix from global
// memory, so a table of MAX_PRIMS rows gives the same winners.
//
// Winners by (t, row). A row takes the winner's place when its t is
// smaller, or equal and its declaration row lower (`before`), at every
// place that accepts a sphere row in Morton order: its root choice and its
// accept. A quad or box row comes in declaration order after every row of
// the earlier sections, so it is always declared after the winner, and its
// strict `<` is the same rule. The per-row arithmetic is that of the
// declaration-order loop it replaces, expression for expression, so every
// row's t is the same whatever the order, and the final winner is the
// least (t, row): the winner of the reference's declaration-order scan
// with its strict `<`. A sphere row whose discriminant is negative skips
// the square root and the root selection (exact: such a row cannot win).
//
// The CULL variant, for a table of which some section makes more than one
// block, tests a block's padded bounds before its rows in that section and
// skips a block the ray cannot meet in (T_MIN, t_best] (`block_hit`, which
// keeps a block that could tie); the winners stay the same. Without a
// rotated or offset box (`rot`), the box test takes the ray's reciprocals
// hoisted out of the loop, as the plain version does: with cos 1, sin 0
// and a zero offset they are the same bits.
//
// Precision: nvcc contracts multiply-adds into FMAs, and the code uses
// rsqrtf and __sincosf; the plain PyTorch version does neither, so the two
// agree to about 1e-6 relative, and a ray grazing an edge may take the
// other branch. The noise normalises each gradient with rsqrtf (at most
// 2 ulp from the correctly rounded value, PTX ISA rsqrt.approx.ftz) and
// the marble uses sinf (full range reduction): a noise value moves by
// ~1e-6; near a far hit, whose position already differs by the large
// sphere's f32 acne, the marble's 7 octaves amplify that, and a checker
// cell boundary may flip. The medium's free flight uses logf (not __logf), so its
// `hit_dist <= dist_inside` test flips only where the inputs already
// differ by a rounding. The sphere-light pdf's sqrt(1 - r^2 / dsq) is left
// unclamped, as in the reference: from inside the sphere it is NaN.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAT_BASE 13
#define L_COLS 23
#define M_COLS 20
#define N_U 9
#define T_MIN 1e-3f
#define MAT_LAMBERTIAN 0.0f
#define MAT_METAL 1.0f
#define MAT_DIELECTRIC 2.0f
#define MAT_DIFFUSE_LIGHT 3.0f
#define MAT_ISOTROPIC 4.0f
#define TEX_IMAGE 2.0f
#define TEX_PERLIN 3.0f
#define TEX_MARBLE 4.0f
#define TEX_TURBULENT 5.0f
// uniform slots (the wavefront order of the JAX package); medium m draws
// slot N_U + m, through the caller's functor
#define U_METAL_A 0
#define U_METAL_B 1
#define U_DIEL 2
#define U_MIX 3
#define U_PICK 4
#define U_LA 5
#define U_LB 6
#define U_MA 7
#define U_MB 8

// Dynamic shared memory the staged geometry may take per block: an SM's
// 228 KB hold 4 blocks of (57,216 B + 1 KB reserved + at most 128 B
// static), and the kernels' 256 threads at most 64 registers fit 4 blocks
// by registers too, so staging never costs a resident block.
#define STAGE_BYTES (56 * 1024 - 128)
#define SPH_F4 2
#define QUAD_F4 3
#define BOX_F4 3
// rows a block of the scan, the float4s of its bounds, the padding of
// their test, and the smallest largest direction component a lane culls
// with (`block_hit`)
#define SCAN_BLOCK 8
#define BND_F4 2
#define CULL_PAD 4e-3f
#define SCAN_MIN_D 0x1p-64f

// float4s of a section of n rows of f4 float4s: its blocks' bounds, then
// its rows
__host__ __device__ inline int scan_section_f4(int n, int f4) {
  return BND_F4 * ((n + SCAN_BLOCK - 1) / SCAN_BLOCK) + f4 * n;
}

// Where each section of the scan table starts, and its staged prefix.
struct StageLayout {
  int quad_at, box_at;  // float4 index of the quad and box sections (spheres: 0)
  int staged;           // float4s staged in shared memory: a prefix of the table
  int bytes;            // dynamic shared memory of the block
};

__host__ __device__ inline StageLayout stage_layout(int n_sph, int n_quad, int n_box) {
  StageLayout L;
  L.quad_at = scan_section_f4(n_sph, SPH_F4);
  L.box_at = L.quad_at + scan_section_f4(n_quad, QUAD_F4);
  const int total = L.box_at + scan_section_f4(n_box, BOX_F4);
  L.staged = total < STAGE_BYTES / 16 ? total : STAGE_BYTES / 16;
  L.bytes = L.staged * 16;
  return L;
}

// Let `fn` take `bytes` of dynamic shared memory: above the default 48 KB
// a kernel has to ask for it.
static inline cudaError_t allow_smem(const void* fn, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// What the compiler and the occupancy calculator say of kernel `fn` at
// `block` threads and `smem` bytes of dynamic shared memory: out = {
// registers, dynamic shared bytes, static shared bytes, resident blocks
// per SM, local (spill) bytes per thread}.
static inline int kernel_info(const void* fn, int block, int smem, int* out) {
  cudaFuncAttributes fa = {};
  cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err == cudaSuccess) err = allow_smem(fn, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, block, smem);
  out[0] = fa.numRegs;
  out[1] = smem;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = blocks;
  out[4] = (int)fa.localSizeBytes;
  return (int)err;
}

struct BounceTables {
  const float* prims;
  const float* lights;
  const float* med;  // (n_media, M_COLS)
  const float* bg;
  // the scan table (ops/bounce.scan_layout) and its section sizes: the
  // scanned rows of each section (a sphere or box row carries its
  // declaration row; the quads' start at quad_base)
  const float4* scan;
  int p_cols;
  int n_sph, quad_base, n_quad, n_box;
  int rot;  // some box is rotated or offset: the box test turns the ray per row
  int n_lights, n_lights_live;
  int fr_col;  // column of the metal fuzz / dielectric index, -1 if none
  int n_media;
  // columns of the texture kind, the checker/noise scale and the noise seed
  // bits (the image id on an image row), -1 where the layout lacks them
  // (read by the TEX variants only)
  int texk_col, scale_col, seed_col;
  // the image table (IMG variants only): texels (n_img, img_h, img_w, 3),
  // padded to the largest image, and each image's (w, h)
  const float* img;
  const int* img_wh;
  int img_h, img_w;
};

// The block's staged geometry (`stage_geometry`, `stage_layout` of the
// table's section sizes): the dynamic shared memory of every kernel that
// runs the core. Addressed as shared memory directly, so the scan carries
// neither a pointer nor the layout in registers: the layout is recomputed
// from the section sizes where it is used.
extern __shared__ float4 grt_geo[];

// Copy the staged prefix of the scan table (`stage_layout`) into the
// block's dynamic shared memory `grt_geo`. Every thread of the block calls
// it, outside any branch on its lane; it ends with the block's barrier.
__device__ __forceinline__ void stage_geometry(const BounceTables& T) {
  const StageLayout L = stage_layout(T.n_sph, T.n_quad, T.n_box);
  const float4* __restrict__ S = T.scan;
  for (int i = threadIdx.x; i < L.staged; i += blockDim.x) grt_geo[i] = __ldg(S + i);
  __syncthreads();
}

// A lane's constants of the cull: 1 / d (safe_d), o / d, CULL_PAD |o|_1,
// and whether it culls at all (its largest direction component at least
// SCAN_MIN_D).
struct CullRay {
  float ix, iy, iz, oix, oiy, oiz, po;
  bool on;
};

// The cull of a block: false only when no row of the block can pass its row
// test for this ray with a t in (T_MIN, t_best] (t_best included: a row as
// near as the winner and declared earlier takes its place). The block's box
// holds each row's box (a sphere swept over the motion, radius |r|; the
// hull of the corners a quad's columns describe; the hull of a box's
// rotated corners plus its offset), and the test pads it by CULL_PAD M,
// M = |o|_1 + S (lo.w = CULL_PAD S, S = |centre|_1 + |half extent|_1 of the
// block) >= the distance from the ray's origin to any point of the block
// and those points' magnitudes. With unit roundoff eps = 2^-24, a row the
// row test passes has its hit point near the row's box:
// * sphere: the rounding moves the discriminant by at most ~40 eps a M^2,
//   so the ray passes within r + sqrt(40 eps) M = r + 1.55e-3 M of the
//   centre, and the root puts the hit point within that distance too (its
//   own rounding adds ~1e-6 M);
// * quad: the point o + t d the test forms lies on the ray within a few
//   eps M and off the plane by the rounding of t's numerator, a few eps M;
//   alpha and beta in [0, 1] hold it to the parallelogram up to their
//   rounding, a few eps M over the sine of the quad's angle;
// * box without `rot`: the row's slab on each axis is ((lo - o) / d,
//   (hi - o) / d) with the same rounded 1 / d as the block's (`rot` is
//   false only when no box turns or moves), the block's faces lie CULL_PAD
//   M outside the row's, which neither subtraction's rounding (a few eps M)
//   undoes, and rounding keeps the products' order: the block's interval
//   holds the row's on each axis, and so the row's t, the axis-flat case
//   (a direction component that safe_d replaces) included, as both use the
//   same replaced 1 / d;
// * box with `rot`: t lies in the row's object-space slabs, which hold o +
//   t d within a few eps M of the box turned into world space, and the
//   hull holds that box. An object-space component below 1e-30 that safe_d
//   replaces moves the point by at most 1e-30 t on its axis, and t <=
//   2 sqrt(3) M / |d|_max (the slab of the largest component bounds it).
// The block test's own rounding (the fma against the rounded o / d) moves
// a face by a few eps M, and its safe_d moves the ray by at most 2e-30 t
// <= 2e-30 M sqrt(3) / |d|_max. A lane with |d|_max < SCAN_MIN_D = 2^-64
// tests every block (`on` false), so every such term is below 1e-10 M;
// CULL_PAD takes 2.5 times the largest (the sphere's). So a skipped block
// holds no row that could win, and the winner is the declaration-order
// scan's: the rows scanned keep their (t, row) rule.
__device__ __forceinline__ bool block_hit(const float4 lo, const float4 hi, const CullRay& c,
                                          float t_best) {
  const float pad = lo.w + c.po;
  const float tx0 = fmaf(lo.x - pad, c.ix, -c.oix), tx1 = fmaf(hi.x + pad, c.ix, -c.oix);
  const float ty0 = fmaf(lo.y - pad, c.iy, -c.oiy), ty1 = fmaf(hi.y + pad, c.iy, -c.oiy);
  const float tz0 = fmaf(lo.z - pad, c.iz, -c.oiz), tz1 = fmaf(hi.z + pad, c.iz, -c.oiz);
  const float near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return fmaxf(near, T_MIN) <= fminf(far, t_best);
}

// Scan one section of the scan table: `n` rows of F4 float4s from float4
// `at`, block by block; with CULL and `cull` (the section has more than one
// block) a block whose bounds the lane cannot meet is skipped. A block
// whose rows are all staged is read from shared memory, any other from the
// table. Without CULL every section holds at most one block, so the whole
// table is staged and the rows are read in one plain loop. `row(j, v)`
// tests the section's j-th row, `v` its float4s.
template <int F4, bool CULL, int UNROLL, class Row>
__device__ __forceinline__ void scan_section(const float4* __restrict__ S, int at, int n,
                                             int staged, bool cull, const CullRay& c,
                                             const float& t_best, Row row) {
  const int nb = (n + SCAN_BLOCK - 1) / SCAN_BLOCK;
  const int rows_at = at + BND_F4 * nb;
  if constexpr (!CULL) {
    for (int j = 0; j < n; ++j) {
      float4 v[F4];
#pragma unroll
      for (int f = 0; f < F4; ++f) v[f] = grt_geo[rows_at + F4 * j + f];
      row(j, v);
    }
    return;
  }
  for (int k = 0; k < nb; ++k) {
    const int r0 = rows_at + F4 * SCAN_BLOCK * k;
    const int e = min(SCAN_BLOCK, n - SCAN_BLOCK * k);
    const bool in_smem = r0 + F4 * e <= staged;  // the same on every lane
    if (cull && c.on) {
      const int bk = at + BND_F4 * k;
      const float4 lo = in_smem ? grt_geo[bk] : __ldg(S + bk);
      const float4 hi = in_smem ? grt_geo[bk + 1] : __ldg(S + bk + 1);
      if (!block_hit(lo, hi, c, t_best)) continue;
    }
    if (in_smem) {
#pragma unroll UNROLL
      for (int s = 0; s < SCAN_BLOCK; ++s) {
        if (s < e) {
          float4 v[F4];
#pragma unroll
          for (int f = 0; f < F4; ++f) v[f] = grt_geo[r0 + F4 * s + f];
          row(SCAN_BLOCK * k + s, v);
        }
      }
    } else {
#pragma unroll 1
      for (int s = 0; s < e; ++s) {
        float4 v[F4];
#pragma unroll
        for (int f = 0; f < F4; ++f) v[f] = __ldg(S + r0 + F4 * s + f);
        row(SCAN_BLOCK * k + s, v);
      }
    }
  }
}

// A compile-time bool as a value, to instantiate a generic lambda twice.
template <bool B>
struct BoolC {
  static constexpr bool value = B;
};

// The externally computed closest mesh hit of one ray: t (inf = none), the
// un-flipped outward normal, the texture uv (IMG variants), and the winning
// triangle's material columns: kind, even colour, fr, and for the TEX
// variants the odd colour, texk, scale and the seed column, as its float
// (an image row's image id) and as its bits (a noise row's seed).
struct ExtHit {
  float t, nx, ny, nz, u, v, kind, tex_r, tex_g, tex_b, fr;
  float od_r, od_g, od_b, texk, scale, seed_f;
  uint32_t seed;
};

struct BounceResult {
  float vr, vg, vb;       // merged V: emission, or the scatter weight
  bool emit, cf, alive;   // V is emission; clamp flag; the path goes on
  float ox, oy, oz;       // new origin (the hit point, if any)
  float dx, dy, dz;       // new direction
};

// The medium uniforms of a caller without media (never called).
struct NoMediaU {
  __device__ __forceinline__ float operator()(int) const { return 0.5f; }
};

// lowbias32 finalizer (public-domain integer hash, Wellons): the PRNG's
// and the noise's
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Gradient noise in [-1, 1] (scene/perlin.py noise_planes, perlin.go:34-54):
// the eight lattice corners' hashed unit gradients, Hermite-smoothed
// trilinear interpolation of their dots.
__device__ __forceinline__ float perlin_noise(uint32_t seed, float x, float y, float z) {
  const float flx = floorf(x), fly = floorf(y), flz = floorf(z);
  const float ux = x - flx, uy = y - fly, uz = z - flz;
  const int i0 = (int)flx, j0 = (int)fly, k0 = (int)flz;
  const float smx = ux * ux * (3.0f - 2.0f * ux);
  const float smy = uy * uy * (3.0f - 2.0f * uy);
  const float smz = uz * uz * (3.0f - 2.0f * uz);
  float acc = 0.0f;
#pragma unroll
  for (int di = 0; di < 2; ++di) {
#pragma unroll
    for (int dj = 0; dj < 2; ++dj) {
#pragma unroll
      for (int dk = 0; dk < 2; ++dk) {
        // corner hash (perlin.go:45-49's permutation XOR, as a hash)
        const uint32_t h = mix32(((uint32_t)(i0 + di) * 0x9E3779B1u) ^
                                 ((uint32_t)(j0 + dj) * 0x85EBCA77u) ^
                                 ((uint32_t)(k0 + dk) * 0xC2B2AE3Du) ^ seed);
        const float gx = (float)(h & 0x3FFu) * (2.0f / 1024.0f) - 1.0f;
        const float gy = (float)((h >> 10) & 0x3FFu) * (2.0f / 1024.0f) - 1.0f;
        const float gz = (float)((h >> 20) & 0x3FFu) * (2.0f / 1024.0f) - 1.0f;
        const float inv = rsqrtf(gx * gx + gy * gy + gz * gz + 1e-12f);
        const float w = (di ? smx : 1.0f - smx) * (dj ? smy : 1.0f - smy) *
                        (dk ? smz : 1.0f - smz);
        acc += w * ((gx * inv) * (ux - (float)di) + (gy * inv) * (uy - (float)dj) +
                    (gz * inv) * (uz - (float)dk));
      }
    }
  }
  return acc;
}

// 7-octave turbulence (perlin.go:57-69)
__device__ __forceinline__ float turbulence(uint32_t seed, float x, float y, float z) {
  float acc = 0.0f, weight = 1.0f;
  for (int o = 0; o < 7; ++o) {
    acc += weight * perlin_noise(seed, x, y, z);
    weight *= 0.5f;
    x *= 2.0f;
    y *= 2.0f;
    z *= 2.0f;
  }
  return fabsf(acc);
}

// The material columns of the winner's row: kind, even colour, fr.
__device__ __forceinline__ void load_mat(const float* g, const BounceTables& T, float& m_kind,
                                         float& tex_r, float& tex_g, float& tex_b,
                                         float& m_fr) {
  m_kind = __ldg(g + MAT_BASE);
  tex_r = __ldg(g + MAT_BASE + 1);
  tex_g = __ldg(g + MAT_BASE + 2);
  tex_b = __ldg(g + MAT_BASE + 3);
  if (T.fr_col >= 0) m_fr = __ldg(g + T.fr_col);
}

// atan2 by the TPU kernel's degree-9 minimax polynomial (A&S 4.4.49, ~1e-5
// rad; `_atan2` in ops/bounce.py), every rounding written out so that nvcc
// contracts none: the sphere uv must index the plain version's texel. The
// constants are the float32 values of the JAX kernel's.
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float hi = fmaxf(ax, ay);
  const float t = __fdiv_rn(fminf(ax, ay), fmaxf(hi, 0x1.4484cp-100f));  // 1e-30
  const float t2 = __fmul_rn(t, t);
  float p = __fadd_rn(-0x1.5cb46cp-4f, __fmul_rn(0x1.555cbep-6f, t2));  // -0.085133, 0.0208351
  p = __fadd_rn(0x1.70edc4p-3f, __fmul_rn(t2, p));                      // 0.180141
  p = __fadd_rn(-0x1.523a08p-2f, __fmul_rn(t2, p));                     // -0.3302995
  p = __fadd_rn(0x1.ffee7p-1f, __fmul_rn(t2, p));                       // 0.999866
  float r = __fmul_rn(t, p);
  if (ay > ax) r = __fsub_rn(0x1.921fb6p+0f, r);  // pi / 2
  if (x < 0.0f) r = __fsub_rn(0x1.921fb6p+1f, r);  // pi
  return y < 0.0f ? -r : r;
}

// The texture uv of a sphere hit from its outward normal (objects.go:44-50):
// u = (atan2(-z, x) + pi) / 2 pi, v = acos(-y) / pi, as the TPU kernel.
__device__ __forceinline__ void sphere_uv(float nx, float ny, float nz, float& u, float& v) {
  const float c = fminf(fmaxf(-ny, -1.0f), 1.0f);
  const float theta = atan2_poly(__fsqrt_rn(fmaxf(0.0f, __fsub_rn(1.0f, __fmul_rn(c, c)))), c);
  const float phi = __fadd_rn(atan2_poly(-nz, nx), 0x1.921fb6p+1f);
  u = __fmul_rn(phi, 0x1.45f306p-3f);    // 1 / 2 pi
  v = __fmul_rn(theta, 0x1.45f306p-2f);  // 1 / pi
}

// The nearest texel of image `id` at (u, v) (texture.go:70-86,
// `image_texel_index` in ops/bounce.py): truncated mod-repeat, v flipped,
// truncation to int, the clamp to the image's own (w, h).
__device__ __forceinline__ void image_texel(const BounceTables& T, int id, float u, float v,
                                            float& r, float& g, float& b) {
  const float uu = fabsf(fmodf(u, 1.0f));
  const float vv = __fsub_rn(1.0f, fabsf(fmodf(v, 1.0f)));
  const int w = __ldg(T.img_wh + 2 * id), h = __ldg(T.img_wh + 2 * id + 1);
  const int i = min(max((int)__fmul_rn(uu, (float)w - 1.0f), 0), w - 1);
  const int j = min(max((int)__fmul_rn(vv, (float)h - 1.0f), 0), h - 1);
  const float* px = T.img + (((size_t)id * T.img_h + j) * T.img_w + i) * 3;
  r = __ldg(px);
  g = __ldg(px + 1);
  b = __ldg(px + 2);
}

// v kept at least 1e-30 away from zero, its sign kept
__device__ __forceinline__ float safe_d(float v) {
  return fabsf(v) < 1e-30f ? (v < 0.0f ? -1e-30f : 1e-30f) : v;
}

__device__ __forceinline__ float safe_inv(float v) { return 1.0f / safe_d(v); }

// |d|^2 of a ray: dx*dx rounded, dy*dy and dz*dz fused. The sphere and
// media roots and the dielectric's unit direction use it, so that they
// round alike in every kernel: left to nvcc, which product of
// dx*dx + dy*dy + dz*dz it rounds depends on the code around it (on the
// same source it rounded dy*dy in K1 and dx*dx in K6).
__device__ __forceinline__ float len_sq(float dx, float dy, float dz) {
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float inv = rsqrtf(x * x + y * y + z * z + 1e-38f);
  x *= inv;
  y *= inv;
  z *= inv;
}

// The reference ONB about n (onb.go:13-25) applied to (lx, ly, lz).
__device__ __forceinline__ void onb_transform(float nx, float ny, float nz, float lx, float ly,
                                              float lz, float& ox, float& oy, float& oz) {
  float wx = nx, wy = ny, wz = nz;
  normalize3(wx, wy, wz);
  const bool use_y = fabsf(nx) > 0.9f;
  const float ax = use_y ? 0.0f : 1.0f, ay = use_y ? 1.0f : 0.0f;
  float vx = ny * 0.0f - nz * ay, vy = nz * ax - nx * 0.0f, vz = nx * ay - ny * ax;
  normalize3(vx, vy, vz);
  float ux = ny * vz - nz * vy, uy = nz * vx - nx * vz, uz = nx * vy - ny * vx;
  normalize3(ux, uy, uz);
  ox = lx * ux + ly * vx + lz * wx;
  oy = lx * uy + ly * vy + lz * wy;
  oz = lx * uz + ly * vz + lz * wz;
}

// The closest hit of the scan over the sphere, quad and box sections: t
// (inf: none), the normal slots (c - o for a sphere, resolved after the
// scan), whether a sphere won, the winner's declaration row (-1: none) and
// (IMG) the winning quad's (alpha, beta).
struct Closest {
  float t, nx, ny, nz;
  bool sphere;
  float rowf, al, be;
};

// The scan of `bounce_core` for one ray at time `tm`, and the dense cap of
// the mesh path (bounce.cu `bounce_cap`).
template <bool SPH, bool CULL, bool IMG>
__device__ __forceinline__ Closest closest_scan(const BounceTables& T, float ox, float oy,
                                                float oz, float dx, float dy, float dz,
                                                float tm) {
  const StageLayout stg = stage_layout(T.n_sph, T.n_quad, T.n_box);
  float t_best = INFINITY, nx = 0.0f, ny = 0.0f, nz = 0.0f;
  bool win_sphere = false;
  float win_rowf = -1.0f;  // the winning primitive's declaration row, -1 if none
  float win_al = 0.0f, win_be = 0.0f;  // IMG: the winning quad's (alpha, beta)
  // A sphere row before the winner: nearer, or with CULL (the spheres in
  // Morton order) as near and declared earlier. The quads and the boxes
  // come in declaration order after every earlier section's rows, so a row
  // of theirs is always declared after the winner and `<` is the same rule.
  auto before = [&](float t, float row) {
    return t < t_best || (CULL && t == t_best && row < win_rowf);
  };
  // the lane's cull: its reciprocals (the box test's too without `rot`)
  CullRay cr{};
  if constexpr (CULL) {
    cr.ix = safe_inv(dx);
    cr.iy = safe_inv(dy);
    cr.iz = safe_inv(dz);
    cr.oix = ox * cr.ix;
    cr.oiy = oy * cr.iy;
    cr.oiz = oz * cr.iz;
    cr.po = CULL_PAD * (fabsf(ox) + fabsf(oy) + fabsf(oz));
    cr.on = fmaxf(fmaxf(fabsf(dx), fabsf(dy)), fabsf(dz)) >= SCAN_MIN_D;
  }

  // ---- closest hit: spheres (objects.go:83-115) ---------------------------
  // the normal slots carry c - o until the winner's (p - c) / r is resolved
  if constexpr (SPH) {
    if (T.n_sph > 0) {
      const float a_quad = len_sq(dx, dy, dz);
      const float inv_a = 1.0f / a_quad;
      // v[0]: {c0, r^2}, v[1]: {cd, row}
      scan_section<SPH_F4, CULL, SCAN_BLOCK>(
          T.scan, 0, T.n_sph, stg.staged, T.n_sph > SCAN_BLOCK, cr, t_best,
          [&](int, const float4* v) {
            const float4 a = v[0], b = v[1];
            const float cx = a.x + tm * b.x - ox;
            const float cy = a.y + tm * b.y - oy;
            const float cz = a.z + tm * b.z - oz;
            const float h = dx * cx + dy * cy + dz * cz;
            const float c = cx * cx + cy * cy + cz * cz - a.w;
            const float disc = h * h - a_quad * c;
            if (disc >= 0.0f) {  // the row can win only with disc >= 0
              const float sq = sqrtf(fmaxf(disc, 0.0f));
              const float r1 = (h - sq) * inv_a, r2 = (h + sq) * inv_a;
              const float root = (T_MIN < r1 && before(r1, b.w)) ? r1 : r2;
              if (T_MIN < root && before(root, b.w)) {
                t_best = root;
                nx = cx;
                ny = cy;
                nz = cz;
                win_sphere = true;
                win_rowf = b.w;
              }
            }
          });
    }
  }
  // ---- quads (objects.go:167-206) ------------------------------------------
  // v[0]: {normal, D} (zero normal: inactive), v[1]: {alpha row, alpha0},
  // v[2]: {beta row, beta0}; the declaration row is the section's
  scan_section<QUAD_F4, CULL, 1>(
      T.scan, stg.quad_at, T.n_quad, stg.staged, T.n_quad > SCAN_BLOCK, cr, t_best,
      [&](int j, const float4* v) {
        const float4 n = v[0], al = v[1], be = v[2];
        const float dn = dx * n.x + dy * n.y + dz * n.z;
        const float on = ox * n.x + oy * n.y + oz * n.z;
        const float t_q = (n.w - on) / dn;
        const float px = ox + t_q * dx, py = oy + t_q * dy, pz = oz + t_q * dz;
        const float alpha = px * al.x + py * al.y + pz * al.z - al.w;
        const float beta = px * be.x + py * be.y + pz * be.z - be.w;
        const bool ok = fabsf(dn) >= 1e-8f && T_MIN <= t_q && t_q < t_best && alpha >= 0.0f &&
                        alpha <= 1.0f && beta >= 0.0f && beta <= 1.0f;
        if (ok) {
          t_best = t_q;
          nx = n.x;
          ny = n.y;
          nz = n.z;
          win_sphere = false;
          win_rowf = (float)(T.quad_base + j);
          if constexpr (IMG) {  // the quad's texture uv (objects.go:196-199)
            win_al = alpha;
            win_be = beta;
          }
        }
      });
  // ---- fused boxes, rotate-Y + translate rows (transformation.go) -----------
  // v[0]: {lo, cos}, v[1]: {hi, sin}, v[2]: {offset, row}; with ROT the ray
  // turned into the box's frame per row, without it the reciprocals hoisted
  auto boxes = [&](auto rot_c) {
    constexpr bool ROT = decltype(rot_c)::value;
    float bix = cr.ix, biy = cr.iy, biz = cr.iz;
    if constexpr (!ROT && !CULL) {
      bix = safe_inv(dx);
      biy = safe_inv(dy);
      biz = safe_inv(dz);
    }
    scan_section<BOX_F4, CULL, 1>(
        T.scan, stg.box_at, T.n_box, stg.staged, T.n_box > SCAN_BLOCK, cr, t_best,
        [&](int, const float4* v) {
          const float4 lo = v[0], hi = v[1], off = v[2];
          const float cs = lo.w, sn = hi.w;
          float oxo = ox, oyo = oy, ozo = oz, dxo = dx, dzo = dz;
          float ix = bix, iy = biy, iz = biz;
          if constexpr (ROT) {
            const float osx = ox - off.x, osz = oz - off.z;
            oyo = oy - off.y;
            oxo = cs * osx - sn * osz;
            ozo = sn * osx + cs * osz;
            dxo = cs * dx - sn * dz;
            dzo = sn * dx + cs * dz;
            ix = safe_inv(dxo);
            iy = safe_inv(dy);
            iz = safe_inv(dzo);
          }
          const float tx0 = (lo.x - oxo) * ix, tx1 = (hi.x - oxo) * ix;
          const float ty0 = (lo.y - oyo) * iy, ty1 = (hi.y - oyo) * iy;
          const float tz0 = (lo.z - ozo) * iz, tz1 = (hi.z - ozo) * iz;
          const float lx = fminf(tx0, tx1), hx = fmaxf(tx0, tx1);
          const float ly = fminf(ty0, ty1), hy = fmaxf(ty0, ty1);
          const float lz = fminf(tz0, tz1), hz = fmaxf(tz0, tz1);
          const float near = fmaxf(fmaxf(lx, ly), lz);
          const float far = fminf(fminf(hx, hy), hz);
          const bool entry = near >= T_MIN;
          const float t_c = entry ? near : far;
          const bool ok = far > near && T_MIN <= t_c && t_c < t_best;
          if (ok) {
            const bool is_x = (entry ? lx : hx) == t_c;
            const bool is_y = !is_x && (entry ? ly : hy) == t_c;
            const bool is_z = !is_x && !is_y;
            const float flip = entry ? -1.0f : 1.0f;
            const float nxo = is_x ? (dxo >= 0.0f ? flip : -flip) : 0.0f;
            const float nyo = is_y ? (dy >= 0.0f ? flip : -flip) : 0.0f;
            const float nzo = is_z ? (dzo >= 0.0f ? flip : -flip) : 0.0f;
            t_best = t_c;
            nx = ROT ? cs * nxo + sn * nzo : nxo;
            ny = nyo;
            nz = ROT ? -sn * nxo + cs * nzo : nzo;
            win_sphere = false;
            win_rowf = off.w;
          }
        });
  };
  if (T.n_box > 0) {  // the same on every lane
    if (T.rot)
      boxes(BoolC<true>{});
    else
      boxes(BoolC<false>{});
  }
  return Closest{t_best, nx, ny, nz, win_sphere, win_rowf, win_al, win_be};
}

// `ext` may be null (no mesh hit to fold). The ray must be alive. `u`
// holds the N_U uniforms of the level; `u_med(m)` returns medium m's.
// CULL: the blocks of a section of more than one are culled (`block_hit`),
// for a table of which some section makes more than one block.
// IMG (with TEX): a diffuse lane on an image row shades with its texel.
template <bool SPH, bool DIEL, bool MED, bool TEX, bool CULL = false, bool IMG = false,
          class UMed>
__device__ __forceinline__ BounceResult bounce_core(const BounceTables& T, float ox, float oy,
                                                    float oz, float dx, float dy, float dz,
                                                    float tm, const float* u,
                                                    const ExtHit* ext, const UMed& u_med) {
  const float* __restrict__ P = T.prims;
  const int pc = T.p_cols;
  static_assert(TEX || !IMG, "the image variant is a texture variant");
  const Closest h = closest_scan<SPH, CULL, IMG>(T, ox, oy, oz, dx, dy, dz, tm);
  float t_best = h.t, nx = h.nx, ny = h.ny, nz = h.nz;
  float m_kind = 0.0f, tex_r = 0.0f, tex_g = 0.0f, tex_b = 0.0f, m_fr = 0.0f;
  bool win_sphere = h.sphere, win_med = false, win_ext = false;
  float win_al = h.al, win_be = h.be;
  int win_row = (int)h.rowf;
  // the winner's material columns (TEX: after the texture's hit point) and
  // a winning sphere's radius, from the table in global memory
  float sph_r = 1.0f;
  if (win_row >= 0) {
    const float* g = P + win_row * pc;
    if constexpr (!TEX) load_mat(g, T, m_kind, tex_r, tex_g, tex_b, m_fr);
    if (SPH && win_sphere) sph_r = __ldg(g + 7);
  }
  // ---- the external mesh hit wins only when strictly nearer ------------------
  if (ext != nullptr && ext->t < t_best) {
    t_best = ext->t;
    nx = ext->nx;
    ny = ext->ny;
    nz = ext->nz;
    win_sphere = false;
    win_ext = true;
    win_row = -1;
    m_kind = ext->kind;
    tex_r = ext->tex_r;
    tex_g = ext->tex_g;
    tex_b = ext->tex_b;
    m_fr = ext->fr;
    if constexpr (IMG) {  // the mesh's texture uv
      win_al = ext->u;
      win_be = ext->v;
    }
  }
  // ---- constant-density media (medium.go:27-58) ------------------------------
  // each medium's boundary span (sphere roots, or the rotated box's slabs in
  // object space), clamped by the closest hit so far; an exponential free
  // flight from the medium's uniform. A medium winner has normal (1, 0, 0),
  // front face true and an isotropic material with the medium's albedo.
  if constexpr (MED) {
    if (T.n_media > 0) {
      const float a_quad = len_sq(dx, dy, dz);
      const float inv_a = 1.0f / a_quad;
      const float ray_len = sqrtf(a_quad);
      const float inv_len = 1.0f / ray_len;
      for (int m = 0; m < T.n_media; ++m) {
        const float* g = T.med + m * M_COLS;
        float near, far;
        bool ok;
        if (__ldg(g) > 0.5f) {
          const float cth = __ldg(g + 5), sth = __ldg(g + 6);
          const float osx = ox - __ldg(g + 7), osz = oz - __ldg(g + 9);
          const float oo[3] = {cth * osx - sth * osz, oy - __ldg(g + 8), sth * osx + cth * osz};
          const float dd[3] = {cth * dx - sth * dz, dy, sth * dx + cth * dz};
          near = -INFINITY;
          far = INFINITY;
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const float ds = safe_d(dd[a]);
            const float t0a = (__ldg(g + 10 + a) - oo[a]) / ds;
            const float t1a = (__ldg(g + 13 + a) - oo[a]) / ds;
            near = fmaxf(near, fminf(t0a, t1a));
            far = fminf(far, fmaxf(t0a, t1a));
          }
          ok = far > near;
        } else {
          const float cx = __ldg(g + 1) - ox, cy = __ldg(g + 2) - oy, cz = __ldg(g + 3) - oz;
          const float rad = __ldg(g + 4);
          const float h = dx * cx + dy * cy + dz * cz;
          const float c = cx * cx + cy * cy + cz * cz - rad * rad;
          const float disc = h * h - a_quad * c;
          const float sq = sqrtf(fmaxf(disc, 0.0f));
          near = (h - sq) * inv_a;
          far = (h + sq) * inv_a;
          ok = disc >= 0.0f;
        }
        ok = ok && far > near + 1e-4f;           // second boundary hit (medium.go:34)
        float t0 = fmaxf(near, T_MIN);           // medium.go:37
        const float t1 = fminf(far, t_best);     // medium.go:38
        ok = ok && t0 < t1;                      // medium.go:39
        if (ok) {
          t0 = fmaxf(t0, 0.0f);                  // medium.go:43
          const float dist_inside = (t1 - t0) * ray_len;
          const float hit_dist = __ldg(g + 16) * logf(u_med(m));
          const float t_c = t0 + hit_dist * inv_len;
          if (hit_dist <= dist_inside && t_c < t_best) {
            t_best = t_c;
            nx = 1.0f;
            ny = 0.0f;
            nz = 0.0f;
            win_sphere = false;
            win_med = true;
            win_ext = false;
            win_row = -1;
            m_kind = MAT_ISOTROPIC;
            tex_r = __ldg(g + 17);
            tex_g = __ldg(g + 18);
            tex_b = __ldg(g + 19);
            m_fr = 0.0f;
          }
        }
      }
    }
  }

  const bool hit = isfinite(t_best);
  const float ts = hit ? t_best : 1.0f;
  const float hx = ox + ts * dx, hy = oy + ts * dy, hz = oz + ts * dz;
  // ---- the texture value (texture.go:25-60, 88-125) --------------------------
  // (a mesh winner's columns come from its ext planes, a row's from the table)
  if constexpr (TEX) {
    if (win_row >= 0 || win_ext) {
      const float* g = P + (win_row >= 0 ? win_row : 0) * pc;
      if (win_row >= 0) load_mat(g, T, m_kind, tex_r, tex_g, tex_b, m_fr);
      // an image scene may have no scale column: its rows select even
      const float sc = win_ext ? ext->scale
                       : (!IMG || T.scale_col >= 0) ? __ldg(g + T.scale_col) : 0.0f;
      const int fsum = (int)floorf(sc * hx) + (int)floorf(sc * hy) + (int)floorf(sc * hz);
      if (fsum & 1) {  // odd cell: the odd colour
        tex_r = win_ext ? ext->od_r : __ldg(g + MAT_BASE + 4);
        tex_g = win_ext ? ext->od_g : __ldg(g + MAT_BASE + 5);
        tex_b = win_ext ? ext->od_b : __ldg(g + MAT_BASE + 6);
      }
      const float texk = win_ext ? ext->texk : T.texk_col >= 0 ? __ldg(g + T.texk_col) : 0.0f;
      if (texk == TEX_PERLIN || texk == TEX_MARBLE || texk == TEX_TURBULENT) {
        // the seed column holds uint32 bits: read them as such
        const uint32_t seed =
            win_ext ? ext->seed : __ldg(reinterpret_cast<const unsigned int*>(g + T.seed_col));
        float gray;
        if (texk == TEX_PERLIN) {
          gray = 0.5f * (1.0f + perlin_noise(seed, sc * hx, sc * hy, sc * hz));
        } else {
          const float tb = turbulence(seed, hx, hy, hz);
          gray = texk == TEX_MARBLE ? 0.5f * (1.0f + sinf(sc * hz + 10.0f * tb)) : tb;
        }
        tex_r = tex_g = tex_b = gray;
      }
    }
  }
  // the winning sphere's outward normal (t*d - (c - o)) / r (objects.go:96-99)
  if constexpr (SPH) {
    if (win_sphere && hit) {
      const float inv_r = 1.0f / sph_r;
      nx = (ts * dx - nx) * inv_r;
      ny = (ts * dy - ny) * inv_r;
      nz = (ts * dz - nz) * inv_r;
    }
  }
  // ---- the image texel (texture.go:70-86) on a diffuse lane whose row has
  // an image texture, from the pre-flip outward normal or the quad's uv
  if constexpr (IMG) {
    if ((win_row >= 0 || win_ext) &&
        (m_kind == MAT_LAMBERTIAN || (MED && m_kind == MAT_ISOTROPIC))) {
      const float* g = P + (win_row >= 0 ? win_row : 0) * pc;
      if ((win_ext ? ext->texk : __ldg(g + T.texk_col)) == TEX_IMAGE) {
        float uu = win_al, vv = win_be;  // a quad's (alpha, beta), a mesh's uv
        if (SPH && win_sphere) sphere_uv(nx, ny, nz, uu, vv);
        const float id = win_ext ? ext->seed_f : __ldg(g + T.seed_col);
        image_texel(T, (int)id, uu, vv, tex_r, tex_g, tex_b);
      }
    }
  }
  // face-forward flip (hittable.go:27-34), from the un-flipped outward
  // normal; a medium winner's front face is true (medium.go:55)
  const bool front = dx * nx + dy * ny + dz * nz < 0.0f || win_med;
  if (!front) {
    nx = -nx;
    ny = -ny;
    nz = -nz;
  }
  const bool is_light = hit && m_kind == MAT_DIFFUSE_LIGHT;
  const bool is_iso = MED && hit && m_kind == MAT_ISOTROPIC;
  const bool diffuse = (hit && m_kind == MAT_LAMBERTIAN) || is_iso;
  const bool is_metal = hit && m_kind == MAT_METAL;
  const bool is_diel = DIEL && hit && m_kind == MAT_DIELECTRIC;
  const bool e_on = is_light && front;
  const bool emit = !hit || e_on;

  // ---- mixture sampling (pdf.go:58-74): light pick + per-kind sample --------
  const float* __restrict__ L = T.lights;
  const int n_live = T.n_lights_live;
  int li = (int)(u[U_PICK] * (float)n_live);
  li = li < n_live - 1 ? li : n_live - 1;
  float ldx = 0.0f, ldy = 0.0f, ldz = 0.0f;
  for (int l = 0; l < T.n_lights; ++l) {
    if (li == l) {
      const float* g = L + l * L_COLS;
      if (__ldg(g) < 0.5f) {  // quad (objects.go:161-165)
        ldx = __ldg(g + 1) + u[U_LA] * __ldg(g + 4) + u[U_LB] * __ldg(g + 7) - hx;
        ldy = __ldg(g + 2) + u[U_LA] * __ldg(g + 5) + u[U_LB] * __ldg(g + 8) - hy;
        ldz = __ldg(g + 3) + u[U_LA] * __ldg(g + 6) + u[U_LB] * __ldg(g + 9) - hz;
      } else {  // sphere cone sample (objects.go:63-80)
        const float tcx = __ldg(g + 1) - hx, tcy = __ldg(g + 2) - hy, tcz = __ldg(g + 3) - hz;
        const float dist_sq = tcx * tcx + tcy * tcy + tcz * tcz;
        const float rad = __ldg(g + 4);
        const float ctm = sqrtf(fmaxf(0.0f, 1.0f - rad * rad / dist_sq));
        const float zz = 1.0f + u[U_LB] * (ctm - 1.0f);
        float s, c;
        __sincosf(6.2831855f * u[U_LA], &s, &c);
        const float st = sqrtf(fmaxf(0.0f, 1.0f - zz * zz));
        onb_transform(tcx, tcy, tcz, c * st, s * st, zz, ldx, ldy, ldz);
      }
    }
  }
  // material direction: cosine about the shading normal (pdf.go:38-40,
  // onb.go:13-25), or the uniform sphere for isotropic (pdf.go:15-23)
  float gdx, gdy, gdz;
  if (u[U_MIX] < 0.5f) {
    gdx = ldx;
    gdy = ldy;
    gdz = ldz;
  } else if (is_iso) {
    const float z = 1.0f - 2.0f * u[U_MA];
    const float r_i = sqrtf(fmaxf(0.0f, 1.0f - z * z));
    float s, c;
    __sincosf(6.2831855f * u[U_MB], &s, &c);
    gdx = r_i * c;
    gdy = r_i * s;
    gdz = z;
  } else {
    float s, c;
    __sincosf(6.2831855f * u[U_MA], &s, &c);
    const float sq = sqrtf(u[U_MB]);
    onb_transform(nx, ny, nz, c * sq, s * sq, sqrtf(fmaxf(0.0f, 1.0f - u[U_MB])), gdx, gdy,
                  gdz);
  }

  // ---- mixture pdf: mean of the live lights' pdfs (hittable.go:89-97) -------
  const float g_len_sq = gdx * gdx + gdy * gdy + gdz * gdz;
  const float g_len = sqrtf(g_len_sq);
  float l_pdf = 0.0f;
  for (int l = 0; l < n_live; ++l) {
    const float* g = L + l * L_COLS;
    if (__ldg(g) < 0.5f) {  // quad pdf (objects.go:152-160)
      const float dnl = gdx * __ldg(g + 10) + gdy * __ldg(g + 11) + gdz * __ldg(g + 12);
      const float onl = hx * __ldg(g + 10) + hy * __ldg(g + 11) + hz * __ldg(g + 12);
      const float t_l = (__ldg(g + 13) - onl) / dnl;
      const float lpx = hx + t_l * gdx, lpy = hy + t_l * gdy, lpz = hz + t_l * gdz;
      const float al =
          lpx * __ldg(g + 14) + lpy * __ldg(g + 15) + lpz * __ldg(g + 16) - __ldg(g + 20);
      const float be =
          lpx * __ldg(g + 17) + lpy * __ldg(g + 18) + lpz * __ldg(g + 19) - __ldg(g + 21);
      const bool hit_q = fabsf(dnl) >= 1e-8f && t_l >= 1e-3f && al >= 0.0f && al <= 1.0f &&
                         be >= 0.0f && be <= 1.0f;
      const float pdf_q = t_l * t_l * g_len_sq * g_len / (fabsf(dnl) * __ldg(g + 22));
      if (hit_q) l_pdf += pdf_q;
    } else {  // sphere pdf (objects.go:52-62); NaN from inside is kept
      const float ocx = __ldg(g + 1) - hx, ocy = __ldg(g + 2) - hy, ocz = __ldg(g + 3) - hz;
      const float rad = __ldg(g + 4);
      const float hh = gdx * ocx + gdy * ocy + gdz * ocz;
      const float dsq = ocx * ocx + ocy * ocy + ocz * ocz;
      const float disc_l = hh * hh - g_len_sq * (dsq - rad * rad);
      const float sql = sqrtf(fmaxf(disc_l, 0.0f));
      const float r1l = (hh - sql) / g_len_sq, r2l = (hh + sql) / g_len_sq;
      const float rootl = r1l > 1e-4f ? r1l : r2l;
      const bool hit_s = disc_l >= 0.0f && rootl > 1e-4f;
      const float ctm2 = sqrtf(1.0f - rad * rad / dsq);
      const float pdf_s = 1.0f / (6.2831855f * (1.0f - ctm2));
      if (hit_s) l_pdf += pdf_s;
    }
  }
  l_pdf = l_pdf / (float)n_live;
  const float inv_g = rsqrtf(g_len_sq + 1e-38f);
  const float cos_t = (gdx * inv_g) * nx + (gdy * inv_g) * ny + (gdz * inv_g) * nz;
  const float mat_pdf =
      is_iso ? 0.07957747154594767f : fmaxf(0.0f, cos_t) * 0.31830988618379067f;
  const float pdf_value = 0.5f * l_pdf + 0.5f * mat_pdf;

  BounceResult r;
  r.vr = r.vg = r.vb = 0.0f;
  if (emit) {
    r.vr = hit ? tex_r : T.bg[0];
    r.vg = hit ? tex_g : T.bg[1];
    r.vb = hit ? tex_b : T.bg[2];
  } else if (diffuse) {
    // a light sample below the surface (no scattering pdf) that misses the
    // light by a rounding at its edge makes both pdfs 0: its weight is 0,
    // where the reference's 0 / 0 is NaN (a pixel its PrintColor blacks out)
    const float ratio = (mat_pdf == 0.0f && pdf_value == 0.0f) ? 0.0f : mat_pdf / pdf_value;
    r.vr = tex_r * ratio;
    r.vg = tex_g * ratio;
    r.vb = tex_b * ratio;
  }
  r.dx = gdx;
  r.dy = gdy;
  r.dz = gdz;
  if (is_metal) {
    // metal (materials.go:70-79): mirror direction plus fuzz * unit vector
    const float dn_m = dx * nx + dy * ny + dz * nz;
    float rx = dx - 2.0f * dn_m * nx, ry = dy - 2.0f * dn_m * ny, rz = dz - 2.0f * dn_m * nz;
    normalize3(rx, ry, rz);
    const float zf = 1.0f - 2.0f * u[U_METAL_A];
    const float rf = sqrtf(fmaxf(0.0f, 1.0f - zf * zf));
    float s, c;
    __sincosf(6.2831855f * u[U_METAL_B], &s, &c);
    r.dx = rx + m_fr * rf * c;
    r.dy = ry + m_fr * rf * s;
    r.dz = rz + m_fr * zf;
    r.vr = tex_r;
    r.vg = tex_g;
    r.vb = tex_b;
  }
  if constexpr (DIEL) {
    if (is_diel) {
      // dielectric (materials.go:94-130): Schlick reflectance against
      // u[U_DIEL], total internal reflection tested on squares, refraction
      // as vec.go:141-146
      const float inv_d = rsqrtf(len_sq(dx, dy, dz) + 1e-38f);
      const float ux = dx * inv_d, uy = dy * inv_d, uz = dz * inv_d;
      const float ri = front ? 1.0f / m_fr : m_fr;
      const float cos_d = fminf(-(ux * nx + uy * ny + uz * nz), 1.0f);
      float r0 = (1.0f - m_fr) / (1.0f + m_fr);
      r0 = r0 * r0;
      const float x = 1.0f - cos_d;
      const float x2 = x * x;
      const float schlick = r0 + (1.0f - r0) * (x * (x2 * x2));
      if (ri * ri * (1.0f - cos_d * cos_d) > 1.0f || schlick > u[U_DIEL]) {
        const float dn = ux * nx + uy * ny + uz * nz;
        r.dx = ux - 2.0f * dn * nx;
        r.dy = uy - 2.0f * dn * ny;
        r.dz = uz - 2.0f * dn * nz;
      } else {
        const float px = ri * (ux + cos_d * nx), py = ri * (uy + cos_d * ny),
                    pz = ri * (uz + cos_d * nz);
        const float par = -sqrtf(fabsf(1.0f - (px * px + py * py + pz * pz)));
        r.dx = px + par * nx;
        r.dy = py + par * ny;
        r.dz = pz + par * nz;
      }
      r.vr = r.vg = r.vb = 1.0f;
    }
  }
  r.emit = emit;
  r.cf = diffuse;
  r.alive = diffuse || is_metal || is_diel;
  r.ox = hit ? hx : ox;
  r.oy = hit ? hy : oy;
  r.oz = hit ? hz : oz;
  return r;
}
