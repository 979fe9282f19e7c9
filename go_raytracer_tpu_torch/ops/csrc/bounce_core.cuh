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
// The staged scan. Every lane tests every primitive row, and all lanes of
// a warp read the same row at the same time, so what paces the closest-hit
// loop is the issue of its loads, not their bytes: the row-major table
// costs 8 scalar read-only loads per sphere row and 10-13 per quad or box
// row. So each block first copies the geometry columns of the table into
// dynamic shared memory (`stage_geometry`, the counterpart of the TPU
// kernel's table in VMEM), in rows of float4 that a warp reads with one
// broadcast load each:
//   sphere {c0.xyz, r^2} {cd.xyz, kind}                      2 x 16 B
//   quad   {n.xyz, D} {alpha.xyz, alpha0} {beta.xyz, beta0}  3 x 16 B
//   box    {lo.xyz, cos} {hi.xyz, sin} {offset.xyz, kind}    3 x 16 B
// A quad row has no slot for its kind: an inactive quad (kind -1) is staged
// with a zero normal, so its `|dn| >= 1e-8` fails as its kind test did. The
// material columns stay in global memory and are read once, for the winner,
// after the loops. The block stages a prefix of each section in section
// order within STAGE_BYTES (`stage_layout`; book1's 389 spheres fit in
// 14,112 B with their block bounds; book2's 1,006 spheres take 126 blocks,
// 36,288 B, its quad 48 B and 395 of its 400 boxes the rest, so its last 5
// boxes are read from global memory), and the rows past it are read from
// global memory by the same row test, in the same order, so a table of
// MAX_PRIMS rows gives the same winners. The
// per-row arithmetic is the one of the row-major loop it replaces,
// expression for expression; a sphere row whose discriminant is negative
// skips the square root and the root selection (exact: such a row cannot
// win). The CULL variant, for more than one block of 8 staged spheres,
// scans them by blocks and skips a block whose padded bounds the ray
// cannot meet (`sphere_block_hit`), with the same winners.
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

// Dynamic shared memory the staged geometry may take per block. With the
// kernels' 256 threads and at most 64 registers, 4 blocks fit on an SM by
// registers; 4 x (54 KB + 1 KB reserved + K1's 96 B static) stays within
// the SM's 228 KB, so staging never costs a resident block.
#define STAGE_BYTES (54 * 1024)
#define SPH_F4 2
#define QUAD_F4 3
#define BOX_F4 3
// the sphere cull: bounds of each block of SPH_BLOCK staged rows, BLK_F4
// float4s a block, and the padding of its slab test (`sphere_block_hit`)
#define SPH_BLOCK 8
#define BLK_F4 2
#define CULL_PAD 4e-3f

// The staged prefix of each section, its float4 offsets, and the bytes.
struct StageLayout {
  int n_sph, n_quad, n_box;  // staged rows of each section
  int n_blk;                 // blocks of SPH_BLOCK staged sphere rows, the
                             // last one filled up with rows that never win
  int quad_at, box_at;       // float4 index of the first staged quad, box
  int blk_at;                // float4 index of the first block's bounds
  int bytes;                 // dynamic shared memory of the block
};

__host__ __device__ inline StageLayout stage_layout(int n_sph, int n_quad, int n_box) {
  StageLayout L;
  int room = STAGE_BYTES / 16;
  // spheres in whole blocks, each with its bounds
  const int max_sph = room / (SPH_F4 * SPH_BLOCK + BLK_F4) * SPH_BLOCK;
  L.n_sph = n_sph < max_sph ? n_sph : max_sph;
  L.n_blk = (L.n_sph + SPH_BLOCK - 1) / SPH_BLOCK;
  room -= L.n_blk * (SPH_F4 * SPH_BLOCK + BLK_F4);
  L.n_quad = n_quad < room / QUAD_F4 ? n_quad : room / QUAD_F4;
  room -= L.n_quad * QUAD_F4;
  L.n_box = n_box < room / BOX_F4 ? n_box : room / BOX_F4;
  L.quad_at = L.n_blk * SPH_BLOCK * SPH_F4;
  L.box_at = L.quad_at + L.n_quad * QUAD_F4;
  L.blk_at = L.box_at + L.n_box * BOX_F4;
  L.bytes = (L.blk_at + L.n_blk * BLK_F4) * 16;
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
  int p_cols;
  int sph_base, n_sph, quad_base, n_quad, box_base, n_box;
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

// One row of each section as the staged float4s (see the layout above),
// read from the row-major table: what stage_geometry writes, and what the
// scan reads for a row past the staged prefix.
__device__ __forceinline__ void sph_row_global(const float* g, float4& a, float4& b) {
  a = make_float4(__ldg(g + 1), __ldg(g + 2), __ldg(g + 3), __ldg(g + 8));
  b = make_float4(__ldg(g + 4), __ldg(g + 5), __ldg(g + 6), __ldg(g));
}

__device__ __forceinline__ void quad_row_global(const float* g, float4& n, float4& al,
                                                float4& be) {
  const bool on = __ldg(g) >= 0.0f;  // the kind, folded into the normal
  n = make_float4(on ? __ldg(g + 1) : 0.0f, on ? __ldg(g + 2) : 0.0f, on ? __ldg(g + 3) : 0.0f,
                  __ldg(g + 4));
  al = make_float4(__ldg(g + 5), __ldg(g + 6), __ldg(g + 7), __ldg(g + 11));
  be = make_float4(__ldg(g + 8), __ldg(g + 9), __ldg(g + 10), __ldg(g + 12));
}

__device__ __forceinline__ void box_row_global(const float* g, float4& lo, float4& hi,
                                               float4& off) {
  lo = make_float4(__ldg(g + 1), __ldg(g + 2), __ldg(g + 3), __ldg(g + 7));
  hi = make_float4(__ldg(g + 4), __ldg(g + 5), __ldg(g + 6), __ldg(g + 8));
  off = make_float4(__ldg(g + 9), __ldg(g + 10), __ldg(g + 11), __ldg(g));
}

// Copy the geometry columns of the staged prefix of each section
// (`stage_layout`) into the block's dynamic shared memory `grt_geo`; with
// `bounds`, also each sphere block's bounds for the cull. Every thread of
// the block calls it, outside any branch on its lane (`bounds` is the
// variant's, the same for the whole block); it ends with the block's
// barrier.
__device__ __forceinline__ void stage_geometry(const BounceTables& T, bool bounds) {
  const StageLayout L = stage_layout(T.n_sph, T.n_quad, T.n_box);
  float4* smem = grt_geo;
  const float* __restrict__ P = T.prims;
  const int pc = T.p_cols;
  for (int s = threadIdx.x; s < L.n_blk * SPH_BLOCK; s += blockDim.x) {
    float4* r = smem + SPH_F4 * s;
    if (s < L.n_sph) {
      sph_row_global(P + (T.sph_base + s) * pc, r[0], r[1]);
    } else {  // the last block's fill: no discriminant, kind -1
      r[0] = make_float4(0.0f, 0.0f, 0.0f, -INFINITY);
      r[1] = make_float4(0.0f, 0.0f, 0.0f, -1.0f);
    }
  }
  for (int q = threadIdx.x; q < L.n_quad; q += blockDim.x) {
    float4* r = smem + L.quad_at + QUAD_F4 * q;
    quad_row_global(P + (T.quad_base + q) * pc, r[0], r[1], r[2]);
  }
  for (int k = threadIdx.x; k < L.n_box; k += blockDim.x) {
    float4* r = smem + L.box_at + BOX_F4 * k;
    box_row_global(P + (T.box_base + k) * pc, r[0], r[1], r[2]);
  }
  __syncthreads();
  if (!bounds) return;
  // the bounds of each block of staged sphere rows: the box of its active
  // spheres swept over the motion (time 0 to 1), radius |r| (a hollow
  // sphere's is negative), as {lo, CULL_PAD S} {hi, 0}, S = |centre|_1 +
  // |half extent|_1 of the box; a block without an active row gets an
  // empty box at the origin
  for (int k = threadIdx.x; k < L.n_blk; k += blockDim.x) {
    float lx = INFINITY, ly = INFINITY, lz = INFINITY;
    float hx = -INFINITY, hy = -INFINITY, hz = -INFINITY;
    for (int s = SPH_BLOCK * k; s < SPH_BLOCK * (k + 1); ++s) {
      const float4 a = smem[SPH_F4 * s], b = smem[SPH_F4 * s + 1];
      if (b.w < 0.0f) continue;
      const float r = sqrtf(a.w);
      const float x1 = a.x + b.x, y1 = a.y + b.y, z1 = a.z + b.z;
      lx = fminf(lx, fminf(a.x, x1) - r);
      ly = fminf(ly, fminf(a.y, y1) - r);
      lz = fminf(lz, fminf(a.z, z1) - r);
      hx = fmaxf(hx, fmaxf(a.x, x1) + r);
      hy = fmaxf(hy, fmaxf(a.y, y1) + r);
      hz = fmaxf(hz, fmaxf(a.z, z1) + r);
    }
    if (!(lx <= hx)) lx = ly = lz = hx = hy = hz = 0.0f;
    const float size = fabsf(0.5f * (lx + hx)) + fabsf(0.5f * (ly + hy)) +
                       fabsf(0.5f * (lz + hz)) + 0.5f * ((hx - lx) + (hy - ly) + (hz - lz));
    float4* r = smem + L.blk_at + BLK_F4 * k;
    r[0] = make_float4(lx, ly, lz, CULL_PAD * size);
    r[1] = make_float4(hx, hy, hz, 0.0f);
  }
  __syncthreads();
}

// The cull of a block of staged sphere rows: false only when no row of the
// block can pass the row test of `bounce_core` for this ray with a root in
// (T_MIN, t_best). The slab test is of the block's box padded by CULL_PAD
// M, M = |o|_1 + S >= the distance from the ray's origin to any of the
// block's sphere centres, those centres' magnitudes, and their radii. Why
// that pad is enough: the row test's rounding (unit roundoff eps = 2^-24)
// moves its discriminant by at most ~40 eps a M^2, so a row it passes has
// the ray within r + sqrt(40 eps) M = r + 1.55e-3 M of the sphere's
// centre, and its root puts the hit point within that distance too (its
// own rounding adds ~1e-6 M); CULL_PAD takes 2.5 times that. The slab
// test's own rounding (the fma against the rounded o / d) moves a slab's
// face by a few eps M, far inside the margin. The box holds the centre at
// any ray time in [0, 1]. So skipping the block changes no winner: the
// scan keeps the rows' order and the strict `<`. `po` = CULL_PAD |o|_1,
// (ix, iy, iz) = 1 / d and (oix, oiy, oiz) = o / d, per ray.
__device__ __forceinline__ bool sphere_block_hit(const float4 lo, const float4 hi, float po,
                                                 float ix, float iy, float iz, float oix,
                                                 float oiy, float oiz, float t_best) {
  const float pad = lo.w + po;
  const float tx0 = fmaf(lo.x - pad, ix, -oix), tx1 = fmaf(hi.x + pad, ix, -oix);
  const float ty0 = fmaf(lo.y - pad, iy, -oiy), ty1 = fmaf(hi.y + pad, iy, -oiy);
  const float tz0 = fmaf(lo.z - pad, iz, -oiz), tz1 = fmaf(hi.z + pad, iz, -oiz);
  const float near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return fmaxf(near, T_MIN) <= fminf(far, t_best);
}

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

// `ext` may be null (no mesh hit to fold). The ray must be alive. `u`
// holds the N_U uniforms of the level; `u_med(m)` returns medium m's.
// CULL: the staged sphere rows by blocks (`sphere_block_hit`), for a table
// whose staged spheres make more than one block (stage_geometry's bounds).
// IMG (with TEX): a diffuse lane on an image row shades with its texel.
template <bool SPH, bool DIEL, bool MED, bool TEX, bool CULL = false, bool IMG = false,
          class UMed>
__device__ __forceinline__ BounceResult bounce_core(const BounceTables& T, float ox, float oy,
                                                    float oz, float dx, float dy, float dz,
                                                    float tm, const float* u,
                                                    const ExtHit* ext, const UMed& u_med) {
  const float* __restrict__ P = T.prims;
  const int pc = T.p_cols;
  const float4* __restrict__ G = grt_geo;
  const StageLayout stg = stage_layout(T.n_sph, T.n_quad, T.n_box);
  float t_best = INFINITY, nx = 0.0f, ny = 0.0f, nz = 0.0f;
  float m_kind = 0.0f, tex_r = 0.0f, tex_g = 0.0f, tex_b = 0.0f, m_fr = 0.0f;
  static_assert(TEX || !IMG, "the image variant is a texture variant");
  bool win_sphere = false, win_med = false, win_ext = false;
  int win_row = -1;  // the winning primitive row, -1 if none
  float win_al = 0.0f, win_be = 0.0f;  // IMG: the winning quad's (alpha, beta)

  // ---- closest hit: spheres (objects.go:83-115) ---------------------------
  // the normal slots carry c - o until the winner's (p - c) / r is resolved
  if constexpr (SPH) {
    if (T.n_sph > 0) {
      const float a_quad = len_sq(dx, dy, dz);
      const float inv_a = 1.0f / a_quad;
      // a: {c0, r^2}, b: {cd, kind}
      auto sphere = [&](int row, const float4 a, const float4 b) {
        const float cx = a.x + tm * b.x - ox;
        const float cy = a.y + tm * b.y - oy;
        const float cz = a.z + tm * b.z - oz;
        const float h = dx * cx + dy * cy + dz * cz;
        const float c = cx * cx + cy * cy + cz * cz - a.w;
        const float disc = h * h - a_quad * c;
        if (disc >= 0.0f) {  // the row can win only with disc >= 0
          const float sq = sqrtf(fmaxf(disc, 0.0f));
          const float r1 = (h - sq) * inv_a, r2 = (h + sq) * inv_a;
          const float root = (T_MIN < r1 && r1 < t_best) ? r1 : r2;
          if (b.w >= 0.0f && T_MIN < root && root < t_best) {
            t_best = root;
            nx = cx;
            ny = cy;
            nz = cz;
            win_sphere = true;
            win_row = row;
          }
        }
      };
      if constexpr (CULL) {
        // the staged rows by whole blocks, a block skipped where the ray
        // cannot meet it (sphere_block_hit)
        const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
        const float oix = ox * ix, oiy = oy * iy, oiz = oz * iz;
        const float po = CULL_PAD * (fabsf(ox) + fabsf(oy) + fabsf(oz));
        const float4* __restrict__ B = G + stg.blk_at;
        for (int k = 0; k < stg.n_blk; ++k) {
          if (!sphere_block_hit(B[BLK_F4 * k], B[BLK_F4 * k + 1], po, ix, iy, iz, oix, oiy,
                                oiz, t_best))
            continue;
#pragma unroll
          for (int s = SPH_BLOCK * k; s < SPH_BLOCK * (k + 1); ++s)
            sphere(T.sph_base + s, G[SPH_F4 * s], G[SPH_F4 * s + 1]);
        }
      } else {
        for (int s = 0; s < stg.n_sph; ++s)
          sphere(T.sph_base + s, G[SPH_F4 * s], G[SPH_F4 * s + 1]);
      }
      for (int s = stg.n_sph; s < T.n_sph; ++s) {
        float4 a, b;
        sph_row_global(P + (T.sph_base + s) * pc, a, b);
        sphere(T.sph_base + s, a, b);
      }
    }
  }
  // ---- quads (objects.go:167-206) ------------------------------------------
  // n: {normal, D} (zero normal: inactive), al: {alpha row, alpha0}, be: {beta row, beta0}
  auto quad = [&](int row, const float4 n, const float4 al, const float4 be) {
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
      win_row = row;
      if constexpr (IMG) {  // the quad's texture uv (objects.go:196-199)
        win_al = alpha;
        win_be = beta;
      }
    }
  };
  {
    int q = 0;
    for (; q < stg.n_quad; ++q) {
      const float4* r = G + stg.quad_at + QUAD_F4 * q;
      quad(T.quad_base + q, r[0], r[1], r[2]);
    }
    for (; q < T.n_quad; ++q) {
      float4 n, al, be;
      quad_row_global(P + (T.quad_base + q) * pc, n, al, be);
      quad(T.quad_base + q, n, al, be);
    }
  }
  // ---- fused boxes, rotate-Y + translate rows (transformation.go) -----------
  // lo: {lo, cos}, hi: {hi, sin}, off: {offset, kind}
  auto box = [&](int row, const float4 lo, const float4 hi, const float4 off) {
    const float cs = lo.w, sn = hi.w;
    const float osx = ox - off.x, oyo = oy - off.y, osz = oz - off.z;
    const float oxo = cs * osx - sn * osz;
    const float ozo = sn * osx + cs * osz;
    const float dxo = cs * dx - sn * dz;
    const float dzo = sn * dx + cs * dz;
    const float ix = safe_inv(dxo), iy = safe_inv(dy), iz = safe_inv(dzo);
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
    const bool ok = off.w >= 0.0f && far > near && T_MIN <= t_c && t_c < t_best;
    if (ok) {
      const bool is_x = (entry ? lx : hx) == t_c;
      const bool is_y = !is_x && (entry ? ly : hy) == t_c;
      const bool is_z = !is_x && !is_y;
      const float flip = entry ? -1.0f : 1.0f;
      const float nxo = is_x ? (dxo >= 0.0f ? flip : -flip) : 0.0f;
      const float nyo = is_y ? (dy >= 0.0f ? flip : -flip) : 0.0f;
      const float nzo = is_z ? (dzo >= 0.0f ? flip : -flip) : 0.0f;
      t_best = t_c;
      nx = cs * nxo + sn * nzo;
      ny = nyo;
      nz = -sn * nxo + cs * nzo;
      win_sphere = false;
      win_row = row;
    }
  };
  {
    int k = 0;
    for (; k < stg.n_box; ++k) {
      const float4* r = G + stg.box_at + BOX_F4 * k;
      box(T.box_base + k, r[0], r[1], r[2]);
    }
    for (; k < T.n_box; ++k) {
      float4 lo, hi, off;
      box_row_global(P + (T.box_base + k) * pc, lo, hi, off);
      box(T.box_base + k, lo, hi, off);
    }
  }
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
    const float ratio = mat_pdf / pdf_value;
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
