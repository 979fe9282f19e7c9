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
// The core is compiled once per feature set, as the TPU kernel is traced
// once per scene's statics: SPH the sphere section and the deferred sphere
// normal, DIEL the dielectric branch, MED the media loop and isotropic
// scattering, TEX the texture value (the checker select and the noise). A
// scene without them (cornellBox) runs code that has none of their
// branches or registers. Metal is a runtime branch of every variant.
//
// Without TEX the closest-hit loop carries the winner's material (kind,
// even colour, fr). With TEX it carries the winner's row instead and reads
// the row's material and texture columns once after the loop (kind, even
// and odd colour, fr, texk, scale, seed): two more colours and three
// columns would otherwise ride every candidate's update. A medium or mesh
// winner has no row and brings its own material, a solid albedo. The
// texture value is the JAX kernel's (`_bounce_core`, texture.go:25-60,
// 88-125): the checker select by the parity of floor(scale*x) +
// floor(scale*y) + floor(scale*z) (a two's-complement `& 1`, which is the
// floor-mod by 2 of negative sums too), unconditional because solid and
// noise rows pack even == odd; then, on a noise row, perlin 0.5 (1 +
// noise(scale p)), marble 0.5 (1 + sin(scale pz + 10 turb(p))) or
// turbulent turb(p), branched on texk per lane: a lane pays the 8 or 56
// hashed gradients of its own kind and no other lane pays them.
//
// Table layouts (ops/bounce.py): primitive row = 13 geometry columns then
// the material block (kind, even rgb, odd rgb, [texk], [fr], [scale],
// [seed]); light row = L_COLS; medium row = M_COLS.
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
  // bits, -1 where the layout lacks them (read by the TEX variants only)
  int texk_col, scale_col, seed_col;
};

// The externally computed closest mesh hit of one ray: t (inf = none), the
// un-flipped outward normal, and the winning triangle's material columns.
struct ExtHit {
  float t, nx, ny, nz, kind, tex_r, tex_g, tex_b, fr;
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

// v kept at least 1e-30 away from zero, its sign kept
__device__ __forceinline__ float safe_d(float v) {
  return fabsf(v) < 1e-30f ? (v < 0.0f ? -1e-30f : 1e-30f) : v;
}

__device__ __forceinline__ float safe_inv(float v) { return 1.0f / safe_d(v); }

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
template <bool SPH, bool DIEL, bool MED, bool TEX, class UMed>
__device__ __forceinline__ BounceResult bounce_core(const BounceTables& T, float ox, float oy,
                                                    float oz, float dx, float dy, float dz,
                                                    float tm, const float* u,
                                                    const ExtHit* ext, const UMed& u_med) {
  const float* __restrict__ P = T.prims;
  const int pc = T.p_cols;
  float t_best = INFINITY, nx = 0.0f, ny = 0.0f, nz = 0.0f;
  float m_kind = 0.0f, tex_r = 0.0f, tex_g = 0.0f, tex_b = 0.0f, m_fr = 0.0f;
  bool win_sphere = false, win_med = false;
  float sph_r = 1.0f;
  int win_row = -1;  // TEX: the winning primitive row, -1 if none

  // ---- closest hit: spheres (objects.go:83-115) ---------------------------
  // the normal slots carry c - o until the winner's (p - c) / r is resolved
  if constexpr (SPH) {
    if (T.n_sph > 0) {
      const float a_quad = dx * dx + dy * dy + dz * dz;
      const float inv_a = 1.0f / a_quad;
      for (int s = 0; s < T.n_sph; ++s) {
        const float* g = P + (T.sph_base + s) * pc;
        const float cx = __ldg(g + 1) + tm * __ldg(g + 4) - ox;
        const float cy = __ldg(g + 2) + tm * __ldg(g + 5) - oy;
        const float cz = __ldg(g + 3) + tm * __ldg(g + 6) - oz;
        const float h = dx * cx + dy * cy + dz * cz;
        const float c = cx * cx + cy * cy + cz * cz - __ldg(g + 8);
        const float disc = h * h - a_quad * c;
        const float sq = sqrtf(fmaxf(disc, 0.0f));
        const float r1 = (h - sq) * inv_a, r2 = (h + sq) * inv_a;
        const float root = (T_MIN < r1 && r1 < t_best) ? r1 : r2;
        const bool ok = __ldg(g) >= 0.0f && disc >= 0.0f && T_MIN < root && root < t_best;
        if (ok) {
          t_best = root;
          nx = cx;
          ny = cy;
          nz = cz;
          win_sphere = true;
          sph_r = __ldg(g + 7);
          if constexpr (TEX)
            win_row = T.sph_base + s;
          else
            load_mat(g, T, m_kind, tex_r, tex_g, tex_b, m_fr);
        }
      }
    }
  }
  // ---- quads (objects.go:167-206) ------------------------------------------
  for (int q = 0; q < T.n_quad; ++q) {
    const float* g = P + (T.quad_base + q) * pc;
    const float dn = dx * __ldg(g + 1) + dy * __ldg(g + 2) + dz * __ldg(g + 3);
    const float on = ox * __ldg(g + 1) + oy * __ldg(g + 2) + oz * __ldg(g + 3);
    const float t_q = (__ldg(g + 4) - on) / dn;
    const float px = ox + t_q * dx, py = oy + t_q * dy, pz = oz + t_q * dz;
    const float al = px * __ldg(g + 5) + py * __ldg(g + 6) + pz * __ldg(g + 7) - __ldg(g + 11);
    const float be = px * __ldg(g + 8) + py * __ldg(g + 9) + pz * __ldg(g + 10) - __ldg(g + 12);
    const bool ok = __ldg(g) >= 0.0f && fabsf(dn) >= 1e-8f && T_MIN <= t_q &&
                    t_q < t_best && al >= 0.0f && al <= 1.0f && be >= 0.0f && be <= 1.0f;
    if (ok) {
      t_best = t_q;
      nx = __ldg(g + 1);
      ny = __ldg(g + 2);
      nz = __ldg(g + 3);
      win_sphere = false;
      if constexpr (TEX)
        win_row = T.quad_base + q;
      else
        load_mat(g, T, m_kind, tex_r, tex_g, tex_b, m_fr);
    }
  }
  // ---- fused boxes, rotate-Y + translate rows (transformation.go) -----------
  for (int k = 0; k < T.n_box; ++k) {
    const float* g = P + (T.box_base + k) * pc;
    const float cs = __ldg(g + 7), sn = __ldg(g + 8);
    const float osx = ox - __ldg(g + 9), oyo = oy - __ldg(g + 10), osz = oz - __ldg(g + 11);
    const float oxo = cs * osx - sn * osz;
    const float ozo = sn * osx + cs * osz;
    const float dxo = cs * dx - sn * dz;
    const float dzo = sn * dx + cs * dz;
    const float ix = safe_inv(dxo), iy = safe_inv(dy), iz = safe_inv(dzo);
    const float tx0 = (__ldg(g + 1) - oxo) * ix, tx1 = (__ldg(g + 4) - oxo) * ix;
    const float ty0 = (__ldg(g + 2) - oyo) * iy, ty1 = (__ldg(g + 5) - oyo) * iy;
    const float tz0 = (__ldg(g + 3) - ozo) * iz, tz1 = (__ldg(g + 6) - ozo) * iz;
    const float lx = fminf(tx0, tx1), hx = fmaxf(tx0, tx1);
    const float ly = fminf(ty0, ty1), hy = fmaxf(ty0, ty1);
    const float lz = fminf(tz0, tz1), hz = fmaxf(tz0, tz1);
    const float near = fmaxf(fmaxf(lx, ly), lz);
    const float far = fminf(fminf(hx, hy), hz);
    const bool entry = near >= T_MIN;
    const float t_c = entry ? near : far;
    const bool ok = __ldg(g) >= 0.0f && far > near && T_MIN <= t_c && t_c < t_best;
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
      if constexpr (TEX)
        win_row = T.box_base + k;
      else
        load_mat(g, T, m_kind, tex_r, tex_g, tex_b, m_fr);
    }
  }
  // ---- the external mesh hit wins only when strictly nearer ------------------
  if (ext != nullptr && ext->t < t_best) {
    t_best = ext->t;
    nx = ext->nx;
    ny = ext->ny;
    nz = ext->nz;
    win_sphere = false;
    win_row = -1;
    m_kind = ext->kind;
    tex_r = ext->tex_r;
    tex_g = ext->tex_g;
    tex_b = ext->tex_b;
    m_fr = ext->fr;
  }
  // ---- constant-density media (medium.go:27-58) ------------------------------
  // each medium's boundary span (sphere roots, or the rotated box's slabs in
  // object space), clamped by the closest hit so far; an exponential free
  // flight from the medium's uniform. A medium winner has normal (1, 0, 0),
  // front face true and an isotropic material with the medium's albedo.
  if constexpr (MED) {
    if (T.n_media > 0) {
      const float a_quad = dx * dx + dy * dy + dz * dz;
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
  if constexpr (TEX) {
    if (win_row >= 0) {
      const float* g = P + win_row * pc;
      load_mat(g, T, m_kind, tex_r, tex_g, tex_b, m_fr);
      const float sc = __ldg(g + T.scale_col);
      const int fsum = (int)floorf(sc * hx) + (int)floorf(sc * hy) + (int)floorf(sc * hz);
      if (fsum & 1) {  // odd cell: the odd colour
        tex_r = __ldg(g + MAT_BASE + 4);
        tex_g = __ldg(g + MAT_BASE + 5);
        tex_b = __ldg(g + MAT_BASE + 6);
      }
      const float texk = T.texk_col >= 0 ? __ldg(g + T.texk_col) : 0.0f;
      if (texk == TEX_PERLIN || texk == TEX_MARBLE || texk == TEX_TURBULENT) {
        // the seed column holds uint32 bits: read them as such
        const uint32_t seed = __ldg(reinterpret_cast<const unsigned int*>(g + T.seed_col));
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
      float ux = dx, uy = dy, uz = dz;
      normalize3(ux, uy, uz);
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
