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
// float operations (6 quads, 2 rotated slab boxes, the light sample and the
// pdf). Both bounds are microseconds at 131072 lanes; what it pays on this
// card is the launch per level and the divergence between lanes that hit
// different materials. Tables are a few hundred floats, read with uniform
// read-only loads (one broadcast per warp).
//
// Precision: nvcc contracts multiply-adds into FMAs, and the kernel uses
// rsqrtf and __sincosf; the plain PyTorch version does neither, so the two
// agree to about 1e-6 relative per level, and a lane whose ray grazes an
// edge may take the other branch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BLOCK 256
#define NWARP (BLOCK / 32)
#define MAT_BASE 13
#define L_COLS 23
#define N_U 9
#define N_U_RAYGEN 5
#define SLOTS (N_U_RAYGEN + N_U)
#define T_MIN 1e-3f
#define MAT_LAMBERTIAN 0.0f
#define MAT_DIFFUSE_LIGHT 3.0f

struct FusedQArgs {
  const float* prims;
  const float* lights;
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
  int p_cols, quad_base, n_quad, box_base, n_box;
  int n_lights, n_lights_live;
  int n, n_inner, max_depth, width, sqrt_spp, npix;
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// U[0,1) from (lane, seed, slot): bit for bit the TPU kernel's _u01_dyn.
__device__ __forceinline__ float u01(uint32_t lane, uint32_t seed_mix,
                                     uint32_t slot) {
  uint32_t bits = mix32(lane ^ seed_mix ^ (slot * 0x632BE5ABu));
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

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

__device__ __forceinline__ float safe_inv(float v) {
  const float tiny = 1e-30f;
  return 1.0f / (fabsf(v) < tiny ? (v < 0.0f ? -tiny : tiny) : v);
}

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float inv = rsqrtf(x * x + y * y + z * z + 1e-38f);
  x *= inv;
  y *= inv;
  z *= inv;
}

__global__ void __launch_bounds__(BLOCK)
fused_q_level(FusedQArgs a, int j) {
  __shared__ int red[NWARP];
  __shared__ int red2[NWARP];
  __shared__ int warp_dead[NWARP];
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
  const uint32_t slot0 = (uint32_t)j * SLOTS;
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
    const float recip = cam[18];
    const float off_x = ((float)si + u01(ulane, seed_mix, slot0 + 0)) * recip - 0.5f;
    const float off_y = ((float)sj + u01(ulane, seed_mix, slot0 + 1)) * recip - 0.5f;
    const float px = (float)pi + off_x;
    const float py = (float)pj + off_y;
    const float sx = cam[0] + px * cam[3] + py * cam[6];
    const float sy = cam[1] + px * cam[4] + py * cam[7];
    const float sz = cam[2] + px * cam[5] + py * cam[8];
    ox = cam[9];
    oy = cam[10];
    oz = cam[11];
    dx = sx - ox;
    dy = sy - oy;
    dz = sz - oz;
    tm = u01(ulane, seed_mix, slot0 + 4);
    alive = true;
    depth = 0;
  }

  float vr = 0.0f, vg = 0.0f, vb = 0.0f;
  bool emit = false, cf = false, alive_out = false;
  if (alive) {
    // ---- closest hit: quads (objects.go:167-206) ------------------------
    const float* __restrict__ P = a.prims;
    const int pc = a.p_cols;
    float t_best = INFINITY, nx = 0.0f, ny = 0.0f, nz = 0.0f;
    float m_kind = 0.0f, tex_r = 0.0f, tex_g = 0.0f, tex_b = 0.0f;
    for (int q = 0; q < a.n_quad; ++q) {
      const float* g = P + (a.quad_base + q) * pc;
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
        m_kind = __ldg(g + MAT_BASE);
        tex_r = __ldg(g + MAT_BASE + 1);
        tex_g = __ldg(g + MAT_BASE + 2);
        tex_b = __ldg(g + MAT_BASE + 3);
      }
    }
    // ---- fused boxes, rotate-Y + translate rows (transformation.go) -------
    for (int k = 0; k < a.n_box; ++k) {
      const float* g = P + (a.box_base + k) * pc;
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
        m_kind = __ldg(g + MAT_BASE);
        tex_r = __ldg(g + MAT_BASE + 1);
        tex_g = __ldg(g + MAT_BASE + 2);
        tex_b = __ldg(g + MAT_BASE + 3);
      }
    }

    const bool hit = isfinite(t_best);
    const float ts = hit ? t_best : 1.0f;
    const float hx = ox + ts * dx, hy = oy + ts * dy, hz = oz + ts * dz;
    // face-forward flip (hittable.go:27-34)
    const bool front = dx * nx + dy * ny + dz * nz < 0.0f;
    if (!front) {
      nx = -nx;
      ny = -ny;
      nz = -nz;
    }
    const bool is_light = hit && m_kind == MAT_DIFFUSE_LIGHT;
    const bool diffuse = hit && m_kind == MAT_LAMBERTIAN;
    const bool e_on = is_light && front;
    emit = !hit || e_on;

    float u[N_U];
#pragma unroll
    for (int k = 0; k < N_U; ++k) u[k] = u01(ulane, seed_mix, slot0 + N_U_RAYGEN + k);

    // ---- mixture sampling (pdf.go:58-74): light pick + quad sample --------
    const float* __restrict__ L = a.lights;
    const int n_live = a.n_lights_live;
    int li = (int)(u[4] * (float)n_live);
    li = li < n_live - 1 ? li : n_live - 1;
    float ldx = 0.0f, ldy = 0.0f, ldz = 0.0f;
    for (int l = 0; l < a.n_lights; ++l) {
      if (li == l) {
        const float* g = L + l * L_COLS;
        ldx = __ldg(g + 1) + u[5] * __ldg(g + 4) + u[6] * __ldg(g + 7) - hx;
        ldy = __ldg(g + 2) + u[5] * __ldg(g + 5) + u[6] * __ldg(g + 8) - hy;
        ldz = __ldg(g + 3) + u[5] * __ldg(g + 6) + u[6] * __ldg(g + 9) - hz;
      }
    }
    // cosine about the shading normal (pdf.go:38-40, onb.go:13-25)
    float gdx, gdy, gdz;
    if (u[3] < 0.5f) {
      gdx = ldx;
      gdy = ldy;
      gdz = ldz;
    } else {
      float s, c;
      __sincosf(6.2831855f * u[7], &s, &c);
      const float sq = sqrtf(u[8]);
      const float lx = c * sq, ly = s * sq, lz = sqrtf(fmaxf(0.0f, 1.0f - u[8]));
      float wx = nx, wy = ny, wz = nz;
      normalize3(wx, wy, wz);
      const bool use_y = fabsf(nx) > 0.9f;
      const float ax = use_y ? 0.0f : 1.0f, ay = use_y ? 1.0f : 0.0f;
      float vx = ny * 0.0f - nz * ay, vy = nz * ax - nx * 0.0f, vz = nx * ay - ny * ax;
      normalize3(vx, vy, vz);
      float ux = ny * vz - nz * vy, uy = nz * vx - nx * vz, uz = nx * vy - ny * vx;
      normalize3(ux, uy, uz);
      gdx = lx * ux + ly * vx + lz * wx;
      gdy = lx * uy + ly * vy + lz * wy;
      gdz = lx * uz + ly * vz + lz * wz;
    }

    // ---- mixture pdf: mean of the quad-light pdfs (objects.go:152-160) -----
    const float g_len_sq = gdx * gdx + gdy * gdy + gdz * gdz;
    const float g_len = sqrtf(g_len_sq);
    float l_pdf = 0.0f;
    for (int l = 0; l < a.n_lights; ++l) {
      const float* g = L + l * L_COLS;
      const float dnl = gdx * __ldg(g + 10) + gdy * __ldg(g + 11) + gdz * __ldg(g + 12);
      const float onl = hx * __ldg(g + 10) + hy * __ldg(g + 11) + hz * __ldg(g + 12);
      const float t_l = (__ldg(g + 13) - onl) / dnl;
      const float lpx = hx + t_l * gdx, lpy = hy + t_l * gdy, lpz = hz + t_l * gdz;
      const float al = lpx * __ldg(g + 14) + lpy * __ldg(g + 15) + lpz * __ldg(g + 16) - __ldg(g + 20);
      const float be = lpx * __ldg(g + 17) + lpy * __ldg(g + 18) + lpz * __ldg(g + 19) - __ldg(g + 21);
      const bool hit_q = fabsf(dnl) >= 1e-8f && t_l >= 1e-3f && al >= 0.0f && al <= 1.0f &&
                         be >= 0.0f && be <= 1.0f;
      const float pdf_q = t_l * t_l * g_len_sq * g_len / (fabsf(dnl) * __ldg(g + 22));
      if (hit_q && l < n_live) l_pdf += pdf_q;
    }
    l_pdf = l_pdf / (float)n_live;
    const float inv_g = rsqrtf(g_len_sq + 1e-38f);
    const float cos_t = (gdx * inv_g) * nx + (gdy * inv_g) * ny + (gdz * inv_g) * nz;
    const float mat_pdf = fmaxf(0.0f, cos_t) * 0.31830988618379067f;
    const float pdf_value = 0.5f * l_pdf + 0.5f * mat_pdf;
    if (emit) {
      const float* bg = a.bg;
      vr = hit ? tex_r : bg[0];
      vg = hit ? tex_g : bg[1];
      vb = hit ? tex_b : bg[2];
    } else if (diffuse) {
      const float ratio = mat_pdf / pdf_value;
      vr = tex_r * ratio;
      vg = tex_g * ratio;
      vb = tex_b * ratio;
    }
    cf = diffuse;
    alive_out = diffuse;
    if (hit) {
      ox = hx;
      oy = hy;
      oz = hz;
    }
    dx = gdx;
    dy = gdy;
    dz = gdz;
  }

  // ---- records: merged V plane + flag bits -------------------------------
  const size_t r = (size_t)j * a.n + lane;
  a.vr[r] = vr;
  a.vg[r] = vg;
  a.vb[r] = vb;
  a.fl[r] = (cf ? 1 : 0) | (emit ? 2 : 0) | (take ? 4 | ((int)(item - cursor) << 3) : 0);

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

extern "C" int grt_bounce_fused_q(const FusedQArgs* args, void* stream) {
  FusedQArgs a = *args;
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = a.n / BLOCK;
  count_dead<<<nb, BLOCK, 0, s>>>(a.alive_in, a.dead_cnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int j = 0; j < a.n_inner; ++j) {
    fused_q_level<<<nb, BLOCK, 0, s>>>(a, j);
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

extern "C" const char* grt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
