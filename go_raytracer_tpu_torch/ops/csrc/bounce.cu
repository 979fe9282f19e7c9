// bounce: one bounce level from given uniforms, for Hopper (sm_90a).
// Replaces the Pallas TPU kernel `bounce` (go_raytracer_tpu/ops/pallas/
// bounce.py, `_bounce_kernel`) in both of its modes: the dense mode, the
// bounce of the reference engine (integrator/wavefront.radiance with the
// kernel backend), and the external-hit mode of the mesh path.
//
// One thread per lane. The kernel has no PRNG, no refill and no ray
// generation: the caller hands it the rays and the n_u = N_U + n_media
// uniforms per lane (medium m draws column N_U + m). Everything after the
// closest hit is `bounce_core` (bounce_core.cuh), shared with the fused
// kernels and compiled, as theirs, once per feature set (fused_common.cuh's
// FEATURE_SWITCH over the bits of ops/bounce.fused_features, the cull added
// here for a section of more than one block).
//
// External-hit mode. The TPU kernel reads the mesh winner as per-lane
// planes (t, normal, uv, material columns) that XLA gathers beforehand,
// since Mosaic cannot gather per lane. The card can: the kernel takes the
// mesh walk's (t, triangle) as `ops/trace.mesh_closest` returns them and
// gathers the winner from the triangle table (`ops/bounce.tri_rows`, one
// row of float4s a triangle, L2-resident): the barycentrics in
// `ops/trace.tri_hit_gathered`'s Moller-Trumbore form, the normal
// (interpolated and normalised where the mesh has vertex normals, else the
// face normal), with images the uv (the vertex uv, else the barycentrics)
// and the material columns, every rounding written out as the plain
// version's tensor ops round. The mesh hit then replaces the dense winner
// only when strictly nearer. `bounce_cap` is the mesh path's other half:
// the dense classes' nearest t per lane (the core's scan, t only), which
// caps the mesh walk.
//
// What bounds it: in ext mode bytes (per lane 29 B of ray state, 4 n_u B of
// uniforms, 8 B of mesh hit and what the gather reads of the triangle row
// where it hit, 50 B out); on the culled tables the scan's operations.

#include "fused_common.cuh"

// the triangle row of ops/bounce.tri_rows: float columns of v0, e0, e1, the
// three vertex normals, the face normal, has_vn, has_uv, the three vertex
// uv, then from TRI_MAT the material columns of ops/bounce._mat_layout
#define TRI_MAT 32

struct BounceArgs {
  const float* prims;
  const float* lights;
  const float* med;     // (n_media, M_COLS)
  const float* bg;
  const float* o;       // (n, 3)
  const float* d;       // (n, 3)
  const float* tm;      // (n,)
  const unsigned char* alive;  // (n,) bool
  const float* u;       // (n, n_u)
  const float* hit_t;   // ext mode: (n,) the mesh walk's t
  const int* hit_idx;   // ext mode: (n,) its triangle, -1 where none
  const float* tri;     // ext mode: (n_tri, tri_cols) the triangle rows
  float *E, *W;         // (n, 3)
  unsigned char* cf;    // (n,) bool
  float *new_o, *new_d; // (n, 3)
  unsigned char* alive_out;  // (n,) bool
  float* t_cap;         // bounce_cap: (n,) the dense classes' nearest t
  FUSED_TABLE_FIELDS
  int n, n_u, ext;
  // ext mode: the triangle row's floats, and the columns of fr, texk, scale
  // and the seed (-1 where the layout lacks the column)
  int tri_cols, tri_fr, tri_texk, tri_scale, tri_seed;
};

// the medium uniforms of a lane: columns N_U.. of its row of u
struct RowMediaU {
  const float* row;
  __device__ __forceinline__ float operator()(int m) const { return row[N_U + m]; }
};

__device__ __forceinline__ float mul_(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_(float a, float b) { return __fsub_rn(a, b); }
// a0 b0 + a1 b1 + a2 b2 as the plain version's sum of the products rounds it
__device__ __forceinline__ float dot_(float a0, float a1, float a2, float b0, float b1, float b2) {
  return add_(add_(mul_(a0, b0), mul_(a1, b1)), mul_(a2, b2));
}
// w a + u b + v c
__device__ __forceinline__ float bary_(float w, float u, float v, float a, float b, float c) {
  return add_(add_(mul_(w, a), mul_(u, b)), mul_(v, c));
}

// The mesh winner of lane `lane` from the walk's (t, triangle) and the
// triangle rows: `ops/bounce.ext_planes_from_hit` for one lane. No winner
// (triangle -1, or t not finite): t = inf, which the fold never takes.
template <bool TEX, bool IMG>
__device__ __forceinline__ ExtHit tri_ext(const BounceArgs& a, int lane, float ox, float oy,
                                          float oz, float dx, float dy, float dz) {
  ExtHit e = {};
  e.t = INFINITY;
  const int idx = a.hit_idx[lane];
  const float t = a.hit_t[lane];
  if (idx < 0 || !isfinite(t)) return e;
  const float* row = a.tri + (size_t)idx * a.tri_cols;
  const float4* r = reinterpret_cast<const float4*>(row);
  const float4 r0 = __ldg(r), r1 = __ldg(r + 1), r2 = __ldg(r + 2);
  const float4 r3 = __ldg(r + 3), r4 = __ldg(r + 4), r5 = __ldg(r + 5);
  // Moller-Trumbore's u and v (ops/trace.tri_hit_gathered)
  const float e0x = r0.w, e0y = r1.x, e0z = r1.y, e1x = r1.z, e1y = r1.w, e1z = r2.x;
  const float px = sub_(mul_(dy, e1z), mul_(dz, e1y));
  const float py = sub_(mul_(dz, e1x), mul_(dx, e1z));
  const float pz = sub_(mul_(dx, e1y), mul_(dy, e1x));
  const float det = dot_(e0x, e0y, e0z, px, py, pz);
  const float inv = __fdiv_rn(1.0f, fabsf(det) < 1e-30f ? 1e-30f : det);
  const float tx = sub_(ox, r0.x), ty = sub_(oy, r0.y), tz = sub_(oz, r0.z);
  const float bu = mul_(dot_(tx, ty, tz, px, py, pz), inv);
  const float qx = sub_(mul_(ty, e0z), mul_(tz, e0y));
  const float qy = sub_(mul_(tz, e0x), mul_(tx, e0z));
  const float qz = sub_(mul_(tx, e0y), mul_(ty, e0x));
  const float bv = mul_(dot_(dx, dy, dz, qx, qy, qz), inv);
  const float w = sub_(sub_(1.0f, bu), bv);
  e.t = t;
  if (r5.y != 0.0f) {  // the vertex normals, interpolated and normalised
    const float nx = bary_(w, bu, bv, r2.y, r3.x, r3.w);
    const float ny = bary_(w, bu, bv, r2.z, r3.y, r4.x);
    const float nz = bary_(w, bu, bv, r2.w, r3.z, r4.y);
    const float ln = fmaxf(__fsqrt_rn(dot_(nx, ny, nz, nx, ny, nz)), 1e-30f);
    e.nx = __fdiv_rn(nx, ln);
    e.ny = __fdiv_rn(ny, ln);
    e.nz = __fdiv_rn(nz, ln);
  } else {
    e.nx = r4.z;
    e.ny = r4.w;
    e.nz = r5.x;
  }
  if constexpr (IMG) {  // the vertex uv where the mesh has it, else (u, v)
    e.u = bu;
    e.v = bv;
    if (r5.z != 0.0f) {
      const float4 r6 = __ldg(r + 6), r7 = __ldg(r + 7);
      e.u = bary_(w, bu, bv, r6.x, r6.z, r7.x);
      e.v = bary_(w, bu, bv, r6.y, r6.w, r7.y);
    }
  }
  const float4 m0 = __ldg(r + TRI_MAT / 4);
  e.kind = m0.x;
  e.tex_r = m0.y;
  e.tex_g = m0.z;
  e.tex_b = m0.w;
  e.fr = a.tri_fr >= 0 ? __ldg(row + a.tri_fr) : 0.0f;
  if constexpr (TEX) {
    const float4 m1 = __ldg(r + TRI_MAT / 4 + 1);
    e.od_r = m1.x;
    e.od_g = m1.y;
    e.od_b = m1.z;
    e.texk = a.tri_texk >= 0 ? __ldg(row + a.tri_texk) : 0.0f;
    e.scale = a.tri_scale >= 0 ? __ldg(row + a.tri_scale) : 0.0f;
    e.seed_f = a.tri_seed >= 0 ? __ldg(row + a.tri_seed) : 0.0f;
    e.seed = __float_as_uint(e.seed_f);
  }
  return e;
}

template <bool SPH, bool DIEL, bool MED, bool TEX, bool CULL, bool IMG>
__global__ void __launch_bounds__(BLOCK) bounce_level(BounceArgs a) {
  // the geometry into shared memory, before the ragged edge's return
  const BounceTables T = fused_tables<SPH, DIEL, MED, TEX, IMG>(a);
  stage_geometry(T);
  const int lane = blockIdx.x * BLOCK + threadIdx.x;
  if (lane >= a.n) return;
  const float ox = a.o[3 * lane], oy = a.o[3 * lane + 1], oz = a.o[3 * lane + 2];
  const float dx = a.d[3 * lane], dy = a.d[3 * lane + 1], dz = a.d[3 * lane + 2];
  float er = 0.0f, eg = 0.0f, eb = 0.0f, wr = 0.0f, wg = 0.0f, wb = 0.0f;
  float nox = ox, noy = oy, noz = oz, ndx = dx, ndy = dy, ndz = dz;
  unsigned char cf = 0, alive_out = 0;
  if (a.alive[lane] != 0) {
    const float* urow = a.u + (size_t)lane * a.n_u;
    float u[N_U];
#pragma unroll
    for (int k = 0; k < N_U; ++k) u[k] = urow[k];
    ExtHit ext;
    if (a.ext) ext = tri_ext<TEX, IMG>(a, lane, ox, oy, oz, dx, dy, dz);
    const BounceResult r = bounce_core<SPH, DIEL, MED, TEX, CULL, IMG>(
        T, ox, oy, oz, dx, dy, dz, a.tm[lane], u, a.ext ? &ext : nullptr, RowMediaU{urow});
    if (r.emit) {
      er = r.vr;
      eg = r.vg;
      eb = r.vb;
    } else {
      wr = r.vr;
      wg = r.vg;
      wb = r.vb;
    }
    cf = r.cf ? 1 : 0;
    alive_out = r.alive ? 1 : 0;
    nox = r.ox;
    noy = r.oy;
    noz = r.oz;
    ndx = r.dx;
    ndy = r.dy;
    ndz = r.dz;
  }
  a.E[3 * lane] = er;
  a.E[3 * lane + 1] = eg;
  a.E[3 * lane + 2] = eb;
  a.W[3 * lane] = wr;
  a.W[3 * lane + 1] = wg;
  a.W[3 * lane + 2] = wb;
  a.cf[lane] = cf;
  a.new_o[3 * lane] = nox;
  a.new_o[3 * lane + 1] = noy;
  a.new_o[3 * lane + 2] = noz;
  a.new_d[3 * lane] = ndx;
  a.new_d[3 * lane + 1] = ndy;
  a.new_d[3 * lane + 2] = ndz;
  a.alive_out[lane] = alive_out;
}

// The dense cap of the mesh path: each lane's nearest t over the sphere,
// quad and box sections in (T_MIN, inf) at its time (the scan of
// `bounce_core`, its winner's t only), inf where none.
template <bool SPH, bool CULL>
__global__ void __launch_bounds__(BLOCK) bounce_cap(BounceArgs a) {
  const BounceTables T = fused_tables<SPH, false, false, false, false>(a);
  stage_geometry(T);
  const int lane = blockIdx.x * BLOCK + threadIdx.x;
  if (lane >= a.n) return;
  a.t_cap[lane] = closest_scan<SPH, CULL, false>(T, a.o[3 * lane], a.o[3 * lane + 1],
                                                 a.o[3 * lane + 2], a.d[3 * lane],
                                                 a.d[3 * lane + 1], a.d[3 * lane + 2], a.tm[lane])
                      .t;
}

// One bounce level.
extern "C" int grt_bounce(const BounceArgs* args, void* stream) {
  const BounceArgs a = *args;
  const int nb = (a.n + BLOCK - 1) / BLOCK;
  const int smem = fused_stage_bytes(a.feat, a.n_sph, a.n_quad, a.n_box);
  const int feat = with_cull(a.feat, a.n_sph, a.n_quad, a.n_box);
  cudaError_t err = cudaSuccess;
#define LAUNCH(S, D, M, X, C, I)                                                    \
  if ((err = allow_smem((const void*)bounce_level<S, D, M, X, C, I>, smem)) == cudaSuccess) \
  bounce_level<S, D, M, X, C, I><<<nb, BLOCK, smem, (cudaStream_t)stream>>>(a)
  FEATURE_SWITCH(feat, LAUNCH)
#undef LAUNCH
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool S, bool C>
static cudaError_t launch_cap(const BounceArgs& a, int nb, int smem, cudaStream_t stream) {
  cudaError_t err = allow_smem((const void*)bounce_cap<S, C>, smem);
  if (err == cudaSuccess) bounce_cap<S, C><<<nb, BLOCK, smem, stream>>>(a);
  return err;
}

// The dense cap of the mesh path: `t_cap` from the rays o, d, tm.
extern "C" int grt_bounce_cap(const BounceArgs* args, void* stream) {
  const BounceArgs a = *args;
  const cudaStream_t s = (cudaStream_t)stream;
  const int nb = (a.n + BLOCK - 1) / BLOCK;
  const int smem = fused_stage_bytes(a.feat, a.n_sph, a.n_quad, a.n_box);
  const int feat = with_cull(a.feat, a.n_sph, a.n_quad, a.n_box);
  const bool sph = (feat & 1) != 0, cull = (feat & FEAT_CULL) != 0;
  cudaError_t err = sph ? (cull ? launch_cap<true, true>(a, nb, smem, s)
                                : launch_cap<true, false>(a, nb, smem, s))
                        : (cull ? launch_cap<false, true>(a, nb, smem, s)
                                : launch_cap<false, false>(a, nb, smem, s));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Registers, dynamic and static shared bytes, resident blocks per SM and
// spill bytes of the variant for feature bits `feat` on a table of these
// section sizes (kernel_info's `out`).
extern "C" int grt_kernel_info(int feat, int n_sph, int n_quad, int n_box, int* out) {
  const int smem = fused_stage_bytes(feat, n_sph, n_quad, n_box);
  int err = 0;
#define INFO(S, D, M, X, C, I) \
  err = kernel_info((const void*)bounce_level<S, D, M, X, C, I>, BLOCK, smem, out)
  FEATURE_SWITCH(with_cull(feat, n_sph, n_quad, n_box), INFO)
#undef INFO
  return err;
}

extern "C" const char* grt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
