// bounce: one bounce level from given uniforms, for Hopper (sm_90a).
// Replaces the Pallas TPU kernel `bounce` (go_raytracer_tpu/ops/pallas/
// bounce.py, `_bounce_kernel`) in both of its modes: the dense mode, the
// bounce of the reference engine (integrator/wavefront.radiance with the
// kernel backend), and the external-hit mode of the mesh path.
//
// One thread per lane. The kernel has no PRNG, no refill and no ray
// generation: the caller hands it the rays, the n_u = N_U + n_media
// uniforms per lane (medium m draws column N_U + m), and in the external-hit
// mode the closest mesh hit per lane as `n_ext` planes (t, the un-flipped
// outward normal, with images the texture u and v, then the winning
// triangle's material columns in the primitive table's order). The mesh hit
// replaces the dense winner only when strictly nearer; everything after
// that is `bounce_core` (bounce_core.cuh), shared with the fused kernels
// and compiled, as theirs, once per feature set (fused_common.cuh's
// FEATURE_SWITCH over the bits of ops/bounce.fused_features, the cull
// added here for a section of more than one block): media,
// dielectric, the textures and the image texel are read as the fused
// kernels read them.
//
// What bounds it: bytes. Per lane it reads 29 B of ray state, 4 n_u B of
// uniforms and 4 n_ext B of mesh hit, and writes 50 B, against a few hundred
// float operations (more with noise textures); at 65,536-131,072 lanes both
// bounds are a few microseconds, so what it pays on this card is its launch
// and, on a large table, its scan.

#include "fused_common.cuh"

#define MAX_EXT 20

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
  const float* ext[MAX_EXT];  // n_ext planes of (n,), in the order above
  float *E, *W;         // (n, 3)
  unsigned char* cf;    // (n,) bool
  float *new_o, *new_d; // (n, 3)
  unsigned char* alive_out;  // (n,) bool
  FUSED_TABLE_FIELDS
  int n, n_u, n_ext;
  // ext planes of the uv (-1: no image), the material columns (kind, then
  // the even and odd colours), and fr, texk, scale, seed (-1 where the
  // layout lacks the column)
  int ext_uv, ext_mat, ext_fr, ext_texk, ext_scale, ext_seed;
};

// the medium uniforms of a lane: columns N_U.. of its row of u
struct RowMediaU {
  const float* row;
  __device__ __forceinline__ float operator()(int m) const { return row[N_U + m]; }
};

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
    if (a.n_ext > 0) {
      const auto plane = [&](int k) { return k >= 0 ? a.ext[k][lane] : 0.0f; };
      ext.t = plane(0);
      ext.nx = plane(1);
      ext.ny = plane(2);
      ext.nz = plane(3);
      ext.u = IMG ? plane(a.ext_uv) : 0.0f;
      ext.v = IMG ? plane(a.ext_uv + 1) : 0.0f;
      ext.kind = plane(a.ext_mat);
      ext.tex_r = plane(a.ext_mat + 1);
      ext.tex_g = plane(a.ext_mat + 2);
      ext.tex_b = plane(a.ext_mat + 3);
      ext.od_r = TEX ? plane(a.ext_mat + 4) : 0.0f;
      ext.od_g = TEX ? plane(a.ext_mat + 5) : 0.0f;
      ext.od_b = TEX ? plane(a.ext_mat + 6) : 0.0f;
      ext.fr = plane(a.ext_fr);
      ext.texk = TEX ? plane(a.ext_texk) : 0.0f;
      ext.scale = TEX ? plane(a.ext_scale) : 0.0f;
      ext.seed_f = TEX ? plane(a.ext_seed) : 0.0f;
      ext.seed = __float_as_uint(ext.seed_f);
    }
    const BounceResult r = bounce_core<SPH, DIEL, MED, TEX, CULL, IMG>(
        T, ox, oy, oz, dx, dy, dz, a.tm[lane], u, a.n_ext > 0 ? &ext : nullptr,
        RowMediaU{urow});
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
