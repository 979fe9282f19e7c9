// bounce: one bounce level of the mesh path, for Hopper (sm_90a). Replaces
// the Pallas TPU kernel `bounce` (go_raytracer_tpu/ops/pallas/bounce.py,
// `_bounce_kernel`) in its external-hit mode.
//
// One thread per lane. The kernel has no PRNG, no refill and no ray
// generation: the caller hands it the rays, the nine uniforms per lane, and
// (optionally) the closest mesh hit per lane as `n_ext` planes (t, the
// un-flipped outward normal, then the winning triangle's material columns
// in the primitive table's order). The mesh hit replaces the dense winner
// only when strictly nearer; everything after that is `bounce_core`
// (bounce_core.cuh), shared with bounce_fused_q.cu, whose staged scan reads
// the geometry from the block's shared memory.
//
// What bounds it: bytes. Per lane it reads 29 B of ray state, 36 B of
// uniforms and 4*n_ext B of mesh hit, and writes 50 B, against a few hundred
// float operations; at 65,536 lanes both bounds are about a microsecond, so
// what it pays on this card is its launch.

#include "bounce_core.cuh"

#define BLOCK 256
#define MAX_EXT 16

struct BounceArgs {
  const float* prims;
  const float* lights;
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
  int p_cols, sph_base, n_sph, quad_base, n_quad, box_base, n_box;
  int n_lights, n_lights_live, fr_col;
  int n, n_u, n_ext, ext_fr;  // ext_fr: plane of the fuzz column, -1 if none
};

// the core's tables of this kernel: spheres, no dielectric, media or
// textures (the subset of ops/bounce.supported_ext)
__device__ __forceinline__ BounceTables bounce_tables(const BounceArgs& a) {
  BounceTables T;
  T.prims = a.prims;
  T.lights = a.lights;
  T.bg = a.bg;
  T.p_cols = a.p_cols;
  T.sph_base = a.sph_base;
  T.n_sph = a.n_sph;
  T.quad_base = a.quad_base;
  T.n_quad = a.n_quad;
  T.box_base = a.box_base;
  T.n_box = a.n_box;
  T.n_lights = a.n_lights;
  T.n_lights_live = a.n_lights_live;
  T.fr_col = a.fr_col;
  T.med = nullptr;
  T.n_media = 0;
  T.texk_col = T.scale_col = T.seed_col = -1;
  return T;
}

__global__ void __launch_bounds__(BLOCK) bounce_level(BounceArgs a) {
  // the geometry into shared memory, before the ragged edge's return
  const BounceTables T = bounce_tables(a);
  stage_geometry(T, false);
  const int lane = blockIdx.x * BLOCK + threadIdx.x;
  if (lane >= a.n) return;
  const float ox = a.o[3 * lane], oy = a.o[3 * lane + 1], oz = a.o[3 * lane + 2];
  const float dx = a.d[3 * lane], dy = a.d[3 * lane + 1], dz = a.d[3 * lane + 2];
  float er = 0.0f, eg = 0.0f, eb = 0.0f, wr = 0.0f, wg = 0.0f, wb = 0.0f;
  float nox = ox, noy = oy, noz = oz, ndx = dx, ndy = dy, ndz = dz;
  unsigned char cf = 0, alive_out = 0;
  if (a.alive[lane] != 0) {
    float u[N_U];
#pragma unroll
    for (int k = 0; k < N_U; ++k) u[k] = a.u[(size_t)lane * a.n_u + k];
    ExtHit ext;
    if (a.n_ext > 0) {
      ext.t = a.ext[0][lane];
      ext.nx = a.ext[1][lane];
      ext.ny = a.ext[2][lane];
      ext.nz = a.ext[3][lane];
      ext.kind = a.ext[4][lane];
      ext.tex_r = a.ext[5][lane];
      ext.tex_g = a.ext[6][lane];
      ext.tex_b = a.ext[7][lane];
      ext.fr = a.ext_fr >= 0 ? a.ext[a.ext_fr][lane] : 0.0f;
    }
    const BounceResult r = bounce_core<true, false, false, false>(
        T, ox, oy, oz, dx, dy, dz, a.tm[lane], u, a.n_ext > 0 ? &ext : nullptr, NoMediaU{});
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
  const int smem = stage_layout(a.n_sph, a.n_quad, a.n_box).bytes;
  const cudaError_t err = allow_smem((const void*)bounce_level, smem);
  if (err != cudaSuccess) return (int)err;
  bounce_level<<<nb, BLOCK, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// kernel_info of the kernel on a table of these section sizes (`feat` is
// not read: the kernel has one variant)
extern "C" int grt_kernel_info(int feat, int n_sph, int n_quad, int n_box, int* out) {
  return kernel_info((const void*)bounce_level, BLOCK,
                     stage_layout(n_sph, n_quad, n_box).bytes, out);
}

extern "C" const char* grt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
