// mesh_level: the glue of one bounce level of the mesh path's window, for
// Hopper (sm_90a). Replaces no Pallas TPU kernel: in the JAX package this
// glue is the XLA-compiled part of `fwd_step` outside `bounce_fn`
// (go_raytracer_tpu/integrator/regen.py, `refill_assign`, the camera rays,
// the dead-lane zeroing, the depth cap and the V/FL merge), and in the
// port it was some forty eager tensor launches a level plus a read of the
// level's counts back to the host. Two entry points, each beside its plain
// version in ops/mesh_level.py (`refill_ref`, `record_ref`):
//
// `grt_mesh_refill`, before the bounce: `mesh_count` advances the
// window's level counter (lvl[0], block 0 alone) and writes every block's
// dead-lane count; `mesh_refill` gives each dead lane its rank among the
// dead lanes in lane order (the dead counts of the blocks before it, then
// warp ballots, as K1's `count_dead` and `fused_q_level` do), takes item
// cursor + rank while it is below item_end and the level refills (level s
// refills where s < refill and s % cadence == 0), and starts the taken
// lanes on a camera ray from the level's uniforms u_cam (stratified
// jitter, the defocus disk, the time). Block 0 writes the level's row of
// the counts plane: segments (lanes alive after the refill), 0 (the
// record adds the lanes alive after the bounce), the cursor after the
// level, and the level's takes; and the level's base (its first item).
//
// `grt_mesh_record`, after the bounce: zeroes a dead lane's E and W,
// applies the depth cap, merges E and W into the V planes and writes the
// flag word (bit 0 the clamp, bit 1 emit, bit 2 the start and bits 3.. the
// start's rank, as `bounce_fused_q` writes them) into row s of the (rows,
// n) record planes, moves the bounce's outputs into the lane state and
// adds the block's lanes alive after the cap to the level's count (an
// integer atomic: the sum does not depend on the order the blocks run in).
//
// Both read the level s from the device counter and the level's cursor
// from the counts plane, so the host passes the same arguments at every
// level of a window and the level replays as one CUDA graph.
//
// Rounding: the camera ray is written out as the tensor code rounds it,
// one product or sum at a time in its order (__fmul_rn / __fadd_rn, which
// nvcc never fuses), sqrt correctly rounded, and sinf and cosf of the CUDA
// math library built with nvcc's default flags, as PyTorch's own sin and
// cos kernels are, so the kernel equals its plain version bit for bit on
// the card.
//
// What bounds it: bytes. Per lane and level the refill reads the 33-byte
// state and 20 bytes of uniforms and writes the state back and a 4-byte
// start word (~90 bytes); the record reads E, W, the bounce's new ray, the
// flags and the state (~70 bytes) and writes the 16-byte record and the
// state (~45 bytes). At 65,536 lanes that is ~13 MB a level, ~4 us at the
// card's memory rate; the grid of 256 blocks of 256 threads per launch is
// enough to fill it, so the kernels are one thread a lane and nothing
// more.

#include <cuda_runtime.h>
#include <stdint.h>

#define BLOCK 256
#define NWARP (BLOCK / 32)
#define CAM_COLS 20

struct MeshLevelArgs {
  float* o;             // (n, 3)
  float* d;             // (n, 3)
  float* t;             // (n,)
  unsigned char* alive; // (n,) bool
  int* depth;           // (n,)
  const float* u_cam;   // (n, 5): jitter x/y, defocus a/b, time
  const float* cam;     // (CAM_COLS,): center, pixel00, du, dv, defocus_u,
                        // defocus_v, 1 / sqrt(spp), defocus flag
  int* start;           // (n,) 4 | rank << 3 on a started lane, else 0
  int* cnt;             // (rows + 1, 4) counts; row 0 holds the cursor
  int* lvl;             // (1,) levels run in this window
  int* dcnt;            // (n / BLOCK,) dead lanes per block
  int* base;            // (rows,) first item of each level
  const float* E;       // (n, 3)
  const float* W;       // (n, 3)
  const unsigned char* cf;        // (n,)
  const unsigned char* alive_out; // (n,)
  const float* new_o;   // (n, 3)
  const float* new_d;   // (n, 3)
  float *vr, *vg, *vb;  // (rows, n)
  int* fl;              // (rows, n)
  int n, rows, item_end, refill, cadence, width, npix, sqrt_spp, max_depth;
};

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

__global__ void __launch_bounds__(BLOCK) mesh_count(MeshLevelArgs a) {
  __shared__ int red[NWARP];
  const int lane = blockIdx.x * BLOCK + threadIdx.x;
  const int c = block_sum(a.alive[lane] ? 0 : 1, red);
  if (threadIdx.x == 0) {
    a.dcnt[blockIdx.x] = c;
    // the one writer of the counter; no thread of this launch reads it
    if (blockIdx.x == 0) a.lvl[0] += 1;
  }
}

__global__ void __launch_bounds__(BLOCK) mesh_refill(MeshLevelArgs a) {
  __shared__ int red[NWARP];
  __shared__ int red2[NWARP];
  __shared__ int warp_dead[NWARP];
  const int s = a.lvl[0] - 1;
  if (s < 0 || s >= a.rows) return;
  const int nb = gridDim.x;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  // ---- dead lanes before this block, and in total -----------------------
  int before = 0, total = 0;
  for (int k = tid; k < nb; k += BLOCK) {
    const int c = a.dcnt[k];
    total += c;
    before += k < b ? c : 0;
  }
  before = block_sum(before, red);
  total = block_sum(total, red2);

  const int cursor = a.cnt[4 * s + 2];
  const bool refilling = s < a.refill && s % a.cadence == 0;
  if (b == 0 && tid == 0) {
    long long room = (long long)a.item_end - cursor;
    room = room < 0 ? 0 : room;
    const int nt = refilling ? (int)(total < room ? total : room) : 0;
    int* row = a.cnt + 4 * (s + 1);
    row[0] = (a.n - total) + nt;
    row[1] = 0;
    row[2] = cursor + nt;
    row[3] = nt;
    a.base[s] = cursor;
  }

  // ---- this lane's rank among the dead lanes -----------------------------
  const int lane = b * BLOCK + tid;
  const bool alive = a.alive[lane] != 0;
  const unsigned m = __ballot_sync(0xffffffffu, !alive);
  const int wid = tid >> 5, lid = tid & 31;
  if (lid == 0) warp_dead[wid] = __popc(m);
  __syncthreads();
  int rank = before + __popc(m & ((1u << lid) - 1u));
  for (int w = 0; w < wid; ++w) rank += warp_dead[w];
  const long long item = (long long)cursor + rank;
  const bool take = !alive && refilling && item < a.item_end;
  a.start[lane] = take ? 4 | (rank << 3) : 0;
  if (!take) return;

  // ---- the camera ray (camera.go:256-290), as render/camera.generate_rays
  const int it = (int)item;
  const int stratum = it / a.npix;
  const int pid = it - stratum * a.npix;
  const int si = stratum / a.sqrt_spp;
  const int sj = stratum - si * a.sqrt_spp;
  const int pj = pid / a.width;
  const float fi = (float)(pid - pj * a.width), fj = (float)pj;
  const float* u = a.u_cam + 5 * (size_t)lane;
  const float* c = a.cam;
  const float recip = c[18];
  const float off_x = __fadd_rn(__fmul_rn(__fadd_rn((float)si, u[0]), recip), -0.5f);
  const float off_y = __fadd_rn(__fmul_rn(__fadd_rn((float)sj, u[1]), recip), -0.5f);
  const float ax = __fadd_rn(fi, off_x), ay = __fadd_rn(fj, off_y);
  float org[3] = {c[0], c[1], c[2]};
  if (c[19] != 0.0f) {
    const float r = __fsqrt_rn(u[2]);
    const float phi = __fmul_rn(6.283185307179586f, u[3]);
    const float px = __fmul_rn(r, cosf(phi)), py = __fmul_rn(r, sinf(phi));
#pragma unroll
    for (int k = 0; k < 3; ++k)
      org[k] = __fadd_rn(__fadd_rn(c[k], __fmul_rn(px, c[12 + k])), __fmul_rn(py, c[15 + k]));
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float ps = __fadd_rn(__fadd_rn(c[3 + k], __fmul_rn(ax, c[6 + k])), __fmul_rn(ay, c[9 + k]));
    a.o[3 * (size_t)lane + k] = org[k];
    a.d[3 * (size_t)lane + k] = __fsub_rn(ps, org[k]);
  }
  a.t[lane] = u[4];
  a.alive[lane] = 1;
  a.depth[lane] = 0;
}

__global__ void __launch_bounds__(BLOCK) mesh_record(MeshLevelArgs a) {
  __shared__ int red[NWARP];
  const int s = a.lvl[0] - 1;
  if (s < 0 || s >= a.rows) return;
  const int lane = blockIdx.x * BLOCK + threadIdx.x;
  const size_t l3 = 3 * (size_t)lane;
  const bool alive = a.alive[lane] != 0;
  float e[3], w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e[k] = alive ? a.E[l3 + k] : 0.0f;
    w[k] = alive ? a.W[l3 + k] : 0.0f;
  }
  const int depth = a.depth[lane];
  // depth cap (camera.go:293-296): a path gets max_depth + 1 levels
  const bool alive_out = a.alive_out[lane] != 0 && depth < a.max_depth;
  // E and W are disjoint: lights and the background terminate, scatterers
  // do not emit; a NaN counts as emitted, as the tensor code's `!= 0`
  const bool emit = e[0] != 0.0f || e[1] != 0.0f || e[2] != 0.0f;
  const size_t r = (size_t)s * a.n + lane;
  a.vr[r] = emit ? e[0] : w[0];
  a.vg[r] = emit ? e[1] : w[1];
  a.vb[r] = emit ? e[2] : w[2];
  a.fl[r] = (a.cf[lane] != 0 && alive ? 1 : 0) | (emit ? 2 : 0) | a.start[lane];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.o[l3 + k] = a.new_o[l3 + k];
    a.d[l3 + k] = a.new_d[l3 + k];
  }
  a.alive[lane] = alive_out ? 1 : 0;
  a.depth[lane] = alive ? depth + 1 : depth;
  const int c = block_sum(alive_out ? 1 : 0, red);
  if (threadIdx.x == 0 && c) atomicAdd(a.cnt + 4 * (s + 1) + 1, c);
}

extern "C" int grt_mesh_refill(const MeshLevelArgs* args, void* stream) {
  const MeshLevelArgs a = *args;
  if (a.n <= 0 || a.n % BLOCK) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int nb = a.n / BLOCK;
  mesh_count<<<nb, BLOCK, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mesh_refill<<<nb, BLOCK, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int grt_mesh_record(const MeshLevelArgs* args, void* stream) {
  const MeshLevelArgs a = *args;
  if (a.n <= 0 || a.n % BLOCK) return (int)cudaErrorInvalidValue;
  mesh_record<<<a.n / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* grt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
