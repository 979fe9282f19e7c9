// stream_rows: the row-stream kernel of the binned mesh intersector, for
// Hopper (sm_90a). Replaces the Pallas TPU kernel `stream_rows`
// (go_raytracer_tpu/ops/pallas/stream.py: `_stream_kernel` and
// `_stream_kernel_hbm`; one kernel serves both, the table always lives in
// device memory here).
//
// The glue sorts the ray pool by candidate cluster, so block b's BLOCK rays
// want one contiguous range [glo[b], ghi[b]) of packed 8-triangle groups.
// One thread per ray; the block stages CHUNK groups at a time through shared
// memory (each group is 8 triangles x 16 floats, read as 16-byte vectors)
// and every thread tests its ray against each staged triangle, reading the
// same shared address as its neighbours (a broadcast, no bank conflict).
//
// What bounds it: operations. A group costs each ray 8 Moller-Trumbore
// tests of about 60 float operations, against 512 bytes read once per
// block; the triangle table (a few MB) sits in L2.

#include "mt.cuh"

#define BLOCK 128
#define CHUNK 16  // groups staged per step: 8 KB of shared memory

struct StreamArgs {
  const float* lines;  // (n_groups, 128) packed group table
  const int *glo, *ghi;  // (n_blocks,)
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const float* t_in;
  const int* idx_in;
  float* t_out;
  int* idx_out;
  int n_blocks, n_groups;
};

__global__ void __launch_bounds__(BLOCK) stream_rows_kernel(StreamArgs a) {
  __shared__ __align__(16) float sh[CHUNK * ENTRY_FLOATS];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = b * BLOCK + tid;
  const float ox = a.ox[lane], oy = a.oy[lane], oz = a.oz[lane];
  const float dx = a.dx[lane], dy = a.dy[lane], dz = a.dz[lane];
  float t_best = a.t_in[lane];
  int idx = a.idx_in[lane];
  const int glo = max(a.glo[b], 0);
  const int ghi = min(a.ghi[b], a.n_groups);
  const float4* __restrict__ src = reinterpret_cast<const float4*>(a.lines);
  float4* dst = reinterpret_cast<float4*>(sh);
  for (int g0 = glo; g0 < ghi; g0 += CHUNK) {
    const int ng = min(CHUNK, ghi - g0);
    __syncthreads();
    // stage ng groups: 32 float4 per group (slot s = 4 float4, 8 slots)
    for (int i = tid; i < ng * 32; i += BLOCK) {
      const int g = g0 + (i >> 5);
      const int s = (i >> 2) & 7;
      dst[i] = __ldg(src + (packed_offset(g) + (size_t)s * 128) / 4 + (i & 3));
    }
    __syncthreads();
    for (int k = 0; k < ng; ++k)
      mt_group(sh + k * ENTRY_FLOATS, 16, ox, oy, oz, dx, dy, dz, t_best, idx);
  }
  a.t_out[lane] = t_best;
  a.idx_out[lane] = idx;
}

extern "C" int grt_stream_rows(const StreamArgs* args, void* stream) {
  const StreamArgs a = *args;
  stream_rows_kernel<<<a.n_blocks, BLOCK, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* grt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
