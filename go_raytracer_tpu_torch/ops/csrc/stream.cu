// stream_rows: the row-stream kernel of the binned mesh intersector, for
// Hopper (sm_90a). Replaces the Pallas TPU kernel `stream_rows`
// (go_raytracer_tpu/ops/pallas/stream.py: `_stream_kernel` and
// `_stream_kernel_hbm`; one kernel serves both, the table always lives in
// device memory here).
//
// The glue sorts the ray pool by candidate cluster, so block b's BLOCK rays
// want one contiguous range [glo[b], ghi[b]) of packed 8-triangle groups.
// One thread per ray; the block stages STREAM_CHUNK groups at a time through
// shared memory (each group is 8 triangles x 16 floats, read as 16-byte
// vectors) and every thread tests its ray against each staged triangle,
// reading the same shared address as its neighbours (a broadcast, no bank
// conflict): `stream_groups` in mt.cuh, shared with stream_round.cu and
// stream2.cu.
//
// What bounds it: operations. A group costs each ray 8 Moller-Trumbore
// tests of about 60 float operations, against 512 bytes read once per
// block; the triangle table (a few MB) sits in L2.

#include "mt.cuh"

#define BLOCK 128

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
  __shared__ __align__(16) float sh[STREAM_CHUNK * ENTRY_FLOATS];
  const int b = blockIdx.x;
  const int lane = b * BLOCK + threadIdx.x;
  float t_best = a.t_in[lane];
  int idx = a.idx_in[lane];
  stream_groups<BLOCK>(a.lines, max(a.glo[b], 0), min(a.ghi[b], a.n_groups), sh, a.ox[lane],
                       a.oy[lane], a.oz[lane], a.dx[lane], a.dy[lane], a.dz[lane], t_best, idx);
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
