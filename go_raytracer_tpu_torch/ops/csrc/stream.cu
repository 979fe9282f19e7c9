// stream_rows: the row-stream kernel of the binned mesh intersector, for
// Hopper (sm_90a). Replaces the Pallas TPU kernel `stream_rows`
// (go_raytracer_tpu/ops/pallas/stream.py: `_stream_kernel` and
// `_stream_kernel_hbm`; one kernel serves both, the table always lives in
// device memory here).
//
// The stream itself (work items of ops/stream.CH groups scanned per block on
// the device, a persistent grid pulling them from a counter through a
// cp.async ring, each ray's items merged by a 64-bit atomicMin) is in
// stream_items.cuh, shared with K10 (stream_round.cu); its header says why
// the merge equals the plain version's sequential stream. This file adds the
// finish pass, `stream_finish`: t_out and idx_out from each ray's key.
//
// What bounds it: operations. A group costs each ray 8 Moller-Trumbore
// tests of about 46 float operations, against 512 bytes staged once per
// item; the triangle table (a few MB) sits in L2.

#include "stream_items.cuh"

__global__ void __launch_bounds__(256) stream_finish(StreamArgs a) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= a.n_blocks * BLOCK) return;
  decode_key(a, i, a.t_out[i], a.idx_out[i]);
}

extern "C" int grt_stream_rows(const StreamArgs* args, void* stream) {
  const StreamArgs a = *args;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = launch_stream_items(a, st);
  if (err) return (int)err;
  stream_finish<<<(a.n_blocks * BLOCK + 255) / 256, 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* grt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
