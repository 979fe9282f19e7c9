// reverse_harvest_levels: the per-level firefly-clamp recursion of a regen
// window, run backwards over the recorded bounce levels, writing each
// started path's radiance into its accumulator slot. For Hopper (sm_90a).
// Replaces the Pallas TPU kernel `reverse_harvest_levels`
// (go_raytracer_tpu/ops/pallas/harvest.py) together with the accumulator
// row scan that follows it (integrator/regen.py, write_row_ik).
//
// The recursion is independent per lane:
//     L = clamp?(emit ? V : V * L)      (camera.go:330-341)
// so one thread per lane walks the levels in reverse with L in registers.
// The TPU kernel compacts each level's started lanes into rows because its
// vector unit has no scatter; here a started lane writes L straight to
// acc[base[s] - item_base + rank], where rank is the lane's rank among the
// level's starts, carried in the flag word (bits 3..) by bounce_fused_q.
// Each item is written exactly once, so no atomics and no scan are needed.
//
// What bounds it: bytes. It reads 16 bytes per lane per recorded level
// (V r/g/b + flags, coalesced across the warp) and writes 12 bytes per
// started path; the loop over levels is sequential per lane, so with
// 131072 lanes the card has 512 blocks of 256 threads in flight.

#include <cuda_runtime.h>
#include <stdint.h>

struct HarvestArgs {
  const float* vr;
  const float* vg;
  const float* vb;
  const int* fl;    // (s_run, n)
  const int* base;  // (s_run,) item id of each level's first start
  float* acc;       // (rows, 3)
  long long item_base;
  int n;
  int s_run;
  int refill_levels;
  float max_contribution;
};

__global__ void __launch_bounds__(256) harvest_levels(HarvestArgs a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.n) return;
  const float maxc = a.max_contribution;
  float lr = 0.0f, lg = 0.0f, lb = 0.0f;
  for (int s = a.s_run - 1; s >= 0; --s) {
    const size_t i = (size_t)s * a.n + lane;
    const int fl = __ldg(a.fl + i);
    const float vr = __ldg(a.vr + i), vg = __ldg(a.vg + i), vb = __ldg(a.vb + i);
    const bool emit = (fl & 2) != 0;
    // __fmul_rn keeps nvcc from fusing these products into the sum below,
    // so the kernel rounds exactly as the plain version does
    const float rr = emit ? vr : __fmul_rn(vr, lr);
    const float rg = emit ? vg : __fmul_rn(vg, lg);
    const float rb = emit ? vb : __fmul_rn(vb, lb);
    // NaN sums compare false and pass unclamped (Go parity)
    const float sum = rr + rg + rb;
    const float scale = ((fl & 1) != 0 && sum > maxc) ? maxc / sum : 1.0f;
    lr = __fmul_rn(rr, scale);
    lg = __fmul_rn(rg, scale);
    lb = __fmul_rn(rb, scale);
    if ((fl & 4) != 0 && s < a.refill_levels) {
      const long long row = (long long)__ldg(a.base + s) - a.item_base + (fl >> 3);
      float* dst = a.acc + row * 3;
      dst[0] = lr;
      dst[1] = lg;
      dst[2] = lb;
      lr = 0.0f;
      lg = 0.0f;
      lb = 0.0f;
    }
  }
}

extern "C" int grt_harvest_levels(const HarvestArgs* args, void* stream) {
  const HarvestArgs a = *args;
  const int threads = 256;
  harvest_levels<<<(a.n + threads - 1) / threads, threads, 0,
                   (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* grt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
