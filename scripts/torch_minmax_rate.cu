// Throughput of fp32 min/max and compare-select against fmaf on one card: every
// thread of a full grid (8 blocks of 256 threads an SM's worth of blocks) runs
// `iters` rounds of 8 independent operations on registers.  Built and timed
// by scripts/bench_torch_minmax_rate.py.
#include <cuda_runtime.h>

template <int OP>
__global__ void rate_kernel(float* out, int iters) {
  float a[8];
  for (int i = 0; i < 8; ++i) a[i] = threadIdx.x * 0.001f + i;
  float b = blockIdx.x * 1e-3f + 1.0001f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (OP == 0) a[i] = fmaf(a[i], b, 0.5f);                                  // 1 fma
      if (OP == 1) { a[i] = fminf(a[i], b); b = fmaxf(b, a[(i + 1) % 8]); }     // 1 min + 1 max
      if (OP == 2) a[i] = a[i] == b ? a[(i + 3) % 8] : a[i] + 1.f;              // 1 compare + 1 select + 1 add
    }
  }
  float s = b;
  for (int i = 0; i < 8; ++i) s += a[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// out: blocks * 256 floats.  Returns cudaGetLastError() after the launch.
extern "C" int ssar_rate_test(int op, float* out, int blocks, int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op == 0) rate_kernel<0><<<blocks, 256, 0, s>>>(out, iters);
  else if (op == 1) rate_kernel<1><<<blocks, 256, 0, s>>>(out, iters);
  else rate_kernel<2><<<blocks, 256, 0, s>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
