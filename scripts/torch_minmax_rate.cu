// Throughput of fp32 min/max, compare-select and the special-function unit's
// sine and exp2 against fmaf on one card: every thread of a full grid (8
// blocks of 256 threads an SM's worth of blocks) runs `iters` rounds of 8
// independent operations on registers.  OP 5 is one term of the S4D
// Vandermonde forward as csrc/s4d_vandermonde.cu computes it (exp, the exact
// reduction of b l by 2pi, sin and cos on the SFU, the multiply-adds).
// Built and timed by scripts/bench_torch_minmax_rate.py.
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
      if (OP == 3) a[i] = __sinf(a[i]);                                         // MUFU.SIN (+ its FMUL)
      if (OP == 4) a[i] = __expf(a[i]) - 0.5f;                                  // MUFU.EX2 (+ FMUL, FADD)
      if (OP == 5) {                                                            // 3 MUFU + ~11 FMA-class
        const float lf = static_cast<float>(it * 8 + i);
        const float e = __expf(__fmul_rn(-1e-3f, lf));
        const float x = __fmul_rn(b, lf);
        const float k = fmaf(x, 0.159154937f, 12582912.f) - 12582912.f;
        float sn, cs;
        __sincosf(fmaf(-k, -1.74845553e-7f, fmaf(-k, 6.28318548f, x)), &sn, &cs);
        a[i] = fmaf(e, 0.3f * cs - 0.2f * sn, a[i]);
      }
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
  else if (op == 2) rate_kernel<2><<<blocks, 256, 0, s>>>(out, iters);
  else if (op == 3) rate_kernel<3><<<blocks, 256, 0, s>>>(out, iters);
  else if (op == 4) rate_kernel<4><<<blocks, 256, 0, s>>>(out, iters);
  else rate_kernel<5><<<blocks, 256, 0, s>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
