// Temporal absolute-difference envelope for Hopper (sm_90a), batched.
//
//   y[b, t] = sum_e |x[b, t+1, e] - x[b, t, e]|   for t < T - 1,
//   y[b, T-1] = y[b, T-2]
//
// x is (B, T, E) float32, contiguous; y is (B, T) float32.
//
// Replaces the TPU kernel ssar_tpu/ops/absdiff.py (_absdiff_kernel, launched
// by absdiff_pallas), which accumulates element blocks into a time block by
// revisiting the output block along a sequential grid axis.  Blocks on this
// card run in no order, so each block owns whole output rows instead and
// reduces them itself: no atomics, a fixed summation order, and two runs agree
// bit for bit.  The batch (the TPU code's vmap) is the grid's second axis, so
// one launch serves a whole batch.
//
// What bounds it on this card: bytes.  One subtraction, one absolute value and
// one add per element against 4 bytes read, far below the card's ~20 fp32
// operations per byte of device memory bandwidth.
//
// Design: block (chunk, b) handles TC consecutive differences t0 .. t0+TC-1.
// Its threads stride along e (coalesced loads); each thread walks down the
// TC + 1 rows of its columns keeping the previous row's value in a register,
// so x is read once (plus one shared boundary row per chunk) and is never
// copied into padded operand arrays.  Each thread keeps TC partial sums; a warp
// butterfly and then a fixed-order sum over the block's warps finish them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTC = 8;  // differences (output rows) per block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
absdiff_kernel(const float* __restrict__ x, float* __restrict__ y, int T, long long E) {
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTC;
  const int n = min(kTC, T - 1 - t0);  // differences in this chunk (>= 1)
  const float* xb = x + static_cast<long long>(b) * T * E + static_cast<long long>(t0) * E;

  float acc[kTC];
#pragma unroll
  for (int r = 0; r < kTC; ++r) acc[r] = 0.f;

  for (long long e = threadIdx.x; e < E; e += kThreads) {
    float prev = xb[e];
#pragma unroll
    for (int r = 0; r < kTC; ++r) {
      if (r < n) {
        const float cur = xb[static_cast<long long>(r + 1) * E + e];
        acc[r] += fabsf(cur - prev);
        prev = cur;
      }
    }
  }

  __shared__ float part[kTC][kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < kTC; ++r) {
    const float v = warp_sum(acc[r]);
    if (lane == 0) part[r][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < n) {
    const int r = threadIdx.x;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[r][w];
    float* yb = y + static_cast<long long>(b) * T;
    yb[t0 + r] = s;
    if (t0 + r == T - 2) yb[T - 1] = s;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Needs T >= 2 and E >= 1.
// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// after the launch.
extern "C" int ssar_absdiff_f32(const float* x, float* y, int B, int T, long long E, void* stream) {
  if (B <= 0 || T < 2 || E <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid((T - 1 + kTC - 1) / kTC, B);
  absdiff_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, y, T, E);
  return static_cast<int>(cudaGetLastError());
}
