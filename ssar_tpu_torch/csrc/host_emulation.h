// Compiles a .cu of this directory as plain C++20 (g++ -x c++ -std=c++20
// -pthread -DSSAR_HOST_EMULATION) and runs its kernels on the host: one
// std::thread per CUDA thread, one block after another, __syncthreads() as a
// barrier, __shared__ as a function-local static.  Slow (hundreds of threads
// a block), so for small shapes only: it checks a kernel's index arithmetic
// and selection logic against the plain PyTorch version where there is no
// card.  It says nothing about whether nvcc accepts the source or how fast
// the kernel is.
#pragma once

#include <barrier>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline __attribute__((always_inline))
#define __noinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

struct EmulatedIndex { unsigned x, y, z; };
inline thread_local EmulatedIndex threadIdx, blockIdx;
inline std::barrier<>* emulated_block_barrier = nullptr;
inline void __syncthreads() { emulated_block_barrier->arrive_and_wait(); }

inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }

// The fast intrinsics, correctly rounded here: the emulation checks what a
// kernel computes with them, not the SFU's error.  sincosf, fmaf and fabsf
// are the C library's.
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __expf(float x) { return std::exp(x); }
inline void __sincosf(float x, float* s, float* c) { *s = std::sin(x); *c = std::cos(x); }

// A warp shuffle as an exchange between two block-wide barrier waits: every
// thread of the block must reach it, as every thread of a warp must on the
// card (full mask).  Blocks are whole warps.
inline float emulated_exchange[1024];
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const unsigned t = threadIdx.x;
  emulated_exchange[t] = v;
  __syncthreads();
  const float other = emulated_exchange[(t & ~31u) | ((t % 32) ^ static_cast<unsigned>(lane_mask))];
  __syncthreads();
  return other;
}

template <typename Body>
void emulate_launch(unsigned blocks, unsigned threads, Body body) {
  for (unsigned b = 0; b < blocks; ++b) {
    std::barrier<> barrier(threads);
    emulated_block_barrier = &barrier;
    std::vector<std::thread> pool;
    for (unsigned t = 0; t < threads; ++t)
      pool.emplace_back([=] { threadIdx = {t, 0, 0}; blockIdx = {b, 0, 0}; body(); });
    for (auto& th : pool) th.join();
  }
}

#define SSAR_LAUNCH(kernel, blocks, threads, stream, ...) \
  emulate_launch(blocks, threads, [=] { kernel(__VA_ARGS__); })
