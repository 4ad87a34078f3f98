// Compiles a .cu of this directory as plain C++20 (g++ -x c++ -std=c++20
// -pthread -DSSAR_HOST_EMULATION) and runs its kernels on the host: one
// std::thread per CUDA thread, one block after another, __syncthreads() as a
// barrier, __shared__ as a function-local static.  Slow (hundreds of threads
// a block), so for small shapes only: it checks a kernel's index arithmetic
// and selection logic against the plain PyTorch version where there is no
// card.  It says nothing about whether nvcc accepts the source or how fast
// the kernel is.
#pragma once

#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
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
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
template <typename Kernel> inline cudaError_t cudaFuncSetAttribute(Kernel, int, int) { return cudaSuccess; }

struct EmulatedIndex { unsigned x, y, z; };
inline thread_local EmulatedIndex threadIdx, blockIdx, blockDim, gridDim;
inline std::barrier<>* emulated_block_barrier = nullptr;
inline void __syncthreads() { emulated_block_barrier->arrive_and_wait(); }
// One barrier per warp: every lane of the warp must reach __syncwarp, as the
// full mask asks on the card.  Blocks are whole warps.
inline std::deque<std::barrier<>>* emulated_warp_barriers = nullptr;
inline void __syncwarp(unsigned = 0xffffffffu) { (*emulated_warp_barriers)[threadIdx.x / 32].arrive_and_wait(); }

// A launch's dynamic shared memory: one buffer, since blocks run one after
// another, filled with 0xff bytes (NaN as a float) so that a value read
// before it is written shows.
inline std::vector<unsigned char> emulated_dynamic_shared;
#define SSAR_DYNAMIC_SHARED(type, name) type* name = reinterpret_cast<type*>(emulated_dynamic_shared.data())

inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }

// Loads through the read-only and the L2-only paths are plain loads here.
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
template <typename T> inline T __ldg(const T* p) { return *p; }
template <typename T> inline T __ldcg(const T* p) { return *p; }

// Blocks run one after another, so the fence and the ticket are trivial;
// they are real atomics all the same.
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }

// 16-bit float storage: exact widening to float, and round to nearest even
// from float (what the card's __float2half_rn / __float2bfloat16_rn and
// PyTorch's .to(dtype) do), subnormals, infinities and NaN included.
struct __half { unsigned short x; };
struct __nv_bfloat16 { unsigned short x; };
inline __half __ushort_as_half(unsigned short b) { return {b}; }
inline unsigned short __half_as_ushort(__half h) { return h.x; }
inline __nv_bfloat16 __ushort_as_bfloat16(unsigned short b) { return {b}; }
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) { return h.x; }
inline float __bfloat162float(__nv_bfloat16 h) { return __uint_as_float(static_cast<unsigned>(h.x) << 16); }
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {static_cast<unsigned short>((u >> 16) | 0x40u)};  // quiet NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<unsigned short>(u >> 16)};
}
inline float __half2float(__half h) {
  const unsigned sign = (h.x & 0x8000u) << 16, exp = (h.x >> 10) & 0x1fu, man = h.x & 0x3ffu;
  if (exp == 0x1f) return __uint_as_float(sign | 0x7f800000u | (man << 13));
  if (exp == 0) return __uint_as_float(sign | __float_as_uint(std::ldexp(static_cast<float>(man), -24)));
  return __uint_as_float(sign | ((exp + 112u) << 23) | (man << 13));
}
inline __half __float2half_rn(float f) {
  unsigned u = __float_as_uint(f);
  const unsigned sign = (u >> 16) & 0x8000u;
  u &= 0x7fffffffu;
  if (u > 0x7f800000u) return {static_cast<unsigned short>(sign | 0x7e00u)};  // NaN
  if (u >= 0x477ff000u) return {static_cast<unsigned short>(sign | 0x7c00u)};  // 65520 and up: infinity
  if (u < 0x38800000u) {  // below 2^-14: a subnormal half (or its smallest normal), round(|f| 2^24)
    const float m = std::nearbyint(std::ldexp(__uint_as_float(u), 24));
    return {static_cast<unsigned short>(sign | static_cast<unsigned>(m))};
  }
  u -= 112u << 23;  // rebias the exponent, then round away 13 bits
  u += 0xfffu + ((u >> 13) & 1u);
  return {static_cast<unsigned short>(sign | (u >> 13))};
}

// The fast intrinsics, correctly rounded here: the emulation checks what a
// kernel computes with them, not the SFU's error.  sincosf, fmaf and fabsf
// are the C library's.
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned shift) {
  return static_cast<unsigned>(((static_cast<unsigned long long>(hi) << 32) | lo) >> (shift & 31));
}
inline unsigned __umulhi(unsigned a, unsigned b) {
  return static_cast<unsigned>((static_cast<unsigned long long>(a) * b) >> 32);
}
inline float __fadd_rn(float a, float b) { return a + b; }
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
    std::deque<std::barrier<>> warp_barriers;
    for (unsigned w = 0; w < threads / 32; ++w) warp_barriers.emplace_back(32);
    emulated_warp_barriers = &warp_barriers;
    std::vector<std::thread> pool;
    for (unsigned t = 0; t < threads; ++t)
      pool.emplace_back([=] {
        threadIdx = {t, 0, 0}; blockIdx = {b, 0, 0}; blockDim = {threads, 1, 1}; gridDim = {blocks, 1, 1};
        body();
      });
    for (auto& th : pool) th.join();
  }
}

#define SSAR_LAUNCH(kernel, blocks, threads, stream, ...) \
  emulate_launch(blocks, threads, [=] { kernel(__VA_ARGS__); })
#define SSAR_LAUNCH_DYNAMIC(kernel, blocks, threads, bytes, stream, ...) \
  (emulated_dynamic_shared.assign(bytes, 0xff), emulate_launch(blocks, threads, [=] { kernel(__VA_ARGS__); }))
