// S4D Vandermonde kernel, forward and backward, for Hopper (sm_90a).
//
//   K[h, l] = 2 * sum_n exp(a[h,n] * l) * (cre[h,n] * cos(b[h,n] * l) - cim[h,n] * sin(b[h,n] * l))
//
// with a = Re(dt*A), b = Im(dt*A) and (cre, cim) the ZOH-scaled C, all (H, N)
// float32; K is (H, L) float32.  It is the real part of the S4D convolution
// kernel, reduced over N without ever building the (H, N, L) Vandermonde
// tensor.
//
// Replaces the TPU kernel ssar_tpu/ops/vandermonde.py (_vandermonde_kernel,
// launched by s4d_vandermonde_pallas).  The TPU backward is the VJP of the
// plain jnp version; here the backward is a kernel too, reducing over L:
//   dcre[h,n] =  2 sum_l g E c          dcim[h,n] = -2 sum_l g E s
//   da[h,n]   =  2 (cre Tc - cim Ts)    db[h,n]   = -2 (cre Ts + cim Tc)
// with E = exp(a l), c = cos(b l), s = sin(b l), g = dL/dK[h, l] and
// Tc = sum_l g l E c, Ts = sum_l g l E s.
//
// What bounds it on this card: the special-function unit (SFU, 16 results a
// clock an SM).  Each (h, n, l) term needs three transcendentals (exp, sin,
// cos) against 16 (H N + H L) bytes of device memory traffic; there are no
// tensor-core products here.  The design keeps the SFU the limit:
//
// * The angles are the reference's: a*l and b*l are single rounded fp32
//   products (__fmul_rn), as the plain version forms them; no recurrence
//   across l.  x = fl(b l) is reduced exactly to r in about [-pi, pi]:
//   k = round(x / 2pi) by the 1.5 * 2^23 rounding constant, then
//   r = x - k C1 - k C2 - k C3 (2pi = C1 + C2 + C3 + 4e-23), one fmaf each.
//   The first fmaf is exact (its result is below 4 in magnitude and a
//   multiple of 2^-22, as x and k C1 are), the two others round once each:
//   r is within 2.4e-7 of x - 2pi k.  Then __sincosf(r) is two SFU
//   operations (MUFU.SIN, MUFU.COS; absolute error ~4e-7 on [-pi, pi]) and
//   E = __expf(a l) the third (MUFU.EX2).  About 12 FMA-class instructions a
//   term, against ~55 for the full-range sincosf / expf of the first design.
// * Range: the reduction holds for |x| <= 2^20 (|k| < 2^18, where the
//   rounding constant is exact up to 2^22; r overshoots pi by at most 0.05,
//   from the rounding of 1/2pi).  A 3-minute track reaches |b l| ~ 8.5e4
//   (N = 64, L = 4320).  A term with |x| > 2^20 takes the full-range sincosf
//   inside the kernel.  The test is made once for a run of terms (a lane's
//   four l of one n; a lane's l of one chunk of g) on its largest |x|: a
//   test per term put each term in a branch of its own, which the compiler
//   does not interleave (19.4 us against 16.8 at (104, 32, 4320)).
// * Forward, filling the card at the training shape (104, 32, 192): four
//   neighbouring lanes split one output's sum over N (lane s takes n = s,
//   s + 4, ...) and each computes four neighbouring l, so a lane runs four
//   independent chains.  A two-step reduce-scatter across the four lanes
//   (three shuffles) leaves lane s with output l0 + s: a warp stores 32
//   consecutive outputs.  A block is four warps, one row and 128 l (208
//   blocks at the training shape; two warps and 312 blocks measured slower
//   at both shapes); it stages the row's (a, b, cre, cim) in shared memory
//   as one float4 an n, 256 n at a time.
// * Backward, one block per (h, 4 consecutive n): two warps per n stride
//   over l (64 lanes), g's row is staged in shared memory once per block (in
//   chunks of 4608 l: one chunk at a 3-minute track), each lane keeps four
//   sums, a butterfly shuffle and a two-warp sum in shared memory reduce
//   them in a fixed order.  L is never split across blocks, so there are no
//   atomics and no partial sums in device memory: 832 blocks at (104, 32, L)
//   fill 132 SMs at any L.
// * Both are deterministic (fixed reduction orders) and mask the ragged
//   edges of N and L by computing on a clamped index and not storing.
//   Neither needs N-sized shared memory, so N has no limit.
//
// With -DSSAR_HOST_EMULATION the file compiles as plain C++ and the entry
// points run the same kernel bodies block by block on host threads (see
// host_emulation.h), so the index arithmetic, the reduction orders and the
// fallback can be checked without a card.

#ifdef SSAR_HOST_EMULATION
#include "host_emulation.h"
#else
#include <cuda_runtime.h>
#define SSAR_LAUNCH(kernel, blocks, threads, stream, ...) kernel<<<blocks, threads, 0, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroup = 4;                 // forward: lanes that share one output's sum over N
constexpr int kFwdWarps = 4;              // forward block: one row, 128 l
constexpr int kFwdCols = 32 * kFwdWarps;
constexpr int kFwdChunk = 256;            // n of the row staged in shared memory at a time
constexpr int kBwdN = 4;                  // backward block: one row, 4 n
constexpr int kBwdWarpsPerN = 2;          // 64 lanes along l per n
constexpr int kBwdLanes = 32 * kBwdWarpsPerN;
constexpr int kBwdThreads = kBwdLanes * kBwdN;
constexpr int kChunk = 4608;              // l of g staged in shared memory at a time (18 KB)

constexpr float kInv2Pi = 0.159154937f;
constexpr float kRound = 12582912.f;      // 1.5 * 2^23: x + kRound - kRound rounds x to an integer
constexpr float k2Pi1 = 6.28318548f;      // 2pi = k2Pi1 + k2Pi2 + k2Pi3 (+ 4e-23)
constexpr float k2Pi2 = -1.74845553e-7f;
constexpr float k2Pi3 = -6.86049804e-15f;
constexpr float kReduceMax = 1048576.f;   // 2^20

// sin and cos of x = fl(b l).  kReduced: exact reduction by 2pi and the SFU,
// for |x| <= kReduceMax; else the full-range sincosf (any x, inf and NaN).
// The caller tests the largest |x| of a run of terms once, so that a run's
// terms are straight-line code the compiler can interleave.
template <bool kReduced>
__device__ __forceinline__ void sincos_of_product(float x, float* s, float* c) {
  if (kReduced) {
    const float k = fmaf(x, kInv2Pi, kRound) - kRound;
    const float r = fmaf(-k, k2Pi3, fmaf(-k, k2Pi2, fmaf(-k, k2Pi1, x)));
    __sincosf(r, s, c);
  } else {
    sincosf(x, s, c);
  }
}

// The forward's four terms of one n: acc[p] += E (cre c - cim s) at lf[p].
template <bool kReduced>
__device__ __forceinline__ void fwd_terms(float4 q, const float* lf, float* acc) {
#pragma unroll
  for (int p = 0; p < kGroup; ++p) {
    const float e = __expf(__fmul_rn(q.x, lf[p]));
    float sn, cs;
    sincos_of_product<kReduced>(__fmul_rn(q.y, lf[p]), &sn, &cs);
    acc[p] = fmaf(e, q.z * cs - q.w * sn, acc[p]);
  }
}

__global__ void __launch_bounds__(32 * kFwdWarps)
vandermonde_fwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ cre, const float* __restrict__ cim,
                       float* __restrict__ out, int N, int L, int col_tiles) {
  __shared__ float4 row_s[kFwdChunk];  // (a, b, cre, cim) of one n
  const int lane = threadIdx.x % 32;
  const int s = lane % kGroup;
  const int h = static_cast<int>(blockIdx.x / col_tiles);
  const int l_warp = static_cast<int>(blockIdx.x % col_tiles) * kFwdCols + static_cast<int>(threadIdx.x / 32) * 32;
  const int l_first = l_warp + (lane / kGroup) * kGroup;  // this lane's kGroup neighbouring l
  float lf[kGroup], acc[kGroup];
#pragma unroll
  for (int p = 0; p < kGroup; ++p) {
    lf[p] = static_cast<float>(l_first + p);
    acc[p] = 0.f;
  }
  const long long row = static_cast<long long>(h) * N;
  for (int n0 = 0; n0 < N; n0 += kFwdChunk) {
    const int len = N - n0 < kFwdChunk ? N - n0 : kFwdChunk;
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < len; i += 32 * kFwdWarps) {
      const long long src = row + n0 + i;
      row_s[i] = make_float4(a[src], b[src], cre[src], cim[src]);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = s; j < len; j += kGroup) {
      const float4 q = row_s[j];
      if (fabsf(__fmul_rn(q.y, lf[kGroup - 1])) <= kReduceMax)  // the lane's largest |b l|
        fwd_terms<true>(q, lf, acc);
      else
        fwd_terms<false>(q, lf, acc);
    }
  }
  // reduce-scatter over the group: after the step across lanes s ^ 2 a lane
  // holds two outputs' half sums, after the step across s ^ 1 its own output
  // l_first + s, as ((s0 + s2) + (s1 + s3)) for every output.
  const bool hi = s & 2, lo = s & 1;
  float half[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = hi ? acc[i + 2] : acc[i];
    const float send = hi ? acc[i] : acc[i + 2];
    half[i] = keep + __shfl_xor_sync(kFull, send, 2);
  }
  const float keep = lo ? half[1] : half[0];
  const float send = lo ? half[0] : half[1];
  const float sum = keep + __shfl_xor_sync(kFull, send, 1);
  const int l = l_warp + lane;
  if (l < L) out[static_cast<long long>(h) * L + l] = 2.f * sum;
}

// The backward's terms of one lane over one staged chunk of g: l = c0 + i for
// i = phase, phase + kBwdLanes, ... < len (lf is c0 + phase, stepped exactly).
template <bool kReduced>
__device__ __forceinline__ void bwd_terms(const float* gs, int phase, int len, float lf, float av, float bv,
                                          float& sc, float& ss, float& tc, float& ts) {
#pragma unroll 4
  for (int i = phase; i < len; i += kBwdLanes, lf += static_cast<float>(kBwdLanes)) {
    const float ge = gs[i] * __expf(__fmul_rn(av, lf));
    float sn, cs;
    sincos_of_product<kReduced>(__fmul_rn(bv, lf), &sn, &cs);
    sc = fmaf(ge, cs, sc);
    ss = fmaf(ge, sn, ss);
    const float gl = ge * lf;
    tc = fmaf(gl, cs, tc);
    ts = fmaf(gl, sn, ts);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kBwdThreads)
vandermonde_bwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ cre, const float* __restrict__ cim,
                       const float* __restrict__ g, float* __restrict__ da, float* __restrict__ db,
                       float* __restrict__ dcre, float* __restrict__ dcim, int N, int L, int n_tiles) {
  __shared__ float gs[kChunk];
  __shared__ float part[kBwdN][kBwdWarpsPerN][4];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int h = static_cast<int>(blockIdx.x / n_tiles);
  const int n0 = static_cast<int>(blockIdx.x % n_tiles) * kBwdN;
  const int n_local = warp / kBwdWarpsPerN;
  const int phase = (warp % kBwdWarpsPerN) * 32 + lane;
  // a warp past the row's last n computes on the last one and stores nothing
  const int n = n0 + n_local < N ? n0 + n_local : N - 1;
  const long long pair = static_cast<long long>(h) * N + n;
  const float av = a[pair], bv = b[pair];
  const float* gh = g + static_cast<long long>(h) * L;

  float sc = 0.f, ss = 0.f, tc = 0.f, ts = 0.f;
  for (int c0 = 0; c0 < L; c0 += kChunk) {
    const int len = L - c0 < kChunk ? L - c0 : kChunk;
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < len; i += kBwdThreads) gs[i] = gh[c0 + i];
    __syncthreads();
    const float lf = static_cast<float>(c0 + phase);
    if (fabsf(__fmul_rn(bv, static_cast<float>(c0 + len - 1))) <= kReduceMax)  // the chunk's largest |b l|
      bwd_terms<true>(gs, phase, len, lf, av, bv, sc, ss, tc, ts);
    else
      bwd_terms<false>(gs, phase, len, lf, av, bv, sc, ss, tc, ts);
  }
  sc = warp_sum(sc);
  ss = warp_sum(ss);
  tc = warp_sum(tc);
  ts = warp_sum(ts);
  if (lane == 0) {
    float* dst = part[n_local][warp % kBwdWarpsPerN];
    dst[0] = sc;
    dst[1] = ss;
    dst[2] = tc;
    dst[3] = ts;
  }
  __syncthreads();
  if (tid < kBwdN && n0 + tid < N) {
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int w = 0; w < kBwdWarpsPerN; ++w)
      for (int j = 0; j < 4; ++j) sum[j] += part[tid][w][j];
    const long long out = static_cast<long long>(h) * N + n0 + tid;
    const float cr = cre[out], ci = cim[out];
    dcre[out] = 2.f * sum[0];
    dcim[out] = -2.f * sum[1];
    da[out] = 2.f * (cr * sum[2] - ci * sum[3]);
    db[out] = -2.f * (cr * sum[3] + ci * sum[2]);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  All arrays are contiguous
// float32 on the device: a, b, cre, cim and the gradients (H, N); out and g
// (H, L).  They launch on `stream`, do not synchronise, allocate nothing, and
// return cudaGetLastError() after the launch.
extern "C" int ssar_s4d_vandermonde_fwd_f32(const float* a, const float* b, const float* cre,
                                            const float* cim, float* out, int H, int N, int L,
                                            void* stream) {
  if (H <= 0 || N <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int col_tiles = (L + kFwdCols - 1) / kFwdCols;
  const long long blocks = static_cast<long long>(H) * col_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  SSAR_LAUNCH(vandermonde_fwd_kernel, static_cast<unsigned>(blocks), 32 * kFwdWarps,
              static_cast<cudaStream_t>(stream), a, b, cre, cim, out, N, L, col_tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ssar_s4d_vandermonde_bwd_f32(const float* a, const float* b, const float* cre,
                                            const float* cim, const float* g, float* da, float* db,
                                            float* dcre, float* dcim, int H, int N, int L,
                                            void* stream) {
  if (H <= 0 || N <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (N + kBwdN - 1) / kBwdN;
  const long long blocks = static_cast<long long>(H) * n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  SSAR_LAUNCH(vandermonde_bwd_kernel, static_cast<unsigned>(blocks), kBwdThreads,
              static_cast<cudaStream_t>(stream), a, b, cre, cim, g, da, db, dcre, dcim, N, L, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
