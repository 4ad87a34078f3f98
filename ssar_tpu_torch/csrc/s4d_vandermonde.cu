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
//   da[h,n]   =  2 sum_l g l E (cre c - cim s)
//   db[h,n]   = -2 sum_l g l E (cre s + cim c)
// with E = exp(a l), c = cos(b l), s = sin(b l), g = dL/dK[h, l].
//
// What bounds it on this card: operations.  Each (h, n, l) term costs three
// transcendentals (exp, sin, cos) and about eight fp32 multiply-adds, against
// 16 (H N + H L) bytes of device memory traffic.  There are no tensor-core
// products here: it is work for the special-function and FMA units.
//
// Accuracy: |b l| reaches ~2e3 rad at the training shape and more on a long
// track, so the kernel uses the full-range expf / sincosf (no __sinf, no
// --use_fast_math) and forms a*l and b*l as single rounded fp32 products
// (__fmul_rn), as the reference does, so both sides round alike.
//
// Design: forward, one thread per output (h, l), threads of a warp along l so
// stores coalesce; the block's (HB, N) rows of the four inputs are staged in
// shared memory once and read as broadcasts.  Backward, one warp per (h, n):
// lanes stride over l (coalesced reads of g), each lane keeps four partial
// sums, and a butterfly shuffle reduces them in a fixed order, so two runs
// agree bit for bit.  Both mask the ragged edges of H and L.

#include <cuda_runtime.h>

namespace {

constexpr int kFwdTL = 128;   // threads along l
constexpr int kFwdHB = 2;     // rows of H per block
constexpr int kBwdWarps = 8;  // (h, n) pairs per block

__global__ void __launch_bounds__(kFwdTL * kFwdHB)
vandermonde_fwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ cre, const float* __restrict__ cim,
                       float* __restrict__ out, int H, int N, int L) {
  extern __shared__ float smem[];  // 4 x (HB, N)
  float* sa = smem;
  float* sb = sa + kFwdHB * N;
  float* sr = sb + kFwdHB * N;
  float* si = sr + kFwdHB * N;

  const int h0 = blockIdx.y * kFwdHB;
  const int tid = threadIdx.y * kFwdTL + threadIdx.x;
  for (int i = tid; i < kFwdHB * N; i += kFwdTL * kFwdHB) {
    const int h = h0 + i / N;
    const bool ok = h < H;
    const long long src = static_cast<long long>(h) * N + i % N;
    sa[i] = ok ? a[src] : 0.f;
    sb[i] = ok ? b[src] : 0.f;
    sr[i] = ok ? cre[src] : 0.f;
    si[i] = ok ? cim[src] : 0.f;
  }
  __syncthreads();

  const int h = h0 + threadIdx.y;
  const int l = blockIdx.x * kFwdTL + threadIdx.x;
  if (h >= H || l >= L) return;
  const float lf = static_cast<float>(l);
  const int row = threadIdx.y * N;
  float acc = 0.f;
  for (int n = 0; n < N; ++n) {
    const float env = expf(__fmul_rn(sa[row + n], lf));
    float s, c;
    sincosf(__fmul_rn(sb[row + n], lf), &s, &c);
    acc += env * (sr[row + n] * c - si[row + n] * s);
  }
  out[static_cast<long long>(h) * L + l] = 2.f * acc;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(32 * kBwdWarps)
vandermonde_bwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ cre, const float* __restrict__ cim,
                       const float* __restrict__ g, float* __restrict__ da, float* __restrict__ db,
                       float* __restrict__ dcre, float* __restrict__ dcim, int H, int N, int L) {
  const long long pair = static_cast<long long>(blockIdx.x) * kBwdWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pair >= static_cast<long long>(H) * N) return;  // whole warps leave together
  const int h = static_cast<int>(pair / N);
  const float av = a[pair], bv = b[pair], cr = cre[pair], ci = cim[pair];
  const float* gh = g + static_cast<long long>(h) * L;

  float s_re = 0.f, s_im = 0.f, s_a = 0.f, s_b = 0.f;
  for (int l = lane; l < L; l += 32) {
    const float lf = static_cast<float>(l);
    const float ge = gh[l] * expf(__fmul_rn(av, lf));
    float s, c;
    sincosf(__fmul_rn(bv, lf), &s, &c);
    s_re += ge * c;
    s_im += ge * s;
    const float gl = ge * lf;
    s_a += gl * (cr * c - ci * s);
    s_b += gl * (cr * s + ci * c);
  }
  s_re = warp_sum(s_re);
  s_im = warp_sum(s_im);
  s_a = warp_sum(s_a);
  s_b = warp_sum(s_b);
  if (lane == 0) {
    dcre[pair] = 2.f * s_re;
    dcim[pair] = -2.f * s_im;
    da[pair] = 2.f * s_a;
    db[pair] = -2.f * s_b;
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  All arrays are contiguous
// float32 on the device: a, b, cre, cim and the gradients (H, N); out and g
// (H, L).  They launch on `stream`, do not synchronise, and return
// cudaGetLastError() after the launch.
extern "C" int ssar_s4d_vandermonde_fwd_f32(const float* a, const float* b, const float* cre,
                                            const float* cim, float* out, int H, int N, int L,
                                            void* stream) {
  if (H <= 0 || N <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kFwdTL, kFwdHB);
  const dim3 grid((L + kFwdTL - 1) / kFwdTL, (H + kFwdHB - 1) / kFwdHB);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = 4u * kFwdHB * static_cast<size_t>(N) * sizeof(float);
  if (smem > 48u * 1024u) return static_cast<int>(cudaErrorInvalidValue);
  vandermonde_fwd_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      a, b, cre, cim, out, H, N, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ssar_s4d_vandermonde_bwd_f32(const float* a, const float* b, const float* cre,
                                            const float* cim, const float* g, float* da, float* db,
                                            float* dcre, float* dcim, int H, int N, int L,
                                            void* stream) {
  if (H <= 0 || N <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = static_cast<long long>(H) * N;
  const long long blocks = (pairs + kBwdWarps - 1) / kBwdWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  vandermonde_bwd_kernel<<<static_cast<unsigned>(blocks), 32 * kBwdWarps, 0,
                           static_cast<cudaStream_t>(stream)>>>(a, b, cre, cim, g, da, db, dcre,
                                                                 dcim, H, N, L);
  return static_cast<int>(cudaGetLastError());
}
