// StyleGAN2's styled-conv epilogue as one kernel a layer (E1), for Hopper (sm_90a).
//
// Every styled conv of StyleGAN2 (ssar_tpu_torch/gan/stylegan2.py:styled_conv)
// ends, after its convolution, in
//   up-conv only: pad and the 4 x 4 blur (the flipped separable taps of
//                 make_blur_kernel(k) * 4) over the transposed conv's
//                 (2H + 1)^2 output, giving 2H x 2H;
//   * demod[b, c] + noise_weight * noise[b, y, x] + bias[c], then the leaky
//   ReLU (0.2) and the gain sqrt(2).
// The plain version (ssar_tpu_torch/ops/styled_epilogue.py:plain) runs that
// as separate PyTorch passes, a padded copy, a depthwise convolution and five
// elementwise passes, each reading and writing the whole activation and
// rounding it to the synthesis dtype; it is the CPU path and the card tests'
// reference.
//
// Replaces no TPU kernel: the JAX package leaves this work to XLA, which
// fuses it (ssar_tpu/gan/stylegan2.py, ssar_tpu/ops/upfirdn.py).  It was added
// because those passes took ~60 % of the long-form StyleGAN2 cell's device
// time at ~6 % of their byte bound (PERF.md §5).
//
// What bounds it: HBM.  A layer reads the convolution's output once, writes
// the activation once and reads the noise (shared by a sample's channels,
// from L2).  Two kernels, chosen by the layer:
//   pointwise_kernel (no up): each thread takes 16-byte vectors of one row
//     (8 samples of a 16-bit layer, 4 of a float32 one), reads them and the
//     noise with 16-byte loads (a noise whose columns are not adjacent one
//     sample at a time), and writes the result with one 16-byte store (one
//     sample at a time where the row is not a whole number of vectors);
//   blur_kernel (up): a block takes a 64 x 64 tile of the output of one
//     (sample, channel) plane, or, where a plane's output fits 8, 16 or 32 a
//     side, 64, 16 or 4 whole planes.  It copies the 16-byte chunks of y
//     that hold the input tile and its halo (K - 1 rows and columns) into
//     shared memory as they lie (cp.async: no registers, every copy of the
//     block in flight at once), zeros the rows and columns outside the
//     plane, and then a thread takes 4 neighbouring columns and a run of 8
//     rows: for each staged row it reaches it loads the K + 3 samples as
//     words (a funnel shift realigns a row that starts on an odd sample),
//     blurs them along W into 4 float32 values, which stream through
//     registers into the run's accumulators along H, applies the epilogue
//     and writes each row's 4 outputs with one store (a warp's stores are
//     whole 128-byte lines).
// The scalars (demod, bias, noise_weight) are read from device memory by
// pointer; nothing is read back to the host.  The blur's taps are the
// launch's parameters.  Arithmetic is float32 with one rounding to the output
// dtype (float32, float16 or bfloat16); the gain is folded into the
// demodulation, the noise's weight and the bias.  Offsets are 64-bit.
//
// With -DSSAR_HOST_EMULATION the file compiles as plain C++ and the entry
// point runs the same kernel bodies block by block on host threads (see
// host_emulation.h), so the index arithmetic can be checked without a card.

#ifdef SSAR_HOST_EMULATION
#include "host_emulation.h"
#else
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#define SSAR_LAUNCH(kernel, blocks, threads, stream, ...) kernel<<<blocks, threads, 0, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kMaxTaps = 8;
constexpr int kThreads = 128;

// The blur's 1-D taps, flipped and times 2 (each axis's share of the gain 4).
struct EpTaps {
  float t[kMaxTaps];
};

struct EpArgs {
  const void* y;              // (planes, ih, iw), contiguous
  void* out;                  // (planes, oh, ow), contiguous
  const float* demod;         // (planes,) or null
  const void* noise;          // (planes / channels, oh, ow) by its strides, or null
  const float* noise_weight;  // 0-d, read when noise is not null
  const float* bias;          // (channels,) or null
  long long noise_sb, noise_sy, noise_sx;   // the noise's strides: sample (0: shared), row, column
  int channels, ih, iw, oh, ow;
  int pad0, ntaps;            // blur only: samples padded before the first, taps
  int tiles_x, tiles_y;       // blur only
  long long planes, n_total;  // blur only: planes, and samples of y in all
  int y_shift;                // blur only: y's samples past the 16-byte boundary before it
  unsigned nvec;              // pointwise only: vectors in all
  int vec_noise;              // noise read as whole vectors
  int vec_out;                // blur only: outputs written as whole chunks
  float slope, gain;
};

// n / d for n < 2^31 by a multiply and a shift (the divisor's magic number
// computed once on the host), as PyTorch's IntDivider does.
struct FastDiv {
  unsigned d, m, s;
};

FastDiv make_fastdiv(unsigned d) {
  unsigned s = 0;
  while (s < 32 && (1ull << s) < d) ++s;
  const unsigned long long m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {d, static_cast<unsigned>(m), s};
}

__device__ __forceinline__ unsigned fdiv(const FastDiv& f, unsigned n) { return (__umulhi(n, f.m) + n) >> f.s; }

// Storage of a dtype: its bits, and float32 to and from them.
struct F32 {
  using S = float;
  static __device__ __forceinline__ float get(float v) { return v; }
  static __device__ __forceinline__ float put(float v) { return v; }
};
struct F16 {
  using S = unsigned short;
  static __device__ __forceinline__ float get(S v) { return __half2float(__ushort_as_half(v)); }
  static __device__ __forceinline__ S put(float v) { return __half_as_ushort(__float2half_rn(v)); }
};
struct BF16 {
  using S = unsigned short;
  static __device__ __forceinline__ float get(S v) { return __uint_as_float(static_cast<unsigned>(v) << 16); }
  static __device__ __forceinline__ S put(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }
};

// Element k of n 32-bit words holding samples of storage S (16-bit samples
// two a word, the lower first), and the words back.
template <class P, int N>
__device__ __forceinline__ float word_elem(const unsigned (&w)[N], int k) {
  if constexpr (sizeof(typename P::S) == 4) {
    return __uint_as_float(w[k]);
  } else {
    return P::get(static_cast<unsigned short>(k % 2 ? w[k / 2] >> 16 : w[k / 2] & 0xffffu));
  }
}

template <class P, int N>
__device__ __forceinline__ void word_set(unsigned (&w)[N], int k, float v) {
  if constexpr (sizeof(typename P::S) == 4) {
    w[k] = __float_as_uint(P::put(v));
  } else {
    const unsigned bits = P::put(v);
    w[k / 2] = k % 2 ? (w[k / 2] & 0xffffu) | (bits << 16) : (w[k / 2] & 0xffff0000u) | bits;
  }
}

// a sample's bits as a word (a 16-bit sample in the lower half)
__device__ __forceinline__ unsigned bits_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned bits_of(unsigned short v) { return v; }

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// a 16-byte vector as 4 words, and back
__device__ __forceinline__ void load16(unsigned (&w)[4], const void* p) {
  const uint4 v = *static_cast<const uint4*>(p);
  w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
}
__device__ __forceinline__ void store16(void* p, const unsigned (&w)[4]) {
  uint4 v;
  v.x = w[0], v.y = w[1], v.z = w[2], v.w = w[3];
  *static_cast<uint4*>(p) = v;
}

// the epilogue of one sample: demodulation, noise, bias, leaky ReLU, gain.
// The gain (> 0) is folded into the demodulation, the noise's weight and
// the bias (dg, wg, bg), so for a slope in [0, 1] gain * lrelu(u) is the
// larger of u and slope u; NaN stays NaN
__device__ __forceinline__ float epilogue(float v, float dg, float wg, float n, float bg, float slope) {
  const float u = fmaf(v, dg, fmaf(wg, n, bg));
  return fmaxf(u, u * slope);
}

// ------------------------------------------------------------- pointwise --
// V samples a vector (16 bytes, or 1); kItems vectors a thread, in flight
// together.
constexpr int kItems = 4;

template <class P, int V>
__global__ void __launch_bounds__(kThreads) pointwise_kernel(const EpArgs a, const FastDiv per_plane,
                                                             const FastDiv per_row, const FastDiv per_channel) {
  using S = typename P::S;
  constexpr bool kVec = V * sizeof(S) == 16;
  const S* y = static_cast<const S*>(a.y);
  S* out = static_cast<S*>(a.out);
  const S* noise = static_cast<const S*>(a.noise);
  const float wg = noise ? *a.noise_weight * a.gain : 0.0f;
  unsigned yw[kItems][4], nw[kItems][4];
  unsigned plane[kItems], col[kItems];
  const unsigned base = blockIdx.x * (kThreads * kItems) + threadIdx.x;
  // every load of the thread in flight before the first use
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const unsigned i = base + it * kThreads;
    if (i >= a.nvec) continue;
    plane[it] = fdiv(per_plane, i);
    const unsigned rem = i - plane[it] * per_plane.d;
    const unsigned row = fdiv(per_row, rem);
    col[it] = (rem - row * per_row.d) * V;
    const long long off = static_cast<long long>(i) * V;
    if constexpr (kVec) load16(yw[it], y + off);
    else yw[it][0] = bits_of(y[off]);
    if (noise) {
      const long long noff = fdiv(per_channel, plane[it]) * a.noise_sb + row * a.noise_sy + col[it] * a.noise_sx;
      bool whole = false;
      if constexpr (kVec) {
        if (a.vec_noise) load16(nw[it], noise + noff), whole = true;
      }
      if (!whole) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const unsigned bits = bits_of(noise[noff + k * a.noise_sx]);
          if constexpr (sizeof(S) == 4) nw[it][k] = bits;
          else nw[it][k / 2] = k % 2 ? (nw[it][k / 2] & 0xffffu) | (bits << 16) : bits;
        }
      }
    }
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const unsigned i = base + it * kThreads;
    if (i >= a.nvec) continue;
    const float dg = (a.demod ? a.demod[plane[it]] : 1.0f) * a.gain;
    const float bg = (a.bias ? a.bias[plane[it] - fdiv(per_channel, plane[it]) * per_channel.d] : 0.0f) * a.gain;
    unsigned ow[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float n = noise ? word_elem<P>(nw[it], k) : 0.0f;
      word_set<P>(ow, k, epilogue(word_elem<P>(yw[it], k), dg, wg, n, bg, a.slope));
    }
    const long long off = static_cast<long long>(i) * V;
    if constexpr (kVec) {
      store16(out + off, ow);
    } else if constexpr (sizeof(S) == 4) {
      out[off] = __uint_as_float(ow[0]);
    } else {
      out[off] = static_cast<S>(ow[0] & 0xffffu);
    }
  }
}

// ------------------------------------------------------------------ blur --
// A block: kTile x kTile outputs of one plane, or, for planes no larger than
// TS x TS (TS < kTile), (kTile / TS)^2 whole planes, a TS x TS subtile each.
// A thread: 4 columns (one chunk) and a run of kRY rows of one subtile.  KB
// taps (4), or 0: up to kMaxTaps, the count a runtime value.
constexpr int kTile = 64, kRY = 8, kCols = 4;

// y's 16 bytes at `src` into shared memory at `dst` without passing through
// registers (cp.async), the last 16 - bytes of them zeros; and the wait for
// a thread's copies
__device__ __forceinline__ void copy16_async(void* dst, const void* src, int bytes) {
#ifdef SSAR_HOST_EMULATION
  std::memcpy(dst, src, bytes);
  std::memset(static_cast<char*>(dst) + bytes, 0, 16 - bytes);
#else
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes) : "memory");
#endif
}
__device__ __forceinline__ void copies_wait() {
#ifndef SSAR_HOST_EMULATION
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
#endif
}

template <class P, int KB, int TS>
__global__ void __launch_bounds__(kThreads) blur_kernel(const EpArgs a, const EpTaps taps) {
  using S = typename P::S;
  constexpr int K = KB ? KB : kMaxTaps;          // the halo staged: K - 1
  constexpr int NSUB = (kTile / TS) * (kTile / TS);
  constexpr int XR = TS + K - 1, XW = TS + K - 1;
  constexpr int GX = TS / kCols, TASKS = GX * (TS / kRY);
  constexpr int EPC = 16 / sizeof(S);            // samples a 16-byte chunk of y
  constexpr int CPR = (XW + 2 * EPC - 2) / EPC;  // chunks a staged row can touch
  constexpr int RW = CPR * EPC;                  // a staged row: whole chunks of y as they lie
  constexpr int NX = kCols + K - 1;              // samples of a row a thread reads
  constexpr int NW = sizeof(S) == 4 ? NX : (NX + 2) / 2;   // words it loads for them
  static_assert(TASKS * NSUB == kThreads, "a task a thread");
  static_assert(EPC - 1 + kCols * (GX - 1) + (sizeof(S) == 4 ? NX : 2 * NW) <= RW, "reads stay in the row");
  alignas(16) __shared__ S X[NSUB * XR * RW];
  const int ntaps = KB ? KB : a.ntaps;

  const int tid = threadIdx.x;
  long long plane0;
  int oy0 = 0, ox0 = 0;
  if constexpr (NSUB == 1) {
    const long long tile = blockIdx.x;
    ox0 = static_cast<int>(tile % a.tiles_x) * TS;
    oy0 = static_cast<int>((tile / a.tiles_x) % a.tiles_y) * TS;
    plane0 = tile / (static_cast<long long>(a.tiles_x) * a.tiles_y);
  } else {
    plane0 = static_cast<long long>(blockIdx.x) * NSUB;
  }
  const int iy0 = oy0 - a.pad0, ix0 = ox0 - a.pad0;
  // staged rows and columns: those the subtile's outputs inside the plane reach
  const int rows = imin(XR, a.oh - oy0 + K - 1), cols = imin(XW, a.ow - ox0 + K - 1);
  const long long plane_size = static_cast<long long>(a.ih) * a.iw;
  const S* y = static_cast<const S*>(a.y) - a.y_shift;   // 16-byte aligned: sample f of y is y[f + y_shift]
  // the staged row r of subtile sub starts at sample rs of y (from the aligned
  // base), chunk rs / EPC at X's row start: column e lies at (rs mod EPC) + e
  const auto row_start = [&](long long plane, int gy) {
    return plane * plane_size + static_cast<long long>(gy) * a.iw + ix0 + a.y_shift;
  };

  // 1. each staged row's chunks of y, copied as they lie; rows outside the
  // plane and chunks holding none of the row's columns inside it are zeros
  for (int t = tid; t < NSUB * XR * CPR; t += kThreads) {
    const int sub = t / (XR * CPR), r = t / CPR % XR, j = t % CPR;
    if (r >= rows) continue;
    const long long plane = plane0 + sub, gy = iy0 + r;
    S* dst = X + (sub * XR + r) * RW + j * EPC;
    const long long rs = row_start(plane, static_cast<int>(gy)), c0 = ((rs >> (EPC == 8 ? 3 : 2)) + j) * EPC;
    const long long lo = rs - ix0 + (ix0 > 0 ? ix0 : 0), hi = rs - ix0 + (ix0 + cols < a.iw ? ix0 + cols : a.iw);
    if (plane < a.planes && gy >= 0 && gy < a.ih && c0 < hi && c0 + EPC > lo) {
      const long long end = a.n_total + a.y_shift;
      copy16_async(dst, y + c0, static_cast<int>(c0 + EPC <= end ? 16 : (end - c0) * sizeof(S)));
    } else {
      store16(dst, {0u, 0u, 0u, 0u});
    }
  }
  copies_wait();
  __syncthreads();
  // the columns of edge subtiles outside the plane, which the copies filled
  // from the neighbouring rows: zeros
  const int left = ix0 < 0 ? -ix0 : 0, right = a.iw - ix0 < cols ? cols - (a.iw - ix0) : 0;
  if (left + right > 0) {
    for (int t = tid; t < NSUB * XR * (left + right); t += kThreads) {
      const int sub = t / (XR * (left + right)), r = t / (left + right) % XR, k = t % (left + right);
      if (r >= rows) continue;
      const int e = k < left ? k : a.iw - ix0 + (k - left);
      const long long rs = row_start(plane0 + sub, iy0 + r);
      X[(sub * XR + r) * RW + static_cast<int>(rs & (EPC - 1)) + e] = S(0);
    }
    __syncthreads();
  }

  // 2. a thread's 4 columns and run of rows: blur along W each staged row it
  // reaches, stream the results into the run's accumulators along H
  const int sub = tid / TASKS, g = tid % TASKS % GX, q = tid % TASKS / GX;
  const long long plane = plane0 + sub;
  const int oy = oy0 + q * kRY, ox = ox0 + kCols * g;
  if (plane >= a.planes || oy >= a.oh || ox >= a.ow) return;
  float acc[kRY][kCols];
#pragma unroll
  for (int i = 0; i < kRY; ++i)
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[i][k] = 0.0f;
  // the rows' offsets mod EPC step by iw mod EPC: low bits of 32-bit sums suffice
  const unsigned off0 = static_cast<unsigned>(row_start(plane, iy0 + q * kRY));
#pragma unroll
  for (int s = 0; s < kRY + K - 1; ++s) {
    const int p = static_cast<int>((off0 + static_cast<unsigned>(s * a.iw)) & (EPC - 1)) + kCols * g;
    const S* row = X + (sub * XR + q * kRY + s) * RW;
    float x[NX];
    if constexpr (sizeof(S) == 4) {
#pragma unroll
      for (int k = 0; k < NX; ++k) x[k] = row[p + k];
    } else {
      const unsigned* wp = reinterpret_cast<const unsigned*>(row) + (p >> 1);
      unsigned w[NW];
#pragma unroll
      for (int i = 0; i < NW; ++i) w[i] = wp[i];
      const unsigned sh = (p & 1) * 16;   // an odd first sample: every sample a half word on
#pragma unroll
      for (int i = 0; i + 1 < NW; ++i) w[i] = __funnelshift_r(w[i], w[i + 1], sh);
      w[NW - 1] >>= sh;
#pragma unroll
      for (int k = 0; k < NX; ++k) x[k] = word_elem<P>(w, k);
    }
    float wsum[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      float v = 0.0f;
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (KB || j < ntaps) v = fmaf(taps.t[j], x[k + j], v);
      wsum[k] = v;
    }
#pragma unroll
    for (int i = 0; i < kRY; ++i) {
      const int t = s - i;
      if (t >= 0 && t < K && (KB || t < ntaps)) {
#pragma unroll
        for (int k = 0; k < kCols; ++k) acc[i][k] = fmaf(taps.t[t], wsum[k], acc[i][k]);
      }
    }
  }

  // 3. the epilogue, and one store a row where the chunk lies in the row
  const int c = static_cast<int>(plane % a.channels);
  const long long sample = plane / a.channels;
  const float dg = (a.demod ? a.demod[plane] : 1.0f) * a.gain;
  const float bg = (a.bias ? a.bias[c] : 0.0f) * a.gain;
  const float wg = a.noise ? *a.noise_weight * a.gain : 0.0f;
  const S* noise = static_cast<const S*>(a.noise);
  S* out = static_cast<S*>(a.out) + plane * a.oh * a.ow;
  const bool whole = ox + kCols <= a.ow;
#pragma unroll
  for (int i = 0; i < kRY; ++i) {
    const int r = oy + i;
    if (r >= a.oh) break;
    float n[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (noise) {
      const S* np = noise + sample * a.noise_sb + r * a.noise_sy + ox * a.noise_sx;
      if (whole && a.vec_noise) {
        if constexpr (sizeof(S) == 4) {
          unsigned w[4];
          load16(w, np);
#pragma unroll
          for (int k = 0; k < kCols; ++k) n[k] = word_elem<P>(w, k);
        } else {
          const uint2 v = *reinterpret_cast<const uint2*>(np);
          const unsigned w[2] = {v.x, v.y};
#pragma unroll
          for (int k = 0; k < kCols; ++k) n[k] = word_elem<P>(w, k);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kCols; ++k)
          if (ox + k < a.ow) n[k] = P::get(np[k * a.noise_sx]);
      }
    }
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < kCols; ++k) word_set<P>(w, k, epilogue(acc[i][k], dg, wg, n[k], bg, a.slope));
    S* dst = out + static_cast<long long>(r) * a.ow + ox;
    if (whole && a.vec_out) {
      if constexpr (sizeof(S) == 4) {
        store16(dst, w);
      } else {
        uint2 v;
        v.x = w[0], v.y = w[1];
        *reinterpret_cast<uint2*>(dst) = v;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        if (ox + k >= a.ow) break;
        if constexpr (sizeof(S) == 4) dst[k] = __uint_as_float(w[k]);
        else dst[k] = static_cast<S>(k % 2 ? w[k / 2] >> 16 : w[k / 2] & 0xffffu);
      }
    }
  }
}

bool aligned(const void* p, unsigned bytes) { return reinterpret_cast<unsigned long long>(p) % bytes == 0; }

template <class P>
int launch(EpArgs a, int up, const EpTaps& taps, long long planes, cudaStream_t stream) {
  using S = typename P::S;
  if (up) {
    // the subtile side: the smallest of 8, 16, 32 that holds a plane's output, else whole tiles
    const int side = a.oh > a.ow ? a.oh : a.ow;
    int ts = side <= 8 ? 8 : side <= 16 ? 16 : side <= 32 ? 32 : kTile;
    if (ts == 8 && sizeof(S) == 4 && a.ntaps != 4) ts = 16;   // its shared memory would pass 48 KB
    a.tiles_x = (a.ow + kTile - 1) / kTile;
    a.tiles_y = (a.oh + kTile - 1) / kTile;
    const long long nsub = (kTile / ts) * (kTile / ts);
    const long long blocks = ts == kTile ? planes * a.tiles_x * a.tiles_y : (planes + nsub - 1) / nsub;
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
    const unsigned chunk = kCols * sizeof(S);
    a.vec_out = a.ow % kCols == 0 && aligned(a.out, chunk);
    a.vec_noise = a.noise && a.noise_sx == 1 && aligned(a.noise, chunk) && a.noise_sb % kCols == 0 &&
                  a.noise_sy % kCols == 0;
    a.planes = planes;
    a.n_total = planes * a.ih * a.iw;
    a.y_shift = static_cast<int>(reinterpret_cast<unsigned long long>(a.y) % 16 / sizeof(S));
    const bool four = a.ntaps == 4;
    void (*kernel)(EpArgs, EpTaps) =
        ts == 8 ? (four ? blur_kernel<P, 4, 8> : blur_kernel<P, 0, sizeof(S) == 4 ? 16 : 8>)
        : ts == 16 ? (four ? blur_kernel<P, 4, 16> : blur_kernel<P, 0, 16>)
        : ts == 32 ? (four ? blur_kernel<P, 4, 32> : blur_kernel<P, 0, 32>)
                   : (four ? blur_kernel<P, 4, kTile> : blur_kernel<P, 0, kTile>);
    SSAR_LAUNCH(kernel, static_cast<unsigned>(blocks), kThreads, stream, a, taps);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int V = 16 / sizeof(S);
  const bool vec = a.ow % V == 0 && aligned(a.y, 16) && aligned(a.out, 16);
  const int v = vec ? V : 1;
  const long long nvec = planes * a.oh * a.ow / v;
  if (nvec >= 2147483648LL || static_cast<long long>(a.oh) * a.ow >= 2147483648LL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  a.nvec = static_cast<unsigned>(nvec);
  a.vec_noise = a.noise && a.noise_sx == 1 && aligned(a.noise, 16) && a.noise_sb % V == 0 && a.noise_sy % V == 0;
  const FastDiv per_plane = make_fastdiv(static_cast<unsigned>(a.oh * a.ow / v));
  const FastDiv per_row = make_fastdiv(static_cast<unsigned>(a.ow / v));
  const FastDiv per_channel = make_fastdiv(static_cast<unsigned>(a.channels));
  const unsigned blocks = static_cast<unsigned>((nvec + kThreads * kItems - 1) / (kThreads * kItems));
  void (*kernel)(EpArgs, FastDiv, FastDiv, FastDiv) = vec ? pointwise_kernel<P, V> : pointwise_kernel<P, 1>;
  SSAR_LAUNCH(kernel, blocks, kThreads, stream, a, per_plane, per_row, per_channel);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The styled-conv epilogue of y (planes, ih, iw) into out (planes, oh, ow),
// planes = samples x channels, in one launch on `stream`.  dtype: 0 float32,
// 1 float16, 2 bfloat16 (y, out and noise alike).  up = 0: oh = ih, ow = iw;
// up = 1: the blur of `ntaps` (1-8) taps `taps` (flipped, float32) over y
// padded by pad0 samples before the first on each axis.  demod (planes),
// bias (channels) and noise may be null; noise (samples, oh, ow) is read at
// noise_sb * sample + noise_sy * row + noise_sx * column (noise_sb may be 0), and
// noise_weight (one float) with it.  Returns a cudaError_t.
extern "C" int ssar_styled_epilogue(int dtype, int up, const void* y, void* out, const float* demod,
                                    const void* noise, const float* noise_weight, const float* bias,
                                    const float* taps, int ntaps, long long planes, int channels, int ih, int iw,
                                    int oh, int ow, int pad0, long long noise_sb, long long noise_sy, long long noise_sx,
                                    float slope,
                                    float gain, void* stream) {
  if (planes <= 0 || channels <= 0 || planes % channels != 0 || ih <= 0 || iw <= 0 || oh <= 0 || ow <= 0 ||
      (noise && !noise_weight) || dtype < 0 || dtype > 2 || (up != 0 && up != 1) || !(slope >= 0.0f && slope <= 1.0f) ||
      !(gain > 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (up ? ntaps < 1 || ntaps > kMaxTaps || !taps || pad0 < 0 : oh != ih || ow != iw)
    return static_cast<int>(cudaErrorInvalidValue);
  EpArgs a{};
  a.y = y, a.out = out, a.demod = demod, a.noise = noise, a.noise_weight = noise_weight, a.bias = bias;
  a.noise_sb = noise_sb, a.noise_sy = noise_sy, a.noise_sx = noise_sx;
  a.channels = channels, a.ih = ih, a.iw = iw, a.oh = oh, a.ow = ow, a.pad0 = pad0, a.ntaps = ntaps;
  a.slope = slope, a.gain = gain;
  EpTaps t{};
  for (int j = 0; up && j < ntaps; ++j) t.t[j] = taps[j];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<F32>(a, up, t, planes, s);
  if (dtype == 1) return launch<F16>(a, up, t, planes, s);
  return launch<BF16>(a, up, t, planes, s);
}
