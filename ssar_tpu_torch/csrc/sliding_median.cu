// Sliding-window median of odd width K along one axis, reflect padded (the
// padding keeps reflecting as a triangle wave of period 2(L - 1) when the
// line is shorter than the pad, as numpy's and jax's 'reflect' do; L = 1
// repeats the value), for Hopper (sm_90a).  Bit-exact: the median of an odd
// window is one of its elements, and a compare-exchange network only moves
// elements.  A window that holds a NaN gives NaN.
//
// Replaces the TPU kernel ssar_tpu/ops/median_pallas.py (_median_kernel,
// launched by _sliding_median_impl): HPSS runs it twice per track, k = 31
// over time and over frequency of the (1025, T) magnitude spectrogram; the
// segmentation runs it with k = 7 and k = 9 on recurrence matrices.
//
// What bounds it on this card: the function itself moves 8 bytes an element
// (0.0106 ms at (1025, 4320) at 3.35 TB/s), so the design's job is to bring
// the selection's operations down towards that.  fminf / fmaxf run on the
// SM's half-rate integer/logic pipe: 63 a clock an SM measured on an H100
// (fmaf: 117), 16.5 T a second.  Sorting every window on its own (an odd-even
// transposition network, K(K-1)/2 = 465 compare-exchanges at K = 31) costs
// 930 min/max an output, 0.25 ms at that rate; this design costs 75, 0.020 ms.
//
// Design: neighbouring windows share all but one of their values, so a thread
// computes P consecutive outputs (P = 4 for K >= 7) from the K + P - 1 values
// it holds in registers and sorts what the P windows share only once.
//   * The P windows share a core of C = K - P + 1 values.  The core goes
//     through Batcher's odd-even merge sort, generated at compile time for
//     C wires (the 32-wire network with the wires above C pruned), every
//     index a template argument.
//   * A core value of core rank r has rank r .. r + P - 1 in any of the P
//     windows, so only core ranks H - P + 1 .. H (H = K / 2) can be a
//     median: the H - P + 1 values below them lie below every window's
//     median and the H - P + 1 above them lie above it.  Dropping as many
//     from below as from above keeps the median, so each output is the median
//     of 2P - 1 values: those P sorted candidates and the window's own P - 1
//     extras.  The extras are sorted (3 compare-exchanges at P = 4) and the
//     P-th smallest of the two sorted lists is min_i max(cand[i], extra[P-2-i])
//     (the rank-selection identity for two sorted lists): 3 max and 3 min.
//     Only those candidates are read, so the compiler drops every
//     compare-exchange half of the core's network that no candidate depends
//     on: 252 min/max for the core at K = 31, 63 an output, plus 12.
//   * P = 8 costs the same (74.5: the extras' sort grows as the core's
//     shrinks) and more registers; P = 2 costs 136.  Small widths take the
//     same path (K = 7: 14.5 min/max an output, K = 9: 17.5), with P = 2 at
//     K = 3, 5 and P = 1 at K = 1.
//   * NaN: min/max drop a NaN operand, so every thread tests the values it
//     stages and raises a flag for the tile, and a tile with the flag up tests
//     every window for a NaN explicitly.  Tiles without one pay one compare
//     per staged value.
//   * One tile shape for both layouts, 32 lines x 64 positions with a halo of
//     K - 1: (64 + 30) / 64 staged values an output.  The caller passes the
//     strides of a (batch, line, position) view, so the kernel filters the
//     last axis (positions contiguous) or the one before it (lines
//     contiguous) without a transpose copy.  Staging and the final store run
//     along whichever axis is contiguous, so neighbouring threads touch
//     neighbouring addresses; in between, a warp's lanes run along the 32
//     lines and the row pitch of the tiles is odd, so the register loads and
//     the outputs' way back through shared memory are free of bank conflicts.
//   * Staging is free of branches (a line past the last stands in for it, a
//     column past the tile's width repeats the last), so a thread's 12 loads
//     are all in flight before its first store to shared memory: with a
//     branch per load the compiler waited for each load in turn, and the
//     kernel took 46 us at (1025, 4320) instead of 36.  Each line's base
//     offset (a 64-bit division) is computed once a block.
//   * Tried and dropped: blocks that walk several tiles and keep the next
//     tile's 4-byte cp.async copies in flight (no faster: the kernel is bound
//     by its instruction count, not by waiting); 128 positions a tile; 16-byte
//     loads (a (1025, 193) row is not 16-byte aligned).
//
// With -DSSAR_HOST_EMULATION the file compiles as plain C++ and the entry
// point runs the same kernel body block by block on host threads (see
// host_emulation.h), so the index arithmetic can be checked without a card.

#ifdef SSAR_HOST_EMULATION
#include "host_emulation.h"
#else
#include <cuda_runtime.h>
#define SSAR_LAUNCH(kernel, blocks, threads, stream, ...) kernel<<<blocks, threads, 0, stream>>>(__VA_ARGS__)
#endif
#include <stdint.h>

#include "median_common.cuh"

namespace {

using namespace ssar_median;

// ---- compare-exchange networks with compile-time indices -------------------

// Batcher's odd-even merge sort for n wires in its iterative form: the
// network of the next power of two with every comparator that touches a wire
// >= n left out (those wires would carry +inf and never move).
struct Network {
  int count;
  unsigned char a[256], b[256];
};

constexpr Network batcher_network(int n) {
  Network net{};
  for (int p = 1; p < n; p *= 2)
    for (int k = p; k >= 1; k /= 2)
      for (int j = k % p; j + k < n; j += 2 * k)
        for (int i = 0; i < k && i + j + k < n; ++i)
          if ((i + j) / (2 * p) == (i + j + k) / (2 * p)) {
            net.a[net.count] = static_cast<unsigned char>(i + j);
            net.b[net.count] = static_cast<unsigned char>(i + j + k);
            ++net.count;
          }
  return net;
}

template <int N>
struct Batcher {
  static constexpr Network net = batcher_network(N);
};

template <int... I>
struct Seq {};
template <int N, int... I>
struct MakeSeq : MakeSeq<N - 1, N - 1, I...> {};
template <int... I>
struct MakeSeq<0, I...> {
  using type = Seq<I...>;
};

template <int A, int B, int N>
__device__ __forceinline__ void compare_exchange(float (&v)[N]) {
  const float lo = fminf(v[A], v[B]);
  const float hi = fmaxf(v[A], v[B]);
  v[A] = lo;
  v[B] = hi;
}

template <int N, int... I>
__device__ __forceinline__ void sort_network(float (&v)[N], Seq<I...>) {
  (compare_exchange<Batcher<N>::net.a[I], Batcher<N>::net.b[I]>(v), ...);
}

// ascending sort of v[0 .. N - 1]
template <int N>
__device__ __forceinline__ void sort_values(float (&v)[N]) {
  if constexpr (N > 1) sort_network<N>(v, typename MakeSeq<Batcher<N>::net.count>::type{});
}

// outputs a thread computes: the largest power of two <= min(4, K / 2 + 1)
template <int K>
constexpr int kOutputsPerThread = K >= 7 ? 4 : (K >= 3 ? 2 : 1);

// ---- the kernel -------------------------------------------------------------

template <int K, bool CONTIG>
__global__ void __launch_bounds__(kThreads)
sliding_median_kernel(const float* __restrict__ x, float* __restrict__ y,
                      long long n_lines, int L, long long lines_per_batch,
                      long long batch_stride, long long line_stride,
                      long long pos_stride, long long n_pos_tiles) {
  constexpr int H = K / 2;
  constexpr int P = kOutputsPerThread<K>;
  constexpr int C = K - P + 1;          // values the P windows share
  constexpr int W = kTilePos + K - 1;   // staged positions a line
  constexpr int XP = W | 1;             // odd pitches: lanes run along lines
  constexpr int YP = kTilePos | 1;
  __shared__ float xs[kTileLines * XP];
  __shared__ float ys[kTileLines * YP];
  __shared__ long long line_base[kTileLines];
  __shared__ int tile_has_nan;

  const long long bid = blockIdx.x;
  const long long line0 = (bid / n_pos_tiles) * kTileLines;
  const int pos0 = static_cast<int>(bid % n_pos_tiles) * kTilePos;

  if (threadIdx.x < kTileLines)
    line_base[threadIdx.x] = line_offset(line0 + threadIdx.x, n_lines, lines_per_batch, batch_stride, line_stride);
  if (threadIdx.x == 0) tile_has_nan = 0;
  __syncthreads();

  // stage the tile, halo included; only a tile at an end of the line reflects
  const int q0 = pos0 - H;
  const bool saw_nan =
      q0 >= 0 && q0 + W <= L
          ? stage_tile<CONTIG, W>(xs, XP, [&](int ln, int c) {
              return x[offset_on_line<CONTIG>(line_base[ln], q0 + c, pos_stride)];
            })
          : stage_tile<CONTIG, W>(xs, XP, [&](int ln, int c) {
              return x[offset_on_line<CONTIG>(line_base[ln], reflect_index(q0 + c, L), pos_stride)];
            });
  if (saw_nan) tile_has_nan = 1;
  __syncthreads();
  const bool check_nan = tile_has_nan != 0;

  // P consecutive outputs per item; a warp's lanes are 32 lines at one position group
  constexpr int kGroups = kTilePos / P;
  for (int item = threadIdx.x; item < kTileLines * kGroups; item += kThreads) {
    const int ln = item % kTileLines;
    const int t0 = (item / kTileLines) * P;   // first output, relative to pos0
    float v[K + P - 1];
#pragma unroll
    for (int j = 0; j < K + P - 1; ++j) v[j] = xs[ln * XP + t0 + j];

    // windows o = 0 .. P - 1 are v[o .. o + K - 1]; they share v[P - 1 .. K - 1]
    float core[C];
#pragma unroll
    for (int j = 0; j < C; ++j) core[j] = v[P - 1 + j];
    sort_values<C>(core);

    float out[P];
#pragma unroll
    for (int o = 0; o < P; ++o) {
      if constexpr (P == 1) {
        out[o] = core[H];
      } else {
        float extra[P - 1];   // window o's own values: v[o .. P - 2] and v[K .. K + o - 1]
#pragma unroll
        for (int j = 0; j < P - 1; ++j) extra[j] = j < P - 1 - o ? v[o + j] : v[K + j - (P - 1 - o)];
        sort_values<P - 1>(extra);
        // the P-th smallest of the sorted candidates core[H - P + 1 .. H] and the sorted extras
        float m = core[H];
#pragma unroll
        for (int i = 0; i < P - 1; ++i) m = fminf(m, fmaxf(core[H - P + 1 + i], extra[P - 2 - i]));
        out[o] = m;
      }
    }
    if (check_nan) {
#pragma unroll
      for (int o = 0; o < P; ++o) {
        bool nan = false;
#pragma unroll
        for (int j = 0; j < K; ++j) nan |= v[o + j] != v[o + j];
        if (nan) out[o] = __int_as_float(0x7fc00000);
      }
    }
#pragma unroll
    for (int o = 0; o < P; ++o) ys[ln * YP + t0 + o] = out[o];
  }
  __syncthreads();

  // store along the contiguous axis
  for_each_in_tile<CONTIG, kTilePos>([&](int ln, int t, int) {
    if (line0 + ln < n_lines && pos0 + t < L)
      y[offset_on_line<CONTIG>(line_base[ln], pos0 + t, pos_stride)] = ys[ln * YP + t];
  });
}

template <int K>
cudaError_t launch(const float* x, float* y, long long n_lines, int L, long long lines_per_batch,
                   long long batch_stride, long long line_stride, long long pos_stride,
                   cudaStream_t stream) {
  const long long n_pos_tiles = (L + kTilePos - 1) / kTilePos;
  const long long n_blocks = (n_lines + kTileLines - 1) / kTileLines * n_pos_tiles;
  if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const unsigned blocks = static_cast<unsigned>(n_blocks);
  if (pos_stride == 1) {
    auto kernel = sliding_median_kernel<K, true>;
    SSAR_LAUNCH(kernel, blocks, kThreads, stream, x, y, n_lines, L, lines_per_batch, batch_stride, line_stride,
                pos_stride, n_pos_tiles);
  } else {
    auto kernel = sliding_median_kernel<K, false>;
    SSAR_LAUNCH(kernel, blocks, kThreads, stream, x, y, n_lines, L, lines_per_batch, batch_stride, line_stride,
                pos_stride, n_pos_tiles);
  }
  return cudaGetLastError();
}

// ---- the generic path: odd K > 31, K a run-time argument ----------------------
//
// The Pallas kernel takes any odd K; no caller passes one above 31, so this
// path is simple rather than fast: one thread an output, its window read
// straight from device memory (through L1), and the median selected by
// counting ranks: the tap v with fewer than H + 1 taps below it and more
// than H at or below it (K^2 compares an output).  A window with a NaN gives
// NaN, as on the templated path.

template <bool CONTIG>
__global__ void __launch_bounds__(kThreads)
sliding_median_generic_kernel(const float* __restrict__ x, float* __restrict__ y, int K, long long n_lines,
                              int L, long long lines_per_batch, long long batch_stride, long long line_stride,
                              long long pos_stride) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= n_lines * L) return;
  long long line;
  int t;
  generic_item<CONTIG>(idx, L, lines_per_batch, &line, &t);
  const long long base = line_offset(line, n_lines, lines_per_batch, batch_stride, line_stride);
  const int H = K / 2;
  auto tap = [&](int i) { return x[offset_on_line<CONTIG>(base, reflect_index(t - H + i, L), pos_stride)]; };

  float m = __int_as_float(0x7fc00000);
  bool nan = false;
  for (int i = 0; i < K; ++i) nan |= tap(i) != tap(i);
  if (!nan) {
    for (int i = 0; i < K; ++i) {
      const float v = tap(i);
      int below = 0, at_or_below = 0;
      for (int j = 0; j < K; ++j) {
        const float w = tap(j);
        below += w < v;
        at_or_below += w <= v;
      }
      if (below <= H && at_or_below > H) {
        m = v;
        break;
      }
    }
  }
  y[offset_on_line<CONTIG>(base, t, pos_stride)] = m;
}

cudaError_t launch_generic(const float* x, float* y, int k, long long n_lines, int L, long long lines_per_batch,
                           long long batch_stride, long long line_stride, long long pos_stride,
                           cudaStream_t stream) {
  const long long n_blocks = (n_lines * L + kThreads - 1) / kThreads;
  if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const unsigned blocks = static_cast<unsigned>(n_blocks);
  if (pos_stride == 1) {
    auto kernel = sliding_median_generic_kernel<true>;
    SSAR_LAUNCH(kernel, blocks, kThreads, stream, x, y, k, n_lines, L, lines_per_batch, batch_stride, line_stride,
                pos_stride);
  } else {
    auto kernel = sliding_median_generic_kernel<false>;
    SSAR_LAUNCH(kernel, blocks, kThreads, stream, x, y, k, n_lines, L, lines_per_batch, batch_stride, line_stride,
                pos_stride);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Line r starts at
// (r / lines_per_batch) * batch_stride + (r % lines_per_batch) * line_stride
// and steps by pos_stride (all in elements); every L >= 1 is taken.  Launches
// on `stream`, does not synchronise, and returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an even or negative window width or an
// empty tensor).  Odd widths above 31 take the generic kernel.
extern "C" int ssar_sliding_median_f32(const float* x, float* y, int k, long long n_lines, int L,
                                       long long lines_per_batch, long long batch_stride,
                                       long long line_stride, long long pos_stride, void* stream) {
  if (n_lines < 1 || L < 1 || lines_per_batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSAR_CASE(KK) \
  case KK: return static_cast<int>(launch<KK>(x, y, n_lines, L, lines_per_batch, batch_stride, line_stride, pos_stride, s));
  switch (k) {
    SSAR_CASE(1) SSAR_CASE(3) SSAR_CASE(5) SSAR_CASE(7) SSAR_CASE(9) SSAR_CASE(11) SSAR_CASE(13)
    SSAR_CASE(15) SSAR_CASE(17) SSAR_CASE(19) SSAR_CASE(21) SSAR_CASE(23) SSAR_CASE(25)
    SSAR_CASE(27) SSAR_CASE(29) SSAR_CASE(31)
    default:
      if (k < 33 || k % 2 != 1) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch_generic(x, y, k, n_lines, L, lines_per_batch, batch_stride, line_stride,
                                             pos_stride, s));
  }
#undef SSAR_CASE
}
