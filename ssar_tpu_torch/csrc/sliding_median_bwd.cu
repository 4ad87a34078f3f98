// Backward of the sliding-window median (odd width K, reflect padded as in
// sliding_median.cu, any line length L >= 1) for Hopper (sm_90a): routes each
// output cotangent g[t] to the FIRST window tap equal to the median out[t]
// and folds the reflect halo back onto the line.  A window without an equal
// tap (a NaN) routes nothing.
//
// Replaces the TPU package's VJP ssar_tpu/ops/median_pallas.py
// (_sliding_median_bwd, attached to sliding_median_lastaxis by defvjp), which
// materialises the (F, T, k) window tensor and scatters it back tap by tap.
//
// What bounds it on this card: the function moves 16 bytes an element (x, out
// and g read, gx written: 0.0212 ms at (1025, 4320) at 3.35 TB/s), but the
// work is compares.  The search takes a compare and a select for each tap of
// each output and the gather a compare and an add for each tap of each input.
// Compares and selects run on the SM's half-rate integer/logic pipe (63 a
// clock an SM measured on an H100, 16.5 T a second): 3K of them an element,
// 4K with the halo outputs a tile searches again, is 0.033 ms at K = 31.  So
// the design's job is to keep everything else (shared-memory reads, branches,
// index arithmetic, waiting for loads) off the element's path.
//
// Design: a gather, not a scatter, so there are no atomics and two launches
// give the same bits.  A block owns a tile of 32 lines x 64 INPUT positions
// (the forward's tile, see median_common.cuh); K is a template argument and
// every loop over taps is unrolled.
//   1. Stage x with a halo of 2(K/2) and out and g with a halo of K/2 into
//      shared memory along whichever axis is contiguous (reflection resolved
//      on load; an output outside the line is staged as NaN, so it selects
//      nothing).  (64 + 60) / 64 values of x an input.  No branch stands
//      between a thread's loads, so all of them are in flight together.
//   2. Search: a thread owns 4 consecutive outputs, loads the K + 3 values of
//      x they see into registers once, and takes per output the smallest i
//      with x[t + i] == out[t] as a chain of selects: no branch.  It writes
//      the padded position the cotangent lands on, t + i relative to the
//      tile, over the staged out[t] (-1: none).
//   3. Gather: a thread owns 4 consecutive inputs and loads the K + 3
//      (target, g) pairs that can reach them into registers once,
//      (K + 3) / 4 shared reads of each an input instead of K.  Input j takes
//      g[t] where the target equals j's padded position, taps ascending, as
//      predicated adds.
//   4. Fold: an input within K/2 of an edge also takes what landed on the
//      halo positions that mirror it: first those left of the line, moving
//      outward, then those right of it, moving outward, each one's taps
//      ascending.  On a line longer than K/2 that is at most one position a
//      side.  The plain PyTorch version adds in this same order, so the two
//      agree bit for bit.
//   5. Results go back through shared memory and are stored along the
//      contiguous axis.
// In 2 and 3 a warp's lanes run along the 32 lines and the tiles' row pitches
// are odd: no bank conflicts.
// Tried and dropped: 2 or 8 outputs a thread (slower: more shared reads, or
// more registers); 128 positions a tile (the search's 1.5x of halo outputs
// falls to 1.23x, but at 127-136 registers one block an SM: slower along the
// strided axis); a cap of 80 registers for three blocks an SM (spills, no
// faster); the select as a predicated move in PTX (ptxas makes it a select
// again); blocks that walk several tiles with cp.async copies of the next
// one in flight (slower).
//
// With -DSSAR_HOST_EMULATION the file compiles as plain C++ (host_emulation.h).

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

constexpr int kPerThread = 4;  // consecutive outputs (search) or inputs (gather) a thread owns

// What landed on the padded position q (0 .. L + 2p - 1; the line is p ..
// p + L - 1), taps ascending.  ts / gs: the line's staged targets and
// cotangents, column u for output pos0 - p + u.
template <int K>
__device__ __forceinline__ float landed_on(int q, const float* ts, const float* gs, int pos0, int L, int width) {
  constexpr int p = K / 2;
  float h = 0.f;
  for (int i = 0; i < K; ++i) {
    const int t = q - i;
    if (t < 0) break;
    const int u = t - pos0 + p;
    if (t < L && u >= 0 && u < width && __float_as_int(ts[u]) == q - pos0 + p) h += gs[u];
  }
  return h;
}

// Adds to acc what landed on the halo positions at distance 1 .. p beyond one
// edge that mirror the input at distance e from that edge, moving outward.
// `first` is the padded position at distance 1, `step` +1 or -1.
template <int K>
__device__ __forceinline__ float fold_side(float acc, int e, int first, int step, const float* ts,
                                           const float* gs, int pos0, int L, int width) {
  constexpr int p = K / 2;
  if (L == 1) {
    for (int d = 1; d <= p; ++d) acc += landed_on<K>(first + step * (d - 1), ts, gs, pos0, L, width);
    return acc;
  }
  const int m = 2 * (L - 1);   // the mirror images of e: e, m - e, m + e, 2m - e, ...
  for (int base = 0;; base += m) {
    const int d1 = base + e;
    if (d1 > p) break;
    if (e != 0) acc += landed_on<K>(first + step * (d1 - 1), ts, gs, pos0, L, width);
    const int d2 = base + m - e;
    if (d2 > p) break;
    if (2 * e != m) acc += landed_on<K>(first + step * (d2 - 1), ts, gs, pos0, L, width);
  }
  return acc;
}

template <int K, bool CONTIG>
__global__ void __launch_bounds__(kThreads)
sliding_median_bwd_kernel(const float* __restrict__ x, const float* __restrict__ out,
                          const float* __restrict__ g, float* __restrict__ gx,
                          long long n_lines, int L, long long lines_per_batch,
                          long long batch_stride, long long line_stride,
                          long long pos_stride, long long n_pos_tiles) {
  constexpr int p = K / 2, P = kPerThread;
  constexpr int OW = kTilePos + 2 * p;          // outputs pos0 - p .. pos0 + kTilePos - 1 + p
  constexpr int OWP = (OW + P - 1) / P * P;     // rounded up to whole threads
  constexpr int XW = OWP + K - 1;               // positions pos0 - 2p .. : every staged output's window
  constexpr int OP = OWP | 1;                   // odd pitches: lanes run along lines
  constexpr int XP = XW | 1;
  __shared__ float xs[kTileLines * XP];         // x, later the results
  __shared__ float ts[kTileLines * OP];         // out, later the targets
  __shared__ float gs[kTileLines * OP];
  __shared__ long long line_base[kTileLines];

  const long long bid = blockIdx.x;
  const long long line0 = (bid / n_pos_tiles) * kTileLines;
  const int pos0 = static_cast<int>(bid % n_pos_tiles) * kTilePos;

  if (threadIdx.x < kTileLines)
    line_base[threadIdx.x] = line_offset(line0 + threadIdx.x, n_lines, lines_per_batch, batch_stride, line_stride);
  __syncthreads();

  // 1. stage; only a tile at an end of the line reflects or meets outputs outside the line
  //    (those are staged as NaN: they select nothing)
  const int x0 = pos0 - 2 * p, t0 = pos0 - p;
  if (x0 >= 0 && x0 + XW <= L) {
    stage_tile<CONTIG, XW>(xs, XP, [&](int ln, int c) {
      return x[offset_on_line<CONTIG>(line_base[ln], x0 + c, pos_stride)];
    });
    stage_tile<CONTIG, OWP>(ts, OP, [&](int ln, int u) {
      return out[offset_on_line<CONTIG>(line_base[ln], t0 + u, pos_stride)];
    });
    stage_tile<CONTIG, OWP>(gs, OP, [&](int ln, int u) {
      return g[offset_on_line<CONTIG>(line_base[ln], t0 + u, pos_stride)];
    });
  } else {
    stage_tile<CONTIG, XW>(xs, XP, [&](int ln, int c) {
      return x[offset_on_line<CONTIG>(line_base[ln], reflect_index(x0 + c, L), pos_stride)];
    });
    stage_tile<CONTIG, OWP>(ts, OP, [&](int ln, int u) {
      const int t = t0 + u;
      const bool inside = t >= 0 && t < L;
      const float o = out[offset_on_line<CONTIG>(line_base[ln], inside ? t : 0, pos_stride)];
      return inside ? o : __int_as_float(0x7fc00000);
    });
    stage_tile<CONTIG, OWP>(gs, OP, [&](int ln, int u) {
      const int t = t0 + u;
      return g[offset_on_line<CONTIG>(line_base[ln], t >= 0 && t < L ? t : 0, pos_stride)];
    });
  }
  __syncthreads();

  // 2. search: output u's window is x-tile columns u .. u + K - 1
  for (int item = threadIdx.x; item < kTileLines * (OWP / P); item += kThreads) {
    const int ln = item % kTileLines;
    const int u0 = (item / kTileLines) * P;
    float xv[K + P - 1];
#pragma unroll
    for (int j = 0; j < K + P - 1; ++j) xv[j] = xs[ln * XP + u0 + j];
#pragma unroll
    for (int o = 0; o < P; ++o) {
      const float m = ts[ln * OP + u0 + o];
      int sel = K;
#pragma unroll
      for (int i = K - 1; i >= 0; --i) sel = xv[o + i] == m ? i : sel;
      ts[ln * OP + u0 + o] = __int_as_float(sel < K ? u0 + o + sel : -1);
    }
  }
  __syncthreads();

  // 3. gather and 4. fold
  for (int item = threadIdx.x; item < kTileLines * (kTilePos / P); item += kThreads) {
    const int ln = item % kTileLines;
    const int j0 = (item / kTileLines) * P;     // first input, relative to pos0
    const float* trow = ts + ln * OP;
    const float* grow = gs + ln * OP;
    int tg[K + P - 1];
    float gv[K + P - 1];
#pragma unroll
    for (int n = 0; n < K + P - 1; ++n) {
      tg[n] = __float_as_int(trow[j0 + n]);
      gv[n] = grow[j0 + n];
    }
#pragma unroll
    for (int a = 0; a < P; ++a) {
      // input j0 + a sits at padded column j0 + a + 2p; tap i comes from column j0 + a + 2p - i
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i)
        if (tg[a + K - 1 - i] == j0 + a + K - 1) acc += gv[a + K - 1 - i];
      if constexpr (K > 1) {
        const int j = pos0 + j0 + a;
        if (j < L && (j <= p || L - 1 - j <= p)) {
          acc = fold_side<K>(acc, j, p - 1, -1, trow, grow, pos0, L, OW);
          acc = fold_side<K>(acc, L - 1 - j, p + L, +1, trow, grow, pos0, L, OW);
        }
      }
      xs[ln * XP + j0 + a] = acc;
    }
  }
  __syncthreads();

  // 5. store along the contiguous axis
  for_each_in_tile<CONTIG, kTilePos>([&](int ln, int t, int) {
    if (line0 + ln < n_lines && pos0 + t < L)
      gx[offset_on_line<CONTIG>(line_base[ln], pos0 + t, pos_stride)] = xs[ln * XP + t];
  });
}

template <int K>
cudaError_t launch(const float* x, const float* out, const float* g, float* gx, long long n_lines, int L,
                   long long lines_per_batch, long long batch_stride, long long line_stride,
                   long long pos_stride, cudaStream_t stream) {
  const long long n_pos_tiles = (L + kTilePos - 1) / kTilePos;
  const long long n_blocks = (n_lines + kTileLines - 1) / kTileLines * n_pos_tiles;
  if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const unsigned blocks = static_cast<unsigned>(n_blocks);
  if (pos_stride == 1) {
    auto kernel = sliding_median_bwd_kernel<K, true>;
    SSAR_LAUNCH(kernel, blocks, kThreads, stream, x, out, g, gx, n_lines, L, lines_per_batch, batch_stride,
                line_stride, pos_stride, n_pos_tiles);
  } else {
    auto kernel = sliding_median_bwd_kernel<K, false>;
    SSAR_LAUNCH(kernel, blocks, kThreads, stream, x, out, g, gx, n_lines, L, lines_per_batch, batch_stride,
                line_stride, pos_stride, n_pos_tiles);
  }
  return cudaGetLastError();
}

// ---- the generic path: odd K > 31, K a run-time argument ----------------------
//
// The forward's generic path has its gradient here, as simple: one thread an
// input, reading device memory (through L1).  What lands on a padded position
// q is found as landed_on above does, taps ascending, with each output's
// selected tap searched again (K^2 compares an input); then the same fold of
// the reflect halo in the same order, so it too agrees with the plain
// version bit for bit.

template <bool CONTIG>
struct GenericLine {
  const float *x, *out, *g;
  long long base, pos_stride;
  int K, L;

  __device__ __forceinline__ long long at(int t) const { return offset_on_line<CONTIG>(base, t, pos_stride); }

  // the first tap of output t's window equal to out[t], K if none
  __device__ __forceinline__ int selected(int t) const {
    const float m = out[at(t)];
    for (int i = 0; i < K; ++i)
      if (x[at(reflect_index(t - K / 2 + i, L))] == m) return i;
    return K;
  }

  // what landed on the padded position q (0 .. L + 2p - 1), taps ascending
  __device__ __forceinline__ float landed_on(int q) const {
    float h = 0.f;
    for (int i = 0; i < K; ++i) {
      const int t = q - i;
      if (t < 0) break;
      if (t < L && selected(t) == i) h += g[at(t)];
    }
    return h;
  }

  // fold_side above, for this line
  __device__ __forceinline__ float fold_side(float acc, int e, int first, int step) const {
    const int p = K / 2;
    if (L == 1) {
      for (int d = 1; d <= p; ++d) acc += landed_on(first + step * (d - 1));
      return acc;
    }
    const int m = 2 * (L - 1);
    for (int base_d = 0;; base_d += m) {
      const int d1 = base_d + e;
      if (d1 > p) break;
      if (e != 0) acc += landed_on(first + step * (d1 - 1));
      const int d2 = base_d + m - e;
      if (d2 > p) break;
      if (2 * e != m) acc += landed_on(first + step * (d2 - 1));
    }
    return acc;
  }
};

template <bool CONTIG>
__global__ void __launch_bounds__(kThreads)
sliding_median_bwd_generic_kernel(const float* __restrict__ x, const float* __restrict__ out,
                                  const float* __restrict__ g, float* __restrict__ gx, int K, long long n_lines,
                                  int L, long long lines_per_batch, long long batch_stride, long long line_stride,
                                  long long pos_stride) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= n_lines * L) return;
  long long line;
  int j;
  generic_item<CONTIG>(idx, L, lines_per_batch, &line, &j);
  const GenericLine<CONTIG> ln{x, out, g, line_offset(line, n_lines, lines_per_batch, batch_stride, line_stride),
                               pos_stride, K, L};
  const int p = K / 2;
  float acc = ln.landed_on(j + p);
  if (j <= p || L - 1 - j <= p) {
    acc = ln.fold_side(acc, j, p - 1, -1);
    acc = ln.fold_side(acc, L - 1 - j, p + L, +1);
  }
  gx[ln.at(j)] = acc;
}

cudaError_t launch_generic(const float* x, const float* out, const float* g, float* gx, int k, long long n_lines,
                           int L, long long lines_per_batch, long long batch_stride, long long line_stride,
                           long long pos_stride, cudaStream_t stream) {
  const long long n_blocks = (n_lines * L + kThreads - 1) / kThreads;
  if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const unsigned blocks = static_cast<unsigned>(n_blocks);
  if (pos_stride == 1) {
    auto kernel = sliding_median_bwd_generic_kernel<true>;
    SSAR_LAUNCH(kernel, blocks, kThreads, stream, x, out, g, gx, k, n_lines, L, lines_per_batch, batch_stride,
                line_stride, pos_stride);
  } else {
    auto kernel = sliding_median_bwd_generic_kernel<false>;
    SSAR_LAUNCH(kernel, blocks, kThreads, stream, x, out, g, gx, k, n_lines, L, lines_per_batch, batch_stride,
                line_stride, pos_stride);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  x, out, g and gx share one
// layout: line r starts at (r / lines_per_batch) * batch_stride +
// (r % lines_per_batch) * line_stride and steps by pos_stride (in elements);
// every L >= 1 is taken.  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// even or negative window width or an empty tensor).  Odd widths above 31
// take the generic kernel.
extern "C" int ssar_sliding_median_bwd_f32(const float* x, const float* out, const float* g, float* gx,
                                           int k, long long n_lines, int L, long long lines_per_batch,
                                           long long batch_stride, long long line_stride,
                                           long long pos_stride, void* stream) {
  if (n_lines < 1 || L < 1 || lines_per_batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSAR_CASE(KK) \
  case KK: return static_cast<int>(launch<KK>(x, out, g, gx, n_lines, L, lines_per_batch, batch_stride, line_stride, pos_stride, s));
  switch (k) {
    SSAR_CASE(1) SSAR_CASE(3) SSAR_CASE(5) SSAR_CASE(7) SSAR_CASE(9) SSAR_CASE(11) SSAR_CASE(13)
    SSAR_CASE(15) SSAR_CASE(17) SSAR_CASE(19) SSAR_CASE(21) SSAR_CASE(23) SSAR_CASE(25)
    SSAR_CASE(27) SSAR_CASE(29) SSAR_CASE(31)
    default:
      if (k < 33 || k % 2 != 1) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch_generic(x, out, g, gx, k, n_lines, L, lines_per_batch, batch_stride,
                                             line_stride, pos_stride, s));
  }
#undef SSAR_CASE
}
