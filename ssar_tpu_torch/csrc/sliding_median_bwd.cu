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
#define SSAR_LAUNCH_DYNAMIC(kernel, blocks, threads, bytes, stream, ...) \
  kernel<<<blocks, threads, bytes, stream>>>(__VA_ARGS__)
#define SSAR_DYNAMIC_SHARED(type, name) extern __shared__ type name[]
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
// The same VJP (ssar_tpu/ops/median_pallas.py:110, _sliding_median_bwd) for
// every odd K the templated kernel does not instantiate, K a run-time argument
// (no instantiation per width: this file's 32 already take most of the build).
//
// What bounds it: the bytes are the templated kernel's (16 an element, 0.00094
// ms at (1025, 193)); the work is compares.  Searching each output's selected
// tap again for each input that window can reach (the earlier generic design) is K^2
// compares an input.  This design does steps 1-5 of the templated kernel
// above with K at run time: the search takes K compares and selects for each
// of the 64 + K - 1 outputs a tile stages, the gather K compares and adds an
// input, about 4K(64 + K - 1)/64 + 5K instructions an input: 820 at K = 63,
// 0.26 G lane instructions at (1025, 193) in tiles of 8 lines, 0.008 ms at one
// warp instruction a clock on each scheduler.
//   1. Stage x with a halo of 2(K/2), out and g with a halo of K/2, into
//      dynamic shared memory along the contiguous axis (an output outside the
//      line staged as NaN: it selects nothing).
//   2. Search: each staged output on the line takes the first of its K staged
//      taps equal to out[t], as a chain of selects from the last tap down (no
//      divergence within it), and stores the padded column it lands on (-1:
//      none; an output off the line is not searched).
//   3. Gather: each input adds the cotangents of the K outputs that can reach
//      it whose target is its column, taps ascending, as predicated adds.
//   4. Fold the reflect halo as the templated kernel does, in the same order,
//      visiting only the outputs on the line that reach each halo position.
//      On a line shorter than the pad the search and the fold scale with L,
//      not K (a first form that searched every staged output and walked K taps
//      for each mirror image kept tests/test_torch_cuda.py's k = 8161 case on
//      9000 lines of 2 running for minutes).
//   5. Results go back through shared memory and are stored along the
//      contiguous axis.
// A gather: no atomics, the plain version's order of adds, so it equals
// sliding_median_bwd_plain bit for bit and two launches give the same bits.
// A tile has 8 lines while it fits the card's 227 KB of shared memory a block,
// up to K = 1,759 (a 32-line tile would fit up to K = 403); above, it takes
// fewer lines, one line up to K = 14,415 (wider: cudaErrorInvalidValue).  The
// tile's lines depend on K alone.
// Tried and dropped: the earlier design, one thread an input, searching each reaching
// output's tap again from device memory: 0.303 / 1.04 ms at K = 33 / 63.

constexpr int kGenericLinesLog2 = 3;  // a generic tile has at most 8 lines

// landed_on and fold_side above with the width at run time.  Only outputs on
// the line select a tap, so landed_on_generic visits those alone, taps
// ascending (outputs descending): at most L of them, where K may be far wider.
__device__ __forceinline__ float landed_on_generic(int K, int q, const float* ts, const float* gs, int pos0, int L,
                                                   int width) {
  const int p = K / 2;
  float h = 0.f;
  for (int t = q < L - 1 ? q : L - 1; t >= 0 && t > q - K; --t) {
    const int u = t - pos0 + p;
    if (u >= 0 && u < width && __float_as_int(ts[u]) == q - pos0 + p) h += gs[u];
  }
  return h;
}

__device__ __forceinline__ float fold_side_generic(int K, float acc, int e, int first, int step, const float* ts,
                                                   const float* gs, int pos0, int L, int width) {
  const int p = K / 2;
  if (L == 1) {
    for (int d = 1; d <= p; ++d) acc += landed_on_generic(K, first + step * (d - 1), ts, gs, pos0, L, width);
    return acc;
  }
  const int m = 2 * (L - 1);
  for (int base = 0;; base += m) {
    const int d1 = base + e;
    if (d1 > p) break;
    if (e != 0) acc += landed_on_generic(K, first + step * (d1 - 1), ts, gs, pos0, L, width);
    const int d2 = base + m - e;
    if (d2 > p) break;
    if (2 * e != m) acc += landed_on_generic(K, first + step * (d2 - 1), ts, gs, pos0, L, width);
  }
  return acc;
}

template <bool CONTIG>
__global__ void __launch_bounds__(kThreads)
sliding_median_bwd_generic_kernel(const float* __restrict__ x, const float* __restrict__ out,
                                  const float* __restrict__ g, float* __restrict__ gx, int K, int lines_log2,
                                  long long n_lines, int L, long long lines_per_batch, long long batch_stride,
                                  long long line_stride, long long pos_stride, long long n_pos_tiles) {
  SSAR_DYNAMIC_SHARED(float, shared_tile);
  __shared__ long long line_base[kTileLines];
  const int lines = 1 << lines_log2, p = K / 2;
  const int OW = kTilePos + 2 * p;    // outputs pos0 - p .. pos0 + kTilePos - 1 + p
  const int XW = OW + K - 1;          // positions pos0 - 2p ..: every staged output's window
  const int OP = OW | 1, XP = XW | 1;
  float* xs = shared_tile;            // x, later the results
  float* ts = xs + lines * XP;        // out, later the targets
  float* gs = ts + lines * OP;

  const long long bid = blockIdx.x;
  const long long line0 = (bid / n_pos_tiles) * lines;
  const int pos0 = static_cast<int>(bid % n_pos_tiles) * kTilePos;
  if (static_cast<int>(threadIdx.x) < lines)
    line_base[threadIdx.x] = line_offset(line0 + threadIdx.x, n_lines, lines_per_batch, batch_stride, line_stride);
  __syncthreads();

  // 1. stage; only a tile at an end of the line reflects or meets outputs outside the line
  const int x0 = pos0 - 2 * p, t0 = pos0 - p;
  const bool inside = x0 >= 0 && x0 + XW <= L;
  for_each_in_generic_tile<CONTIG>(lines, lines_log2, XW, [&](int ln, int c) {
    xs[ln * XP + c] = x[offset_on_line<CONTIG>(line_base[ln], inside ? x0 + c : reflect_index(x0 + c, L), pos_stride)];
  });
  for_each_in_generic_tile<CONTIG>(lines, lines_log2, OW, [&](int ln, int u) {
    const int t = t0 + u;
    const bool on_line = inside || (t >= 0 && t < L);
    const long long at = offset_on_line<CONTIG>(line_base[ln], on_line ? t : 0, pos_stride);
    const float o = out[at];
    ts[ln * OP + u] = on_line ? o : __int_as_float(0x7fc00000);
    gs[ln * OP + u] = g[at];
  });
  __syncthreads();

  // 2. search: output u's window is x-tile columns u .. u + K - 1; an output off the line selects nothing
  for (int item = threadIdx.x; item < lines * OW; item += kThreads) {
    const int ln = item & (lines - 1), u = item >> lines_log2;
    const float* xrow = xs + ln * XP + u;
    const float m = ts[ln * OP + u];
    int sel = -1;
    if (t0 + u >= 0 && t0 + u < L) {
#pragma unroll 4
      for (int i = K - 1; i >= 0; --i) sel = xrow[i] == m ? u + i : sel;
    }
    ts[ln * OP + u] = __int_as_float(sel);
  }
  __syncthreads();

  // 3. gather and 4. fold
  for (int item = threadIdx.x; item < lines * kTilePos; item += kThreads) {
    const int ln = item & (lines - 1), j = item >> lines_log2;   // input j, relative to pos0
    const float* trow = ts + ln * OP;
    const float* grow = gs + ln * OP;
    const int col = j + 2 * p;   // its padded column; tap i comes from output column col - i
    const int jl = pos0 + j;
    if (jl >= L) continue;       // past the line's end: not stored
    float acc = 0.f;
#pragma unroll 4
    for (int i = 0; i < K; ++i)
      if (__float_as_int(trow[col - i]) == col) acc += grow[col - i];
    if (jl <= p || L - 1 - jl <= p) {
      acc = fold_side_generic(K, acc, jl, p - 1, -1, trow, grow, pos0, L, OW);
      acc = fold_side_generic(K, acc, L - 1 - jl, p + L, +1, trow, grow, pos0, L, OW);
    }
    xs[ln * XP + j] = acc;
  }
  __syncthreads();

  // 5. store along the contiguous axis
  for_each_in_generic_tile<CONTIG>(lines, lines_log2, kTilePos, [&](int ln, int t) {
    if (line0 + ln < n_lines && pos0 + t < L)
      gx[offset_on_line<CONTIG>(line_base[ln], pos0 + t, pos_stride)] = xs[ln * XP + t];
  });
}

// The generic tile for width K: the most lines (a power of two, at most
// 2^kGenericLinesLog2) whose block fits the card's shared memory.
bool generic_tile(int K, int* lines_log2, int* bytes) {
  const long long per_line = 4LL * ((((kTilePos + 2 * (K / 2)) + K - 1) | 1) + 2 * ((kTilePos + 2 * (K / 2)) | 1));
  for (int lg = kGenericLinesLog2; lg >= 0; --lg)
    if ((per_line << lg) <= kMaxDynamicShared) {
      *lines_log2 = lg;
      *bytes = static_cast<int>(per_line << lg);
      return true;
    }
  return false;
}

template <bool CONTIG>
cudaError_t launch_generic_layout(const float* x, const float* out, const float* g, float* gx, int k,
                                  int lines_log2, int bytes, long long n_lines, int L, long long lines_per_batch,
                                  long long batch_stride, long long line_stride, long long pos_stride,
                                  cudaStream_t stream) {
  auto kernel = sliding_median_bwd_generic_kernel<CONTIG>;
  // Above the default 48 KB a launch opts in on the current device (the attribute is per device), to the
  // card's limit rather than these bytes, so that launches from other threads never lower it.
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 kMaxDynamicShared);
    if (err != cudaSuccess) return err;
  }
  const long long n_pos_tiles = (L + kTilePos - 1) / kTilePos;
  const long long lines = 1LL << lines_log2;
  const long long n_blocks = (n_lines + lines - 1) / lines * n_pos_tiles;
  if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  SSAR_LAUNCH_DYNAMIC(kernel, static_cast<unsigned>(n_blocks), kThreads, bytes, stream, x, out, g, gx, k,
                      lines_log2, n_lines, L, lines_per_batch, batch_stride, line_stride, pos_stride, n_pos_tiles);
  return cudaGetLastError();
}

cudaError_t launch_generic(const float* x, const float* out, const float* g, float* gx, int k, long long n_lines,
                           int L, long long lines_per_batch, long long batch_stride, long long line_stride,
                           long long pos_stride, cudaStream_t stream) {
  int lines_log2, bytes;
  if (!generic_tile(k, &lines_log2, &bytes)) return cudaErrorInvalidValue;
  if (pos_stride == 1)
    return launch_generic_layout<true>(x, out, g, gx, k, lines_log2, bytes, n_lines, L, lines_per_batch,
                                       batch_stride, line_stride, pos_stride, stream);
  return launch_generic_layout<false>(x, out, g, gx, k, lines_log2, bytes, n_lines, L, lines_per_batch,
                                      batch_stride, line_stride, pos_stride, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  x, out, g and gx share one
// layout: line r starts at (r / lines_per_batch) * batch_stride +
// (r % lines_per_batch) * line_stride and steps by pos_stride (in elements);
// every L >= 1 is taken.  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// even or negative window width or an empty tensor, or for an odd width too
// wide for a one-line tile, above 14,415).  Odd widths above 31 take the
// generic kernel.
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
