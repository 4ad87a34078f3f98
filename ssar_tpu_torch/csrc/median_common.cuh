// Shared by sliding_median.cu and sliding_median_bwd.cu: the tile both
// templated kernels work on, the reflect padding's index map, and the generic
// kernels' tile walk and shared-memory budget.
#pragma once

namespace ssar_median {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileLines = 32;  // lines a block owns: one warp's lanes
constexpr int kTilePos = 64;    // positions along the filtered axis a block owns

// Values a thread handles when the block walks a kTileLines x NCOLS tile.
template <bool CONTIG, int NCOLS>
constexpr int kPerThreadInTile =
    CONTIG ? (kTileLines / kWarps) * ((NCOLS + 31) / 32) : (NCOLS + kWarps - 1) / kWarps;

// Calls f(line, column, n) for the thread's share of a kTileLines x NCOLS
// tile, n counting its calls from 0, a warp's lanes on neighbouring addresses
// of the contiguous axis: along the columns of one line when positions are
// contiguous, along the lines of one column otherwise (a thread then keeps
// its line).  Every loop has a constant trip count, so all indices but the
// thread's own are known at compile time; where NCOLS does not divide, the
// last column is visited more than once rather than behind a branch.
template <bool CONTIG, int NCOLS, typename F>
__device__ __forceinline__ void for_each_in_tile(F f) {
  static_assert(kTileLines == 32, "a warp's lanes are the tile's lines");
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (CONTIG) {
    constexpr int kChunks = (NCOLS + 31) / 32;
#pragma unroll
    for (int l = 0; l < kTileLines / kWarps; ++l)
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        const int c = ch * 32 + lane;
        f(l * kWarps + warp, (ch + 1) * 32 <= NCOLS || c < NCOLS ? c : NCOLS - 1, l * kChunks + ch);
      }
  } else {
#pragma unroll
    for (int ch = 0; ch < (NCOLS + kWarps - 1) / kWarps; ++ch) {
      const int c = ch * kWarps + warp;
      f(lane, (ch + 1) * kWarps <= NCOLS || c < NCOLS ? c : NCOLS - 1, ch);
    }
  }
}

// Stages a tile into shared memory: first every load of the thread (so that
// they are all in flight together), then every store.  load(line, column)
// must be safe for every line and column of the tile.  Returns whether one of
// the thread's values was a NaN.
template <bool CONTIG, int NCOLS, typename Load>
__device__ __forceinline__ bool stage_tile(float* dst, int pitch, Load load) {
  float v[kPerThreadInTile<CONTIG, NCOLS>];
  bool saw_nan = false;
  for_each_in_tile<CONTIG, NCOLS>([&](int ln, int c, int n) { v[n] = load(ln, c); });
  for_each_in_tile<CONTIG, NCOLS>([&](int ln, int c, int n) {
    dst[ln * pitch + c] = v[n];
    saw_nan |= v[n] != v[n];
  });
  return saw_nan;
}

// Offset of a line's first element: line r starts at (r / lines_per_batch) *
// batch_stride + (r % lines_per_batch) * line_stride.  A line past the last
// stands in for it, so that a tile's loads need no branch.  The division is a
// 32-bit one where the numbers allow (a 64-bit one is a long subroutine on
// the path of every block).
__device__ __forceinline__ long long line_offset(long long line, long long n_lines, long long lines_per_batch,
                                                 long long batch_stride, long long line_stride) {
  if (line >= n_lines) line = n_lines - 1;
  long long batch, row;
  if (n_lines <= 0x7fffffffLL) {
    const unsigned b = static_cast<unsigned>(line) / static_cast<unsigned>(lines_per_batch);
    batch = b;
    row = static_cast<unsigned>(line) - b * static_cast<unsigned>(lines_per_batch);
  } else {
    batch = line / lines_per_batch;
    row = line - batch * lines_per_batch;
  }
  return batch * batch_stride + row * line_stride;
}

// Offset of position q on the line that starts at `base`.
template <bool CONTIG>
__device__ __forceinline__ long long offset_on_line(long long base, int q, long long pos_stride) {
  return CONTIG ? base + q : base + static_cast<long long>(q) * pos_stride;
}

// Position on a line of length L that the reflect-padded position q (any
// integer; 0 .. L - 1 is the line itself) mirrors: a triangle wave of period
// 2(L - 1) without repeating the edge sample; a line of one sample repeats it.
// One reflection settles it unless the pad is longer than the line.
__device__ __noinline__ int reflect_index_far(int q, int L) {
  if (L == 1) return 0;
  const int m = 2 * (L - 1);
  int r = q % m;
  if (r < 0) r += m;
  return r < L ? r : m - r;
}

__device__ __forceinline__ int reflect_index(int q, int L) {
  int r = q < 0 ? -q : q;
  r = r >= L ? 2 * (L - 1) - r : r;
  return r >= 0 && r < L ? r : reflect_index_far(q, L);
}

// Dynamic shared memory a block of the generic kernels may take: the card's
// 227 KB a block (232,448 bytes on sm_90) less a margin for the static arrays.
constexpr int kMaxDynamicShared = 232448 - 1024;

// Calls f(line, column) for the thread's share of a lines x ncols tile of the
// generic kernels (odd K > 31: widths known at run time; lines = 2^lines_log2
// <= kTileLines), a warp's lanes on neighbouring addresses of the contiguous
// axis: along the columns of one line when positions are contiguous, along
// the lines of a column otherwise.
template <bool CONTIG, typename F>
__device__ __forceinline__ void for_each_in_generic_tile(int lines, int lines_log2, int ncols, F f) {
  if (CONTIG) {
    for (int ln = threadIdx.x / 32; ln < lines; ln += kWarps)
#pragma unroll 4
      for (int c = threadIdx.x % 32; c < ncols; c += 32) f(ln, c);
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < lines * ncols; i += kThreads) f(i & (lines - 1), i >> lines_log2);
  }
}

}  // namespace ssar_median
