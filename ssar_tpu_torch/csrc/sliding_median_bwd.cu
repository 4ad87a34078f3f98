// Backward of the sliding-window median (odd width k, torch-'reflect'
// padded) for Hopper (sm_90a): routes each output cotangent g[t] to the
// FIRST window tap equal to the median out[t] and folds the reflect halo
// back onto the interior.  A window without an equal tap (a NaN) routes
// nothing.
//
// Replaces the TPU package's VJP ssar_tpu/ops/median_pallas.py
// (_sliding_median_bwd, attached to sliding_median_lastaxis by defvjp), which
// materialises the (F, T, k) window tensor and scatters it back tap by tap.
//
// What bounds it on this card: bytes.  x, out and g are read once and gx is
// written once, 16 bytes an element, against at most k compares for the
// search and k compare-and-adds for the gather (~3k operations, 93 at
// k = 31): 4.8 ps of memory time against 1.4 ps of fp32 time an element.
//
// Design: a gather, not a scatter, so there are no atomics and two launches
// give the same bits.  A block owns a ROWS x TT tile of INPUT positions.
//   1. It stages x with a halo of 2(k/2) and out and g with a halo of k/2
//      into shared memory (reflection resolved on load, as the forward does).
//   2. Every staged output t finds its selected tap sel[t] (the smallest i
//      with xp[t + i] == out[t]) from the staged tile.  Outputs in the halo
//      range are recomputed by the neighbouring block as well.
//   3. Each thread owns one input position j and sums, in a fixed order, the
//      g[t] of every output whose selected tap lands on one of the padded
//      positions that map to j: j + p itself, the left-halo position p - j
//      (for 1 <= j <= p) and the right-halo position 2L + p - 2 - j (for
//      L - p - 1 <= j <= L - 2).  All those outputs lie inside the staged
//      range.  The order (taps ascending within a padded position; interior,
//      then left halo, then right halo) is the one of the plain PyTorch
//      version, so the two agree bit for bit.
// Lines run along the last axis (contiguous) or the one before it (strided)
// through the strides of a (batch, row, position) view, with the forward's
// thread mappings.  k is a run-time argument: the loops are short and the
// kernel is bound by memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHalf = 15;  // k <= 31

__device__ __forceinline__ int reflect_index(int p, int L) {
  if (p < 0) p = -p;
  if (p >= L) p = 2 * (L - 1) - p;
  return p;
}

template <int ROWS, int TT, bool CONTIG>
__global__ void __launch_bounds__(kThreads)
sliding_median_bwd_kernel(const float* __restrict__ x, const float* __restrict__ out,
                          const float* __restrict__ g, float* __restrict__ gx, int k,
                          long long n_rows, int L, long long rows_per_batch,
                          long long batch_stride, long long row_stride,
                          long long pos_stride, long long n_pos_tiles) {
  static_assert(ROWS * TT == kThreads, "one input position per thread");
  constexpr int XW_MAX = TT + 4 * kMaxHalf;
  constexpr int OW_MAX = TT + 2 * kMaxHalf;
  constexpr int XP = CONTIG ? XW_MAX : (XW_MAX | 1);
  constexpr int OP = CONTIG ? OW_MAX : (OW_MAX | 1);
  __shared__ float xs[ROWS * XP];
  __shared__ float os[ROWS * OP];
  __shared__ float gs[ROWS * OP];
  __shared__ int sel[ROWS * OP];

  const int p = k / 2;
  const int xw = TT + 4 * p;   // interior coordinates pos0 - 2p .. pos0 + TT - 1 + 2p
  const int ow = TT + 2 * p;   // outputs            pos0 - p  .. pos0 + TT - 1 + p

  const long long bid = blockIdx.x;
  const long long row0 = (bid / n_pos_tiles) * ROWS;
  const int pos0 = static_cast<int>(bid % n_pos_tiles) * TT;

  // 1. stage x (reflected) and out, g (zero outside the line)
  for (int idx = threadIdx.x; idx < ROWS * xw; idx += kThreads) {
    int rr, c;
    if (CONTIG) { rr = idx / xw; c = idx % xw; }
    else        { c = idx / ROWS; rr = idx % ROWS; }
    const long long row = row0 + rr;
    const int e = reflect_index(pos0 - 2 * p + c, L);
    float v = 0.f;
    if (row < n_rows && e >= 0 && e < L) {
      const long long base = (row / rows_per_batch) * batch_stride + (row % rows_per_batch) * row_stride;
      v = x[base + static_cast<long long>(e) * pos_stride];
    }
    xs[rr * XP + c] = v;
  }
  for (int idx = threadIdx.x; idx < ROWS * ow; idx += kThreads) {
    int rr, u;
    if (CONTIG) { rr = idx / ow; u = idx % ow; }
    else        { u = idx / ROWS; rr = idx % ROWS; }
    const long long row = row0 + rr;
    const int t = pos0 - p + u;
    float o = 0.f, gv = 0.f;
    if (row < n_rows && t >= 0 && t < L) {
      const long long off = (row / rows_per_batch) * batch_stride + (row % rows_per_batch) * row_stride
                            + static_cast<long long>(t) * pos_stride;
      o = out[off];
      gv = g[off];
    }
    os[rr * OP + u] = o;
    gs[rr * OP + u] = gv;
  }
  __syncthreads();

  // 2. the selected tap of every staged output (-1: none, or no such output)
  for (int idx = threadIdx.x; idx < ROWS * ow; idx += kThreads) {
    int rr, u;
    if (CONTIG) { rr = idx / ow; u = idx % ow; }
    else        { u = idx / ROWS; rr = idx % ROWS; }
    const int t = pos0 - p + u;
    int s = -1;
    if (row0 + rr < n_rows && t >= 0 && t < L) {
      const float o = os[rr * OP + u];
      const float* w = xs + rr * XP + u;   // window of output t: x-tile columns u .. u + k - 1
      for (int i = 0; i < k; ++i) {
        if (w[i] == o) { s = i; break; }
      }
    }
    sel[rr * OP + u] = s;
  }
  __syncthreads();

  // 3. gather per input position
  int rr, tt;
  if (CONTIG) { rr = threadIdx.x / TT; tt = threadIdx.x % TT; }
  else        { tt = threadIdx.x / ROWS; rr = threadIdx.x % ROWS; }
  const long long row = row0 + rr;
  const int j = pos0 + tt;
  if (row >= n_rows || j >= L) return;
  const int* srow = sel + rr * OP;
  const float* grow = gs + rr * OP;

  // padded position j + p: outputs t = j + p - i, staged column tt + 2p - i
  float acc = 0.f;
  for (int i = 0; i < k; ++i) {
    const int u = tt + 2 * p - i;
    if (srow[u] == i) acc += grow[u];
  }
  if (j >= 1 && j <= p) {              // left halo: padded position p - j
    const int q = p - j;
    float h = 0.f;
    for (int i = 0; i <= q; ++i) {     // outputs t = q - i >= 0
      const int u = q - i - pos0 + p;
      if (u >= 0 && u < ow && srow[u] == i) h += grow[u];
    }
    acc += h;
  }
  if (p > 0 && j >= L - p - 1 && j <= L - 2) {   // right halo: padded position 2L + p - 2 - j
    const int q = 2 * L + p - 2 - j;
    float h = 0.f;
    for (int i = 0; i < k; ++i) {
      const int t = q - i;
      if (t > L - 1) continue;
      if (t < 0) break;
      const int u = t - pos0 + p;
      if (u >= 0 && u < ow && srow[u] == i) h += grow[u];
    }
    acc += h;
  }
  const long long base = (row / rows_per_batch) * batch_stride + (row % rows_per_batch) * row_stride;
  gx[base + static_cast<long long>(j) * pos_stride] = acc;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  x, out, g and gx share one
// layout: the line of row r starts at (r / rows_per_batch) * batch_stride +
// (r % rows_per_batch) * row_stride and steps by pos_stride (in elements).
// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an even or too wide k, or a
// line no longer than k / 2).
extern "C" int ssar_sliding_median_bwd_f32(const float* x, const float* out, const float* g, float* gx,
                                           int k, long long n_rows, int L, long long rows_per_batch,
                                           long long batch_stride, long long row_stride,
                                           long long pos_stride, void* stream) {
  if (k < 1 || k % 2 != 1 || k / 2 > kMaxHalf || L <= k / 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pos_stride == 1) {
    constexpr int ROWS = 4, TT = 64;
    const long long n_pos_tiles = (L + TT - 1) / TT;
    const long long n_blocks = (n_rows + ROWS - 1) / ROWS * n_pos_tiles;
    if (n_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    sliding_median_bwd_kernel<ROWS, TT, true><<<static_cast<unsigned>(n_blocks), kThreads, 0, s>>>(
        x, out, g, gx, k, n_rows, L, rows_per_batch, batch_stride, row_stride, pos_stride, n_pos_tiles);
  } else {
    constexpr int ROWS = 32, TT = 8;
    const long long n_pos_tiles = (L + TT - 1) / TT;
    const long long n_blocks = (n_rows + ROWS - 1) / ROWS * n_pos_tiles;
    if (n_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    sliding_median_bwd_kernel<ROWS, TT, false><<<static_cast<unsigned>(n_blocks), kThreads, 0, s>>>(
        x, out, g, gx, k, n_rows, L, rows_per_batch, batch_stride, row_stride, pos_stride, n_pos_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
