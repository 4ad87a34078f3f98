// Sliding-window median of odd width K along one axis, torch-'reflect'
// padded, for Hopper (sm_90a).  Bit-exact: the median of an odd window is
// one of its elements, and a compare-exchange network only moves elements.
//
// Replaces the TPU kernel ssar_tpu/ops/median_pallas.py (_median_kernel,
// launched by _sliding_median_impl): HPSS runs it twice per track, k = 31
// over time and over frequency of the (1025, T) magnitude spectrogram.
//
// What bounds it on this card: operations.  The odd-even transposition
// network is K*(K-1)/2 compare-exchanges (465 at K = 31), i.e. 930 fp32
// min/max per output, against 8 bytes of device memory traffic per output.
// At (1025, 4320) that is ~4.1 G min/max (~61 us at 67 TFLOP/s fp32) versus
// ~35 MB (~11 us at 3.35 TB/s).
//
// Design: each block stages a ROWS x (TT + K - 1) tile of the input into
// shared memory once, with the reflect halo resolved on load, so the K-fold
// reuse of every input element is served from shared memory instead of
// device memory.  Each thread then copies its output's K-window into
// registers and runs the fully unrolled network there, and writes the
// middle element.  The "rows" are every 1-D line along the filtered axis;
// the caller passes the strides of a (batch, row, position) view, so the
// same kernel filters the last axis (contiguous lines) or the one before it
// (strided lines) without a transpose copy.  Threads are mapped so that
// neighbouring threads touch neighbouring addresses in both cases:
//   CONTIG (pos_stride == 1): threads run along positions, tile 4 x 64;
//   strided (row_stride == 1): threads run along rows, tile 32 x 8, and the
//   shared-memory row pitch is odd so column reads are bank-conflict free.
// Left for later: a median-only selection network (fewer compare-exchanges)
// and vectorised loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int reflect_index(int p, int L) {
  // torch 'reflect' (no edge repeat); valid for pad < L.  Positions past the
  // last reflected one only feed outputs that are never written.
  if (p < 0) p = -p;
  if (p >= L) p = 2 * (L - 1) - p;
  return p;
}

template <int K, int ROWS, int TT, bool CONTIG>
__global__ void __launch_bounds__(kThreads)
sliding_median_kernel(const float* __restrict__ x, float* __restrict__ y,
                      long long n_rows, int L, long long rows_per_batch,
                      long long batch_stride, long long row_stride,
                      long long pos_stride, long long n_pos_tiles) {
  static_assert(ROWS * TT == kThreads, "one output per thread");
  constexpr int H = K / 2;
  constexpr int W = TT + K - 1;
  constexpr int PITCH = CONTIG ? W : (W | 1);
  __shared__ float tile[ROWS * PITCH];

  const long long bid = blockIdx.x;
  const long long row0 = (bid / n_pos_tiles) * ROWS;
  const int pos0 = static_cast<int>(bid % n_pos_tiles) * TT;

  // stage the tile, halo included
  for (int idx = threadIdx.x; idx < ROWS * W; idx += kThreads) {
    int rr, c;
    if (CONTIG) { rr = idx / W; c = idx % W; }
    else        { c = idx / ROWS; rr = idx % ROWS; }
    const long long row = row0 + rr;
    const int p = reflect_index(pos0 - H + c, L);
    float v = 0.f;
    if (row < n_rows && p >= 0 && p < L) {
      const long long base = (row / rows_per_batch) * batch_stride + (row % rows_per_batch) * row_stride;
      v = x[base + static_cast<long long>(p) * pos_stride];
    }
    tile[rr * PITCH + c] = v;
  }
  __syncthreads();

  int rr, tt;
  if (CONTIG) { rr = threadIdx.x / TT; tt = threadIdx.x % TT; }
  else        { tt = threadIdx.x / ROWS; rr = threadIdx.x % ROWS; }
  const long long row = row0 + rr;
  const int pos = pos0 + tt;
  if (row >= n_rows || pos >= L) return;

  float w[K];
#pragma unroll
  for (int j = 0; j < K; ++j) w[j] = tile[rr * PITCH + tt + j];

  // odd-even transposition sort: K rounds of disjoint compare-exchanges
#pragma unroll
  for (int r = 0; r < K; ++r) {
#pragma unroll
    for (int q = r & 1; q < K - 1; q += 2) {
      const float lo = fminf(w[q], w[q + 1]);
      const float hi = fmaxf(w[q], w[q + 1]);
      w[q] = lo;
      w[q + 1] = hi;
    }
  }
  const long long base = (row / rows_per_batch) * batch_stride + (row % rows_per_batch) * row_stride;
  y[base + static_cast<long long>(pos) * pos_stride] = w[H];
}

template <int K>
cudaError_t launch(const float* x, float* y, long long n_rows, int L, long long rows_per_batch,
                   long long batch_stride, long long row_stride, long long pos_stride,
                   cudaStream_t stream) {
  if (pos_stride == 1) {
    constexpr int ROWS = 4, TT = 64;
    const long long n_pos_tiles = (L + TT - 1) / TT;
    const long long n_blocks = (n_rows + ROWS - 1) / ROWS * n_pos_tiles;
    if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    sliding_median_kernel<K, ROWS, TT, true><<<static_cast<unsigned>(n_blocks), kThreads, 0, stream>>>(
        x, y, n_rows, L, rows_per_batch, batch_stride, row_stride, pos_stride, n_pos_tiles);
  } else {
    constexpr int ROWS = 32, TT = 8;
    const long long n_pos_tiles = (L + TT - 1) / TT;
    const long long n_blocks = (n_rows + ROWS - 1) / ROWS * n_pos_tiles;
    if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    sliding_median_kernel<K, ROWS, TT, false><<<static_cast<unsigned>(n_blocks), kThreads, 0, stream>>>(
        x, y, n_rows, L, rows_per_batch, batch_stride, row_stride, pos_stride, n_pos_tiles);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  The line of row r starts at
// (r / rows_per_batch) * batch_stride + (r % rows_per_batch) * row_stride and
// steps by pos_stride (all in elements).  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a window width without an instantiation).
extern "C" int ssar_sliding_median_f32(const float* x, float* y, int k, long long n_rows, int L,
                                       long long rows_per_batch, long long batch_stride,
                                       long long row_stride, long long pos_stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSAR_CASE(KK) \
  case KK: return static_cast<int>(launch<KK>(x, y, n_rows, L, rows_per_batch, batch_stride, row_stride, pos_stride, s));
  switch (k) {
    SSAR_CASE(1) SSAR_CASE(3) SSAR_CASE(5) SSAR_CASE(7) SSAR_CASE(9) SSAR_CASE(11) SSAR_CASE(13)
    SSAR_CASE(15) SSAR_CASE(17) SSAR_CASE(19) SSAR_CASE(21) SSAR_CASE(23) SSAR_CASE(25)
    SSAR_CASE(27) SSAR_CASE(29) SSAR_CASE(31)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SSAR_CASE
}
