// Temporal absolute-difference envelope for Hopper (sm_90a), batched.
//
//   y[b, t] = sum_e |x[b, t+1, e] - x[b, t, e]|   for t < T - 1,
//   y[b, T-1] = y[b, T-2]
//
// x is (B, T, E) float32, float16 or bfloat16, contiguous; y is (B, T) of the
// same dtype.  Each element is widened to float32 in registers (exact), the
// sums are float32, and y is rounded to its dtype to nearest even, as
// `.to(dtype)` rounds the float32 result.
//
// Replaces the TPU kernel ssar_tpu/ops/absdiff.py (_absdiff_kernel, launched
// by absdiff_pallas), which accumulates element blocks into a time block by
// revisiting the output block along a sequential grid axis.  Blocks on this
// card run in no order and nothing carries over between them, so the time
// axis is cut into chunks and, where the chunks are too few to fill the card,
// the element axis into slices, with a fixed-order sum across slices.
//
// What bounds it on this card: bytes.  One subtraction, one absolute value and
// one add per element against 2 or 4 bytes read, far below the card's ~20
// fp32 operations per byte of device memory bandwidth.  The design keeps the
// memory system busy at every shape:
//
// * Block (b, slice s, chunk c) takes TC consecutive differences t0 .. t0+TC-1
//   of batch row b over the element units of slice s.  Its threads (up to
//   384) stride along the units (a unit is 16 bytes: 4 floats or 8 halves,
//   loaded as one uint4, neighbouring threads on neighbouring addresses);
//   each walks down the TC + 1 rows of its unit, all loads independent and in
//   flight at once, keeping TC partial sums.  A chunk re-reads its first row,
//   which the chunk before it reads as its last: 1/TC of the bytes, mostly
//   from L2, since the two blocks are neighbours in the grid.  A ragged E
//   (E * itemsize not a multiple of 16) or a base not 16-byte aligned takes
//   the same kernel with one element a unit.
// * A plan on the host (make_plan: a pure function of B, T, E, the dtype, the
//   alignment and the SM count) picks TC (16, or 8 where that alone fills
//   the card) and the number of slices S.  S = 1 wherever the chunks alone
//   fill kFillBlocksPerSM blocks an SM, as the train loss's (32, 192, E)
//   shapes do: each block then writes y itself.  Otherwise S slices aim at
//   kSplitBlocksPerSM blocks an SM (few long rows: (1, 192, 3 * 1024^2) gets
//   12 chunks x 342 slices), each slice a whole number of iterations of the
//   block's threads and at least kMinUnitsPerThread units a thread.  384
//   threads run the train loss's rows (2304 and 1152 units at float32 and
//   16-bit (32, 192, 9216)) in whole iterations too.
// * With S > 1 each block writes its TC sums to a float32 workspace, and the
//   last of a chunk's S blocks to finish (an integer ticket: each block
//   fences its writes, then takes atomicAdd on the chunk's counter) adds the
//   S partials in slice order 0 .. S-1 and writes y, then resets the counter
//   to 0 for the next launch.  No float atomics: every sum has a fixed order,
//   and two launches agree bit for bit.  One launch a call, whatever the plan.
// * Within a block: each thread's TC sums in unit order, a warp butterfly,
//   then the warps in order.
//
// With -DSSAR_HOST_EMULATION the file compiles as plain C++ and the entry
// points run the same kernel on host threads (see host_emulation.h), so the
// plan, the index arithmetic, the split with its ticket and the half-type
// conversions can be checked without a card.

#ifdef SSAR_HOST_EMULATION
#include "host_emulation.h"
#else
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#define SSAR_LAUNCH(kernel, blocks, threads, stream, ...) kernel<<<blocks, threads, 0, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kMaxThreads = 384;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kTC = 16;                // differences a block, or
constexpr int kTCSmall = 8;            // where that alone fills the card
constexpr int kFillBlocksPerSM = 4;    // chunks alone at least this many blocks an SM: no split
constexpr int kSplitBlocksPerSM = 32;  // otherwise the slices aim at this many
constexpr int kMinUnitsPerThread = 2;  // a slice keeps at least this many units a thread

enum Kind { kF32 = 0, kF16 = 1, kBF16 = 2 };

// One 32-bit word of x holds one float or two 16-bit values (element 2k in
// the low half).  All conversions to float are exact.
template <int K>
__device__ __forceinline__ float lo_of(unsigned w) {
  if constexpr (K == kF32) return __uint_as_float(w);
  else if constexpr (K == kBF16) return __uint_as_float(w << 16);
  else return __half2float(__ushort_as_half(static_cast<unsigned short>(w & 0xffffu)));
}

template <int K>
__device__ __forceinline__ float hi_of(unsigned w) {
  if constexpr (K == kBF16) return __uint_as_float(w & 0xffff0000u);
  else return __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16)));
}

template <int K, bool kVec>
struct Unit {
  static constexpr int N = kVec ? (K == kF32 ? 4 : 8) : 1;  // elements a unit
};

// The elements of unit i of x (in units from x).
template <int K, bool kVec>
__device__ __forceinline__ void load_unit(const void* __restrict__ x, long long i, float* v) {
  if constexpr (kVec) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(x) + i);
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (K == kF32) {
        v[k] = lo_of<K>(w[k]);
      } else {
        v[2 * k] = lo_of<K>(w[k]);
        v[2 * k + 1] = hi_of<K>(w[k]);
      }
    }
  } else if constexpr (K == kF32) {
    v[0] = __ldg(reinterpret_cast<const float*>(x) + i);
  } else {
    v[0] = lo_of<K>(__ldg(reinterpret_cast<const unsigned short*>(x) + i));
  }
}

template <int K>
__device__ __forceinline__ void store(void* y, long long i, float v) {
  if constexpr (K == kF32) reinterpret_cast<float*>(y)[i] = v;
  else if constexpr (K == kF16) reinterpret_cast<unsigned short*>(y)[i] = __half_as_ushort(__float2half_rn(v));
  else reinterpret_cast<unsigned short*>(y)[i] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// acc[r] += sum over the thread's units u of sum_j |row r+1 - row r| (kFull:
// all TC differences; else the first n).
template <int K, int TC, bool kVec, bool kFull>
__device__ __forceinline__ void sweep(const void* __restrict__ x, long long first, long long stride,
                                      long long u0, long long u1, int n, float* acc) {
  constexpr int N = Unit<K, kVec>::N;
  for (long long u = u0 + threadIdx.x; u < u1; u += blockDim.x) {
    float prev[N];
    load_unit<K, kVec>(x, first + u, prev);
#pragma unroll
    for (int r = 0; r < TC; ++r) {
      if (kFull || r < n) {
        float cur[N];
        load_unit<K, kVec>(x, first + (r + 1) * stride + u, cur);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          acc[r] += fabsf(cur[j] - prev[j]);
          prev[j] = cur[j];
        }
      }
    }
  }
}

#define SSAR_ABSDIFF_PARAMS                                                                              \
  const void* __restrict__ x, void* __restrict__ y, int* __restrict__ tickets, float* __restrict__ partial, \
      int T, long long units, int chunks, int slices, long long per_slice

// One block of the grid: (b, s, c) from blockIdx.x, c fastest.
template <int K, int TC, bool kVec>
__device__ __forceinline__ void absdiff_block(SSAR_ABSDIFF_PARAMS) {
  const int c = static_cast<int>(blockIdx.x % static_cast<unsigned>(chunks));
  const int s = static_cast<int>((blockIdx.x / static_cast<unsigned>(chunks)) % static_cast<unsigned>(slices));
  const int b = static_cast<int>(blockIdx.x / static_cast<unsigned>(chunks) / static_cast<unsigned>(slices));
  const int t0 = c * TC;
  const int n = T - 1 - t0 < TC ? T - 1 - t0 : TC;  // differences in this chunk (>= 1)
  const long long u0 = s * per_slice;
  const long long u1 = u0 + per_slice < units ? u0 + per_slice : units;
  const long long first = (static_cast<long long>(b) * T + t0) * units;  // row t0 of batch row b, in units

  float acc[TC];
#pragma unroll
  for (int r = 0; r < TC; ++r) acc[r] = 0.f;
  if (n == TC) sweep<K, TC, kVec, true>(x, first, units, u0, u1, n, acc);
  else sweep<K, TC, kVec, false>(x, first, units, u0, u1, n, acc);

  __shared__ float part[TC][kMaxWarps];
  __shared__ int last;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
#pragma unroll
  for (int r = 0; r < TC; ++r) {
    const float v = warp_sum(acc[r]);
    if (lane == 0) part[r][warp] = v;
  }
  __syncthreads();
  const int r = threadIdx.x;
  float sum = 0.f;
  if (r < n)
    for (int w = 0; w < warps; ++w) sum += part[r][w];

  const long long yrow = static_cast<long long>(b) * T;
  if (slices > 1) {
    float* chunk_partial = partial + (static_cast<long long>(b) * chunks + c) * slices * TC;
    if (r < n) chunk_partial[s * TC + r] = sum;
    __threadfence();  // this block's partials are visible before its ticket is
    __syncthreads();
    if (threadIdx.x == 0) {
      int* ticket = tickets + static_cast<long long>(b) * chunks + c;
      last = atomicAdd(ticket, 1) == slices - 1;
      if (last) *ticket = 0;  // every slice has arrived: ready for the next launch
      __threadfence();
    }
    __syncthreads();
    if (!last) return;
    if (r < n) {
      sum = 0.f;
      for (int q = 0; q < slices; ++q) sum += __ldcg(chunk_partial + q * TC + r);  // slice order
    }
  }
  if (r < n) {
    store<K>(y, yrow + t0 + r, sum);
    if (t0 + r == T - 2) store<K>(y, yrow + T - 1, sum);
  }
}

// float32 at two blocks an SM or more (at most 85 registers a thread, room
// for each unit's TC + 1 loads in flight); the 16-bit types at the compiler's
// own register count, which measured faster for them on the H100
// (scripts/explore_torch_absdiff.py).
template <int K, int TC, bool kVec>
__global__ void __launch_bounds__(kMaxThreads, 2) absdiff_kernel(SSAR_ABSDIFF_PARAMS) {
  absdiff_block<K, TC, kVec>(x, y, tickets, partial, T, units, chunks, slices, per_slice);
}

template <int K, int TC, bool kVec>
__global__ void __launch_bounds__(kMaxThreads) absdiff_kernel_16bit(SSAR_ABSDIFF_PARAMS) {
  absdiff_block<K, TC, kVec>(x, y, tickets, partial, T, units, chunks, slices, per_slice);
}

struct Plan {
  int vec;             // 1: 16-byte units; 0: one element a unit
  long long units;     // units a row
  int threads;         // a block: 32 .. kMaxThreads, a multiple of 32
  int tc;              // differences a block
  long long chunks;    // chunks of a batch row
  long long slices;    // slices of the element axis
  long long per_slice; // units a slice
};

Plan make_plan(int B, int T, long long E, int itemsize, bool aligned, int sms) {
  Plan p;
  p.vec = aligned && (E * itemsize) % 16 == 0;
  p.units = p.vec ? E * itemsize / 16 : E;
  p.threads = p.units >= kMaxThreads ? kMaxThreads : static_cast<int>((p.units + 31) / 32 * 32);
  const long long diffs = T - 1, fill = static_cast<long long>(kFillBlocksPerSM) * sms;
  const long long chunks = (diffs + kTC - 1) / kTC, chunks_small = (diffs + kTCSmall - 1) / kTCSmall;
  p.tc = diffs <= kTCSmall || (chunks * B < fill && chunks_small * B >= fill) ? kTCSmall : kTC;
  p.chunks = p.tc == kTC ? chunks : chunks_small;
  long long slices = 1;
  const long long blocks = p.chunks * B;
  if (blocks < fill) {
    slices = (static_cast<long long>(kSplitBlocksPerSM) * sms + blocks - 1) / blocks;
    const long long cap = p.units / (static_cast<long long>(kMinUnitsPerThread) * p.threads);
    if (slices > cap) slices = cap > 1 ? cap : 1;
  }
  // a split plan's slices in whole iterations of the block's threads
  p.per_slice = slices == 1 ? p.units : ((p.units + slices - 1) / slices + p.threads - 1) / p.threads * p.threads;
  p.slices = (p.units + p.per_slice - 1) / p.per_slice;
  return p;
}

// Ticket counters (kFillBlocksPerSM * sms ints: a split plan has fewer
// chunks than that) and then the partial sums (S * chunks * B * TC <
// (kSplitBlocksPerSM + kFillBlocksPerSM) * sms * kTC floats).
long long counter_bytes(int sms) { return 4LL * kFillBlocksPerSM * sms; }
long long scratch_bytes_for(int sms) {
  return counter_bytes(sms) + 4LL * (kSplitBlocksPerSM + kFillBlocksPerSM) * sms * kTC;
}

int itemsize_of(int dtype) { return dtype == kF32 ? 4 : 2; }

template <int K, int TC, bool kVec>
cudaError_t launch(const Plan& p, const void* x, void* y, int B, int T, int* tickets, float* partial,
                   cudaStream_t stream) {
  const auto kernel = [] {
    if constexpr (K == kF32) return absdiff_kernel<K, TC, kVec>;
    else return absdiff_kernel_16bit<K, TC, kVec>;
  }();
  const unsigned blocks = static_cast<unsigned>(p.chunks * p.slices * B);
  SSAR_LAUNCH(kernel, blocks, static_cast<unsigned>(p.threads), stream, x, y, tickets, partial, T, p.units,
              static_cast<int>(p.chunks), static_cast<int>(p.slices), p.per_slice);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_kind(const Plan& p, const void* x, void* y, int B, int T, int* tickets, float* partial,
                        cudaStream_t stream) {
  if (p.tc == kTC)
    return p.vec ? launch<K, kTC, true>(p, x, y, B, T, tickets, partial, stream)
                 : launch<K, kTC, false>(p, x, y, B, T, tickets, partial, stream);
  return p.vec ? launch<K, kTCSmall, true>(p, x, y, B, T, tickets, partial, stream)
               : launch<K, kTCSmall, false>(p, x, y, B, T, tickets, partial, stream);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  dtype: 0 float32, 1 float16,
// 2 bfloat16; sms: the SM count the plan aims at.

// Bytes of the scratch buffer `ssar_absdiff` needs at this SM count, whatever
// the shape.  Its first bytes are ticket counters and must be zero at the
// first call; each call leaves them zero.
extern "C" long long ssar_absdiff_scratch_bytes(int sms) { return scratch_bytes_for(sms); }

// The plan of a call: out = {vec, units, threads, tc, chunks, slices, per_slice}.
extern "C" int ssar_absdiff_plan(int B, int T, long long E, int dtype, int aligned, int sms, long long* out) {
  if (B <= 0 || T < 2 || E <= 0 || sms <= 0 || dtype < kF32 || dtype > kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(B, T, E, itemsize_of(dtype), aligned != 0, sms);
  const long long v[7] = {p.vec, p.units, p.threads, p.tc, p.chunks, p.slices, p.per_slice};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return static_cast<int>(cudaSuccess);
}

// y (B, T) from x (B, T, E), both of `dtype`.  Needs T >= 2, E >= 1 and a
// scratch of ssar_absdiff_scratch_bytes(sms) that no other call uses at the
// same time.  Launches once on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch.
extern "C" int ssar_absdiff(const void* x, void* y, int dtype, int B, int T, long long E, int sms,
                            void* scratch, long long scratch_bytes, void* stream) {
  if (B <= 0 || T < 2 || E <= 0 || sms <= 0 || dtype < kF32 || dtype > kBF16 ||
      scratch_bytes < scratch_bytes_for(sms))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const Plan p = make_plan(B, T, E, itemsize_of(dtype), aligned, sms);
  if (p.chunks * p.slices * B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  int* tickets = static_cast<int*>(scratch);
  float* partial = reinterpret_cast<float*>(static_cast<char*>(scratch) + counter_bytes(sms));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return static_cast<int>(launch_kind<kF32>(p, x, y, B, T, tickets, partial, s));
  if (dtype == kF16) return static_cast<int>(launch_kind<kF16>(p, x, y, B, T, tickets, partial, s));
  return static_cast<int>(launch_kind<kBF16>(p, x, y, B, T, tickets, partial, s));
}
