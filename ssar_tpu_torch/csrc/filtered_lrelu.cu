// StyleGAN3's filtered leaky ReLU as one kernel a layer (F1), for Hopper (sm_90a).
//
// Every synthesis layer of StyleGAN3 ends in the op of NVlabs/stylegan3's
// torch_utils/ops/filtered_lrelu (its _filtered_lrelu_ref fixes the order):
// add the channel's bias, upsample x`up` with the up-filter fu (gain up^2),
// leaky ReLU with its gain and clamp, filter with fd and keep every `down`-th
// sample.  The plain version (ssar_tpu_torch/ops/filtered_lrelu.py) runs it as
// banded matrix products over the whole upsampled grid, which it writes to
// device memory and reads back about four times; it is the CPU path and the
// card tests' reference.  This kernel follows the design of the public
// filtered_lrelu.cu of NVlabs/stylegan3 and is written anew for this card.
//
// Replaces no TPU kernel: the JAX package has no StyleGAN3.  It was added
// because the filter took 60-74 % of the StyleGAN3 cell's device time at ~2 %
// of its byte bound (PERF.md §5).
//
// What bounds it: fp32 FMAs and shared memory, not HBM.  Each block takes a
// tile of TH x TW output pixels of one (sample, channel) plane and
//   1. stages the input tile and its halo from HBM into shared memory (float32,
//      the bias added, zero outside the plane);
//   2. upsamples along W, polyphase: upsampled sample m is
//      sum_t x[g + t] * hu[k0 + up t] over the KU / up taps of its phase k0,
//      so no inserted zero is multiplied; the `up` samples of one "group" g
//      share their inputs x[g .. g + KU/up - 1];
//   3. in one column pass, upsamples along H the same way, applies the leaky
//      ReLU and the clamp, and filters along H (with the gain), computing the
//      kept rows alone: a thread streams the upsampled samples of a column
//      through registers into the accumulators of a run of output rows, so
//      the 2-D upsampled tile is never stored, not even in shared memory;
//   4. filters along W, the kept samples alone;
//   5. writes the output tile once, coalesced.
// A layer reads its input and writes its output once (plus the tiles'
// halos, from L2).  Each thread computes a run of groups or outputs from one
// sliding window of registers, so a shared-memory load feeds several FMAs;
// the taps are the kernel's parameters (the constant bank), operands of the
// FMAs themselves.  Shared-memory rows have odd strides, so the passes whose
// lanes walk down a column meet no bank conflict.  The gain is folded into
// the H down-filter and the clamp's bound divided by it, as the plain version
// does.  Offsets are 64-bit.
//
// Precision: a float16 layer reads and writes float16 and computes in float32;
// a float32 layer is float32 throughout.  Every tap of both axes and the clamp
// are applied.  The ToRGB class (up = down = 1, one tap) is bias, leaky ReLU,
// clamp and gain, pixel by pixel, in the same kernel.
//
// With -DSSAR_HOST_EMULATION the file compiles as plain C++ and the entry
// point runs the same kernel bodies block by block on host threads (see
// host_emulation.h), so the index arithmetic can be checked without a card.

#ifdef SSAR_HOST_EMULATION
#include "host_emulation.h"
#else
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#define SSAR_LAUNCH_DYNAMIC(kernel, blocks, threads, bytes, stream, ...) \
  kernel<<<blocks, threads, bytes, stream>>>(__VA_ARGS__)
#define SSAR_DYNAMIC_SHARED(type, name) extern __shared__ type name[]
#endif

namespace {

constexpr int kMaxUpTaps = 24;
constexpr int kMaxDownTaps = 12;

// The filters as the plain version's matrices hold them, in float32: the
// up-filter flipped and times `up`, the down-filter flipped along W and
// flipped and times the gain along H.
struct FlrTaps {
  float up[kMaxUpTaps];
  float down_w[kMaxDownTaps];
  float down_h[kMaxDownTaps];
};

struct FlrArgs {
  const void* x;        // (planes, h, w), the layer's dtype
  void* y;              // (planes, oh, ow)
  const float* bias;    // (channels,) or null
  long long planes;
  int channels, h, w, oh, ow;
  int px0, py0;         // the padding before the first sample of each axis, on the upsampled grid
  int tiles_x, tiles_y;
  float slope, bound;   // leaky ReLU slope; the clamp's bound over the gain (infinity: no clamp)
};

constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
constexpr int round_up(int a, int b) { return ceil_div(a, b) * b; }
constexpr int odd(int n) { return n | 1; }

// One class of layer: up, down, taps of each filter, the output tile
// (TH x TW), the block's threads, and what a thread computes in each pass: a
// run of RU groups (up along W), of RC output rows of a column (the column
// pass) or of RR outputs of a row (down along W).  TW is chosen so that the
// tile's upsampled columns, DOWN (TW - 1) + KD, are a whole number of rounds
// of the column pass.
template <int UP_, int DOWN_, int KU_, int KD_, int TH_, int TW_, int THREADS_, int RU_, int RC_, int RR_>
struct Class {
  static constexpr int UP = UP_, DOWN = DOWN_, KU = KU_, KD = KD_, TH = TH_, TW = TW_;
  static constexpr int kThreads = THREADS_, RU = RU_, RC = RC_, RR = RR_;
  static constexpr int KT = KU / UP;                                   // taps a phase
  static constexpr bool kUnit = UP == 1 && DOWN == 1 && KU == 1 && KD == 1;
  // along H (rows) and W (columns): upsampled samples the tile's outputs
  // reach, groups computed (along W whole runs), inputs read
  static constexpr int UH = DOWN * (TH - 1) + KD, UW = DOWN * (TW - 1) + KD;
  static constexpr int GH = ceil_div(UH + UP - 1, UP), GW = round_up(ceil_div(UW + UP - 1, UP), RU);
  static constexpr int UBW = GW * UP;
  static constexpr int IH = GH + KT - 1, IW = GW + KT - 1;
  // the pass down along W computes whole runs: TWR outputs, reaching DW columns
  static constexpr int TWR = round_up(TW, RR), DW = DOWN * (TWR - 1) + KD;
  // shared memory: X (IH x IW); A = X upsampled along W (IH x UBW); D = A
  // upsampled along H, activated and filtered along H (TH x DW, its last
  // DW - UW columns unused); O = D filtered along W (TH x TWR), over X and A
  static constexpr int SX = odd(IW), SA = odd(UBW), SD = odd(DW), SO = odd(TWR);
  static constexpr int kX = 0, kA = IH * SX, kD = kA + IH * SA, kO = 0;
  static constexpr int kFloats = kUnit ? 1 : kD + TH * SD;
  static constexpr int kLoads = ceil_div(IH * IW, kThreads);          // inputs a thread stages
  static_assert(kUnit || TH * SO <= kD, "O must fit over X and A");
  static_assert(KU <= kMaxUpTaps && KD <= kMaxDownTaps && KU % UP == 0, "taps");
  static_assert(TH % RC == 0 && (DOWN * RC) % UP == 0, "runs of rows divide the tile and keep the phase");
  static constexpr int kSharedBytes = 4 * kFloats;
};

// 32 x 59 output pixels: 128 upsampled columns, one a thread
using Up2 = Class<2, 2, 12, 12, 32, 59, 128, 4, 32, 8>;
using Up4 = Class<4, 2, 24, 12, 32, 59, 128, 4, 32, 8>;
using Unit = Class<1, 1, 1, 1, 32, 32, 256, 1, 1, 1>;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__half* p, long long i, float v) { p[i] = __float2half_rn(v); }

// max and min that return NaN if either operand is NaN (PTX max.NaN / min.NaN)
__device__ __forceinline__ float max_nan(float a, float b) {
#ifdef SSAR_HOST_EMULATION
  return a != a || b != b ? a + b : (a > b ? a : b);
#else
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#endif
}
__device__ __forceinline__ float min_nan(float a, float b) {
#ifdef SSAR_HOST_EMULATION
  return a != a || b != b ? a + b : (a < b ? a : b);
#else
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#endif
}

// leaky ReLU (a slope in [0, 1]: the larger of v and slope v), then the
// clamp; NaN passes through, as in PyTorch
__device__ __forceinline__ float act(float v, float slope, float bound) {
  return min_nan(max_nan(max_nan(v, v * slope), -bound), bound);
}

// floor(a / b) for b > 0
__device__ __forceinline__ int floor_div(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

// The column pass: up along H, the leaky ReLU and the clamp, and down along H
// (with the gain), from A into D, a run of RC output rows of a column a
// thread.  EY, the offset of the tile's first needed upsampled row in the
// computed rows, fixes at compile time which group and phase each needed row
// is, so each upsampled sample of the run is computed once and streams
// through registers into the accumulators of the output rows it reaches.
template <class C, int EY>
__device__ __forceinline__ void column_pass(const float* A, float* D, int ex, const FlrArgs& a, const FlrTaps& taps) {
  constexpr int UP = C::UP, DOWN = C::DOWN, KT = C::KT, KD = C::KD, RC = C::RC;
  constexpr int N = DOWN * (RC - 1) + KD;          // upsampled rows the run's outputs reach
  constexpr int QN = (EY + N - 1) / UP + 1;        // their groups
  for (int p = threadIdx.x; p < C::UW * (C::TH / RC); p += C::kThreads) {
    const int c = p % C::UW, j0 = (p / C::UW) * RC;
    const float* src = A + (DOWN * j0 / UP) * C::SA + ex + c;
    float in[QN + KT - 1];
#pragma unroll
    for (int s = 0; s < QN + KT - 1; ++s) in[s] = src[s * C::SA];
    float acc[RC];
#pragma unroll
    for (int j = 0; j < RC; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int q = 0; q < QN; ++q) {
#pragma unroll
      for (int k0 = UP - 1; k0 >= 0; --k0) {
        const int u = UP * q + UP - 1 - k0 - EY;   // the row among the N, in increasing order
        if (u < 0 || u >= N) continue;
        float v = 0.0f;
#pragma unroll
        for (int t = 0; t < KT; ++t) v = fmaf(in[q + t], taps.up[k0 + UP * t], v);
        v = act(v, a.slope, a.bound);
#pragma unroll
        for (int j = 0; j < RC; ++j) {
          const int t = u - DOWN * j;
          if (t >= 0 && t < KD) acc[j] = fmaf(v, taps.down_h[t], acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RC; ++j) D[(j0 + j) * C::SD + c] = acc[j];
  }
}

template <class C, int E = 0>
__device__ __forceinline__ void column_pass_at(int ey, const float* A, float* D, int ex, const FlrArgs& a,
                                               const FlrTaps& taps) {
  if constexpr (E < C::UP) {
    if (ey == E)
      column_pass<C, E>(A, D, ex, a, taps);
    else
      column_pass_at<C, E + 1>(ey, A, D, ex, a, taps);
  }
}

template <class C, typename T>
__global__ void __launch_bounds__(C::kThreads) filtered_lrelu_kernel(const FlrArgs a, const FlrTaps taps) {
  constexpr int kThreads = C::kThreads;
  const int tid = threadIdx.x;
  const long long tile = blockIdx.x;
  const int tx = static_cast<int>(tile % a.tiles_x);
  const int ty = static_cast<int>((tile / a.tiles_x) % a.tiles_y);
  const long long plane = tile / (static_cast<long long>(a.tiles_x) * a.tiles_y);
  const T* x = static_cast<const T*>(a.x) + plane * a.h * a.w;
  T* y = static_cast<T*>(a.y) + plane * a.oh * a.ow;
  const float bias = a.bias ? a.bias[plane % a.channels] : 0.0f;
  const int oy0 = ty * C::TH, ox0 = tx * C::TW;

  if constexpr (C::kUnit) {
    for (int p = tid; p < C::TH * C::TW; p += kThreads) {
      const int r = oy0 + p / C::TW, c = ox0 + p % C::TW;
      if (r < a.oh && c < a.ow) {
        const long long i = static_cast<long long>(r) * a.w + c;
        store(y, static_cast<long long>(r) * a.ow + c, act(to_float(x[i]) + bias, a.slope, a.bound) * taps.down_h[0]);
      }
    }
    return;
  } else {
    constexpr int UP = C::UP, DOWN = C::DOWN, KT = C::KT, KD = C::KD;
    SSAR_DYNAMIC_SHARED(float, smem);
    float* X = smem + C::kX;
    float* A = smem + C::kA;
    float* D = smem + C::kD;
    float* O = smem + C::kO;   // written once A is spent

    // the tile's first upsampled sample m0 on each axis, its first group g0 =
    // ceil((m0 - p0) / up) (the first input read) and the offset e of m0 in
    // the computed samples, which start at up g0 + p0 - up + 1
    const int m0y = DOWN * oy0, m0x = DOWN * ox0;
    const int g0y = floor_div(m0y - a.py0 + UP - 1, UP), g0x = floor_div(m0x - a.px0 + UP - 1, UP);
    const int ey = m0y - (UP * g0y + a.py0 - UP + 1), ex = m0x - (UP * g0x + a.px0 - UP + 1);

    // 1. the input tile and its halo, the bias added, zeros outside the plane:
    // all of a thread's loads in flight before its first store
    float staged[C::kLoads];
#pragma unroll
    for (int i = 0; i < C::kLoads; ++i) {
      const int p = tid + i * kThreads, r = p / C::IW, c = p % C::IW;
      const int gy = g0y + r, gx = g0x + c;
      const bool inside = p < C::IH * C::IW && gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
      staged[i] = inside ? to_float(x[static_cast<long long>(gy) * a.w + gx]) + bias : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < C::kLoads; ++i) {
      const int p = tid + i * kThreads;
      if (p < C::IH * C::IW) X[(p / C::IW) * C::SX + p % C::IW] = staged[i];
    }
    __syncthreads();

    // 2. up along W: a thread takes a row and a run of RU groups (lanes walk down the rows)
    for (int p = tid; p < C::IH * (C::GW / C::RU); p += kThreads) {
      const int r = p % C::IH, q0 = (p / C::IH) * C::RU;
      float in[C::RU + KT - 1];
#pragma unroll
      for (int s = 0; s < C::RU + KT - 1; ++s) in[s] = X[r * C::SX + q0 + s];
#pragma unroll
      for (int q = 0; q < C::RU; ++q) {
#pragma unroll
        for (int k0 = 0; k0 < UP; ++k0) {
          float acc = 0.0f;
#pragma unroll
          for (int t = 0; t < KT; ++t) acc = fmaf(in[q + t], taps.up[k0 + UP * t], acc);
          A[r * C::SA + UP * (q0 + q) + UP - 1 - k0] = acc;
        }
      }
    }
    __syncthreads();

    // 3. the column pass (lanes walk along the row)
    column_pass_at<C>(ey, A, D, ex, a, taps);
    __syncthreads();

    // 4. down along W, the kept samples alone: a row and a run of RR outputs
    // a thread (lanes walk down the rows)
    for (int p = tid; p < C::TH * (C::TWR / C::RR); p += kThreads) {
      const int r = p % C::TH, k0 = (p / C::TH) * C::RR;
      constexpr int N = DOWN * (C::RR - 1) + KD;
      const float* src = D + r * C::SD + DOWN * k0;
      float in[N];
#pragma unroll
      for (int s = 0; s < N; ++s) in[s] = src[s];
#pragma unroll
      for (int k = 0; k < C::RR; ++k) {
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < KD; ++t) acc = fmaf(in[DOWN * k + t], taps.down_w[t], acc);
        O[r * C::SO + k0 + k] = acc;
      }
    }
    __syncthreads();

    // 5. the output tile, once (lanes walk along the row: coalesced)
    for (int p = tid; p < C::TH * C::TW; p += kThreads) {
      const int r = p / C::TW, c = p % C::TW;
      const int oy = oy0 + r, ox = ox0 + c;
      if (oy < a.oh && ox < a.ow) store(y, static_cast<long long>(oy) * a.ow + ox, O[r * C::SO + c]);
    }
  }
}

template <class C, typename T>
int launch(const FlrArgs& a, const FlrTaps& taps, cudaStream_t s) {
  const long long blocks = a.planes * a.tiles_x * a.tiles_y;
  if (blocks <= 0 || blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  void (*kernel)(FlrArgs, FlrTaps) = filtered_lrelu_kernel<C, T>;
  constexpr int bytes = C::kUnit ? 0 : C::kSharedBytes;
  if (bytes > 48 * 1024) {   // above the default limit (per device, so set on every such call)
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  SSAR_LAUNCH_DYNAMIC(kernel, static_cast<unsigned>(blocks), C::kThreads, static_cast<size_t>(bytes), s, a, taps);
  return static_cast<int>(cudaGetLastError());
}

template <class C>
int launch_dtype(int half, const FlrArgs& a, const FlrTaps& taps, cudaStream_t s) {
  return half ? launch<C, __half>(a, taps, s) : launch<C, float>(a, taps, s);
}

}  // namespace

// sizeof(FlrTaps), for the binding to check its own layout against.
extern "C" int ssar_filtered_lrelu_taps_size() { return static_cast<int>(sizeof(FlrTaps)); }

// Bytes of dynamic shared memory a block of the class takes (-1: no such class).
extern "C" int ssar_filtered_lrelu_shared_bytes(int up, int down, int ku, int kd) {
  if (up == 2 && down == 2 && ku == 12 && kd == 12) return Up2::kSharedBytes;
  if (up == 4 && down == 2 && ku == 24 && kd == 12) return Up4::kSharedBytes;
  if (up == 1 && down == 1 && ku == 1 && kd == 1) return 0;
  return -1;
}

// The filtered leaky ReLU of x (planes, h, w) into y (planes, oh, ow), float32
// (half = 0) or float16 (half = 1), in one launch on `stream`.  The classes
// (up, down, ku, kd) are (2, 2, 12, 12), (4, 2, 24, 12) and (1, 1, 1, 1);
// another returns cudaErrorInvalidValue.  `bound` is the clamp over the gain
// (infinity for none); `taps` a FlrTaps.
extern "C" int ssar_filtered_lrelu(int up, int down, int ku, int kd, int half, const void* x, void* y,
                                   const float* bias, const void* taps, long long planes, int channels, int h,
                                   int w, int oh, int ow, int px0, int py0, float slope, float bound,
                                   void* stream) {
  if (planes <= 0 || channels <= 0 || h <= 0 || w <= 0 || oh <= 0 || ow <= 0 || (half != 0 && half != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  FlrArgs a{x, y, bias, planes, channels, h, w, oh, ow, px0, py0, 0, 0, slope, bound};
  const FlrTaps& t = *static_cast<const FlrTaps*>(taps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (up == 2 && down == 2 && ku == 12 && kd == 12) {
    a.tiles_x = (ow + Up2::TW - 1) / Up2::TW;
    a.tiles_y = (oh + Up2::TH - 1) / Up2::TH;
    return launch_dtype<Up2>(half, a, t, s);
  }
  if (up == 4 && down == 2 && ku == 24 && kd == 12) {
    a.tiles_x = (ow + Up4::TW - 1) / Up4::TW;
    a.tiles_y = (oh + Up4::TH - 1) / Up4::TH;
    return launch_dtype<Up4>(half, a, t, s);
  }
  if (up == 1 && down == 1 && ku == 1 && kd == 1) {
    a.tiles_x = (ow + Unit::TW - 1) / Unit::TW;
    a.tiles_y = (oh + Unit::TH - 1) / Unit::TH;
    return launch_dtype<Unit>(half, a, t, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
