// Noise-tree evaluation for the random-patch system, for Hopper (sm_90a).
//
// A StyleGAN2 layer's noise in a random patch is a lazy expression tree
// (ssar_tpu_torch/generate/noise.py): Loop / Blend / Multiply leaves composed
// by Average / Modulate / ScaleBias, evaluated for a window of b frames
// starting at frame i.  These two kernels evaluate a whole tree for one window
// (in place of one eager PyTorch operation per node, ~80 launches a tree):
//
//   loop_sums_kernel  for every Loop leaf and frame, partial sums over the
//                     block's pixels of the leaf's raw value squared (its RMS);
//   tree_kernel       the whole tree at every pixel, for all b frames.
//
// Replaces no TPU kernel: the JAX package leaves the trees to XLA, which fuses
// a chunk's trees with the synthesis into one program
// (ssar_tpu/generate/sample.py:101-120).  PyTorch runs them eagerly, and the
// host's ~1,400 launches a chunk left the card idle (PERF.md §5).
//
// The flat form.  Everything but a Loop's normalisation is affine in the
// leaves, so a tree is
//
//   out[f, p] = sum_k w[k, f] plane_k[p] + sum_l r[l, f] loop_l(f, p)
//               + sum_o c[o, f] opaque_o[f, p] + d[f]
//
// over the bank planes k of the Blend / Multiply leaves (a Blend's bank is 2M
// planes, weighted by mod and by 1 - mod; a Multiply's M, by mod), the Loop
// leaves l and the opaque leaves o (nodes of other types, evaluated by their
// own call and passed in).  Each leaf's coefficient is the product of the
// factors on its path to the root: 1/2 under an Average, a Modulate's mod[t]
// (left) or 1 - mod[t] (right), a ScaleBias's scale; d[f] sums each
// ScaleBias's bias times its own coefficient.  r[l, f] is the Loop's
// coefficient over (rms + eps).  The order of the arithmetic differs from the
// eager one (within a few float32 roundings of it); a Loop's raw value
//   sin(cos(idx[t] + n0) * inv + n1) * n2,   inv = 1 / (sigma / 50) in float32,
// is formed exactly as PyTorch's CUDA operations form it (accurate sinf /
// cosf, no contraction into an FMA, the division by a host scalar as a
// product by its reciprocal), since the phase reaches tens of radians and the
// sine magnifies an ulp of its argument.
//
// What bounds it: bytes.  A tree reads each bank once and writes (b, H, W)
// float32 once (at 1024^2 and b = 16: 64 MiB out, 4 MiB a bank plane in),
// against 16 multiply-adds a plane element.  The design:
// * A thread owns one pixel at a time (grid-stride, coalesced: a warp reads
//   128 contiguous bytes of a plane) and keeps a tile of 16 frames of
//   accumulators in registers, so each plane element is read once for 16
//   frames; b > 16 loops over tiles.  No temporaries go to device memory.
// * The per-frame tables (node coefficients, plane weights w[k, f], loop
//   scales, the bias) are built by each block at the start of a tile, in
//   shared memory, from the modulators' window rows read on the card at the
//   clamped starts (no host-to-device copy per call); a plane's 16 weights are
//   four 16-byte broadcast loads.
// * The Loop RMS needs the whole layer before any pixel can be written:
//   loop_sums_kernel writes one partial sum per (leaf, frame, block) and
//   tree_kernel reduces them in a fixed order (a warp per sum) at the start of
//   a tile.  No atomics: two launches give the same bits.
// * Sines and cosines are computed twice (once in each kernel); at the path's
//   shapes they cost less than the bytes.
//
// With -DSSAR_HOST_EMULATION the file compiles as plain C++ and the entry
// point runs the same kernel bodies block by block on host threads (see
// host_emulation.h), so the tables, the index arithmetic and the reductions
// can be checked without a card.

#ifdef SSAR_HOST_EMULATION
#include "host_emulation.h"
#else
#include <cuda_runtime.h>
#define SSAR_LAUNCH(kernel, blocks, threads, stream, ...) kernel<<<blocks, threads, 0, stream>>>(__VA_ARGS__)
#define SSAR_LAUNCH_DYNAMIC(kernel, blocks, threads, bytes, stream, ...) \
  kernel<<<blocks, threads, bytes, stream>>>(__VA_ARGS__)
#define SSAR_DYNAMIC_SHARED(type, name) extern __shared__ type name[]
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;                        // frames of accumulators a thread keeps
constexpr float kEps = 1.1920928955078125e-7f;   // float32's epsilon, torch.finfo(torch.float32).eps
constexpr int kMaxShared = 232448;               // bytes of shared memory a block can have

enum : int { kConst = 0, kMod = 1, kOneMinusMod = 2 };

// One node, in pre-order (a parent before its children).  `kind` says what
// the node's value is multiplied by on its way into its parent: `constant`,
// mod[t] or 1 - mod[t], t in the window of the parent Modulate's modulator.
struct NtNode {
  const float* mod;
  long long mod_stride;
  int parent;     // -1 at the root
  int kind;
  float constant;
  int mod_len;    // rows of mod
};

// A Blend's bank (2M planes: M weighted by mod, M by 1 - mod) or a
// Multiply's (M planes, by mod); mod is the leaf's (T, M) modulator.
struct NtBank {
  const float* planes;   // (P, H, W), contiguous
  const float* mod;
  long long row_stride, col_stride;
  int node, width, blend, mod_len;
};

struct NtLoop {
  const float* noise;    // (3, H, W), contiguous
  const float* idx;      // (T,) phases
  long long idx_stride;
  int node, len;
  float inv;             // 1 / (sigma / 50), rounded to float32
  int pad;
};

struct NtBias {
  int node;
  float bias;
};

struct NtTree {
  const NtNode* nodes;
  const NtBank* banks;
  const NtLoop* loops;
  const NtBias* biases;
  const int* opaque_nodes;
  int n_nodes, n_banks, n_planes, n_loops, n_biases, n_opaque;
};

__device__ __forceinline__ int window_start(int i, int len, int b) {
  // jax.lax.dynamic_slice_in_dim's clamp, as generate/noise.py:_win does it
  const int hi = len - b;
  return i < hi ? (i > 0 ? i : 0) : (hi > 0 ? hi : 0);
}

__device__ __forceinline__ float loop_value(float phase, float n0, float n1, float n2, float inv) {
  const float freq = __fmul_rn(cosf(__fadd_rn(phase, n0)), inv);
  return __fmul_rn(sinf(__fadd_rn(freq, n1)), n2);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int tile_frames(int b, int f0) { return b - f0 < kTile ? b - f0 : kTile; }

// partials[(l * b + f) * gridDim.x + block]: the block's sum of loop_l(f, p)^2.
__global__ void __launch_bounds__(kThreads) loop_sums_kernel(const NtLoop* loops, int n_loops, int i, int b,
                                                             long long hw, float* partials) {
  __shared__ float red[kWarps][kTile];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (int l = 0; l < n_loops; ++l) {
    const NtLoop lp = loops[l];
    const int start = window_start(i, lp.len, b);
    for (int f0 = 0; f0 < b; f0 += kTile) {
      const int nf = tile_frames(b, f0);
      float phase[kTile], acc[kTile];
#pragma unroll
      for (int f = 0; f < kTile; ++f) {
        phase[f] = f < nf ? lp.idx[(start + f0 + f) * lp.idx_stride] : 0.f;
        acc[f] = 0.f;
      }
      for (long long p = static_cast<long long>(blockIdx.x) * kThreads + tid; p < hw; p += step) {
        const float n0 = __ldg(lp.noise + p), n1 = __ldg(lp.noise + hw + p), n2 = __ldg(lp.noise + 2 * hw + p);
#pragma unroll
        for (int f = 0; f < kTile; ++f) {
          if (f < nf) {
            const float v = loop_value(phase[f], n0, n1, n2, lp.inv);
            acc[f] = fmaf(v, v, acc[f]);
          }
        }
      }
#pragma unroll
      for (int f = 0; f < kTile; ++f) acc[f] = warp_sum(acc[f]);
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < kTile; ++f) red[warp][f] = acc[f];
      }
      __syncthreads();
      if (tid < nf) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += red[w][tid];
        partials[(static_cast<long long>(l) * b + f0 + tid) * gridDim.x + blockIdx.x] = s;
      }
      __syncthreads();
    }
  }
}

// out (b, H, W): the whole tree.  Shared memory, floats unless noted:
// factor / coef [n_nodes][kTile], w [n_planes][kTile], loop scale and phase
// [n_loops][kTile] each, opaque coefficients [n_opaque][kTile], bias [kTile],
// parents [n_nodes] (int).
__global__ void __launch_bounds__(kThreads) tree_kernel(NtTree t, int i, int b, long long hw, const float* opaque,
                                                        const float* partials, int n_partials, float* out) {
  SSAR_DYNAMIC_SHARED(float, shared);
  float* factor = shared;
  float* coef = factor + t.n_nodes * kTile;
  float* w = coef + t.n_nodes * kTile;
  float* loop_scale = w + t.n_planes * kTile;
  float* loop_phase = loop_scale + t.n_loops * kTile;
  float* opaque_coef = loop_phase + t.n_loops * kTile;
  float* bias = opaque_coef + t.n_opaque * kTile;
  int* parent = reinterpret_cast<int*>(bias + kTile);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  const float inv_hw = 1.f / static_cast<float>(hw);
  for (int f0 = 0; f0 < b; f0 += kTile) {
    const int nf = tile_frames(b, f0);
    // 1. each node's own factor, the loops' phases, the loops' sums of squares
    for (int q = tid; q < t.n_nodes * kTile; q += kThreads) {
      const NtNode node = t.nodes[q / kTile];
      const int f = q % kTile;
      float v = 0.f;
      if (f < nf) {
        if (node.kind == kConst) {
          v = node.constant;
        } else {
          const float m = node.mod[(window_start(i, node.mod_len, b) + f0 + f) * node.mod_stride];
          v = node.kind == kMod ? m : 1.f - m;
        }
      }
      factor[q] = v;
      if (f == 0) parent[q / kTile] = node.parent;
    }
    for (int q = tid; q < t.n_loops * kTile; q += kThreads) {
      const NtLoop lp = t.loops[q / kTile];
      const int f = q % kTile;
      loop_phase[q] = f < nf ? lp.idx[(window_start(i, lp.len, b) + f0 + f) * lp.idx_stride] : 0.f;
    }
    for (int q0 = 0; q0 < t.n_loops * kTile; q0 += kWarps) {   // a warp per sum, lanes over the partials
      const int q = q0 + warp, f = q % kTile;
      float s = 0.f;
      if (q < t.n_loops * kTile && f < nf) {
        const float* part = partials + (static_cast<long long>(q / kTile) * b + f0 + f) * n_partials;
        for (int j = lane; j < n_partials; j += 32) s += part[j];
      }
      s = warp_sum(s);
      if (lane == 0 && q < t.n_loops * kTile) loop_scale[q] = s;
    }
    __syncthreads();
    // 2. each node's coefficient: the product of the factors on its path to the root
    for (int q = tid; q < t.n_nodes * kTile; q += kThreads) {
      const int f = q % kTile;
      float c = factor[q];
      for (int m = parent[q / kTile]; m >= 0; m = parent[m]) c *= factor[m * kTile + f];
      coef[q] = c;
    }
    __syncthreads();
    // 3. plane weights, loop scales, opaque coefficients, the bias
    for (int j = 0, plane0 = 0; j < t.n_banks; ++j) {
      const NtBank bank = t.banks[j];
      const int n_planes = bank.width * (bank.blend ? 2 : 1);
      const int start = window_start(i, bank.mod_len, b);
      for (int q = tid; q < n_planes * kTile; q += kThreads) {
        const int k = q / kTile, f = q % kTile;
        float v = 0.f;
        if (f < nf) {
          const float m = bank.mod[(start + f0 + f) * bank.row_stride + (k % bank.width) * bank.col_stride];
          v = coef[bank.node * kTile + f] * (k < bank.width ? m : 1.f - m);
        }
        w[(plane0 + k) * kTile + f] = v;
      }
      plane0 += n_planes;
    }
    for (int q = tid; q < t.n_loops * kTile; q += kThreads) {
      const int f = q % kTile;
      float v = 0.f;
      if (f < nf) {
        const float rms = sqrtf(loop_scale[q] * inv_hw);
        v = coef[t.loops[q / kTile].node * kTile + f] / (rms + kEps);
      }
      loop_scale[q] = v;
    }
    for (int q = tid; q < t.n_opaque * kTile; q += kThreads) {
      const int f = q % kTile;
      opaque_coef[q] = f < nf ? coef[t.opaque_nodes[q / kTile] * kTile + f] : 0.f;
    }
    if (tid < kTile) {
      float d = 0.f;
      if (tid < nf)
        for (int k = 0; k < t.n_biases; ++k) d += coef[t.biases[k].node * kTile + tid] * t.biases[k].bias;
      bias[tid] = d;
    }
    __syncthreads();
    // 4. every pixel of the block, all frames of the tile
    for (long long p = static_cast<long long>(blockIdx.x) * kThreads + tid; p < hw; p += step) {
      float acc[kTile];
#pragma unroll
      for (int f = 0; f < kTile; ++f) acc[f] = bias[f];
      const float4* wk = reinterpret_cast<const float4*>(w);
      for (int j = 0; j < t.n_banks; ++j) {
        const NtBank& bank = t.banks[j];
        const int n_planes = bank.width * (bank.blend ? 2 : 1);
        const float* plane = bank.planes + p;
#pragma unroll 4
        for (int k = 0; k < n_planes; ++k) {
          const float v = __ldg(plane + k * hw);
          const float4* row = wk + k * (kTile / 4);
#pragma unroll
          for (int g = 0; g < kTile / 4; ++g) {
            const float4 c = row[g];
            acc[4 * g] = fmaf(c.x, v, acc[4 * g]);
            acc[4 * g + 1] = fmaf(c.y, v, acc[4 * g + 1]);
            acc[4 * g + 2] = fmaf(c.z, v, acc[4 * g + 2]);
            acc[4 * g + 3] = fmaf(c.w, v, acc[4 * g + 3]);
          }
        }
        wk += n_planes * (kTile / 4);
      }
      for (int l = 0; l < t.n_loops; ++l) {
        const NtLoop& lp = t.loops[l];
        const float n0 = __ldg(lp.noise + p), n1 = __ldg(lp.noise + hw + p), n2 = __ldg(lp.noise + 2 * hw + p);
#pragma unroll
        for (int f = 0; f < kTile; ++f) {
          if (f < nf)
            acc[f] = fmaf(loop_scale[l * kTile + f], loop_value(loop_phase[l * kTile + f], n0, n1, n2, lp.inv), acc[f]);
        }
      }
      for (int o = 0; o < t.n_opaque; ++o) {
        const float* src = opaque + (static_cast<long long>(o) * b + f0) * hw + p;
#pragma unroll
        for (int f = 0; f < kTile; ++f) {
          if (f < nf) acc[f] = fmaf(opaque_coef[o * kTile + f], __ldg(src + f * hw), acc[f]);
        }
      }
#pragma unroll
      for (int f = 0; f < kTile; ++f) {
        if (f < nf) out[(f0 + f) * hw + p] = acc[f];
      }
    }
    __syncthreads();   // the next tile rewrites the tables
  }
}

long long tree_shared_bytes(int n_nodes, int n_planes, int n_loops, int n_opaque) {
  const long long floats = (2LL * n_nodes + n_planes + 2LL * n_loops + n_opaque + 1) * kTile;
  return 4 * (floats + n_nodes);
}

}  // namespace

// sizeof of the four records, for the binding to check its own layouts against.
extern "C" void ssar_noise_tree_record_sizes(int* sizes) {
  sizes[0] = sizeof(NtNode);
  sizes[1] = sizeof(NtBank);
  sizes[2] = sizeof(NtLoop);
  sizes[3] = sizeof(NtBias);
}

// Bytes of shared memory tree_kernel takes for a tree of these counts (it
// refuses trees above 232,448).
extern "C" long long ssar_noise_tree_shared_bytes(int n_nodes, int n_planes, int n_loops, int n_opaque) {
  return tree_shared_bytes(n_nodes, n_planes, n_loops, n_opaque);
}

// The tree's window of frames [i, i + b) (each windowed tensor's start
// clamped into [0, T - b]) into out (b, H, W): loop_sums_kernel on
// `n_partials` blocks when the tree has a Loop leaf, then tree_kernel on at
// most 4 blocks an SM.  `opaque` holds the opaque leaves' windows,
// (n_opaque, b, H, W); `partials` n_loops * b * n_partials floats.
extern "C" int ssar_noise_tree_f32(const void* nodes, const void* banks, const void* loops, const void* biases,
                                   const int* opaque_nodes, int n_nodes, int n_banks, int n_planes, int n_loops,
                                   int n_biases, int n_opaque, int i, int b, long long hw, const float* opaque,
                                   float* partials, int n_partials, float* out, int sm_count, void* stream) {
  if (n_nodes <= 0 || b <= 0 || hw <= 0 || sm_count <= 0 || n_banks < 0 || n_planes < 0 || n_loops < 0 ||
      n_biases < 0 || n_opaque < 0 || (n_loops > 0 && n_partials <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes = tree_shared_bytes(n_nodes, n_planes, n_loops, n_opaque);
  if (bytes > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_loops > 0) {
    SSAR_LAUNCH(loop_sums_kernel, static_cast<unsigned>(n_partials), kThreads, s,
                static_cast<const NtLoop*>(loops), n_loops, i, b, hw, partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (bytes > 48 * 1024) {   // above the default limit (per device, so set on every such call)
    const cudaError_t err = cudaFuncSetAttribute(tree_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long tiles = (hw + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(tiles < 4LL * sm_count ? tiles : 4LL * sm_count);
  const NtTree t{static_cast<const NtNode*>(nodes), static_cast<const NtBank*>(banks),
                 static_cast<const NtLoop*>(loops), static_cast<const NtBias*>(biases), opaque_nodes,
                 n_nodes, n_banks, n_planes, n_loops, n_biases, n_opaque};
  SSAR_LAUNCH_DYNAMIC(tree_kernel, blocks, kThreads, static_cast<size_t>(bytes), s, t, i, b, hw, opaque, partials,
                      n_partials, out);
  return static_cast<int>(cudaGetLastError());
}
