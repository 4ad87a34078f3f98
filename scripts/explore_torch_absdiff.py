"""Variants of the absdiff kernel (B2) side by side on one CUDA card.

    python3 scripts/explore_torch_absdiff.py [--only NAME ...]

Each variant is ``csrc/absdiff.cu`` with a few text substitutions (the plan's
constants, the launch bounds, the loop over units), compiled with nvcc in
parallel into ``build/absdiff_variants/`` (``scripts/cuda_variants.py``) and
bound with ctypes beside the package's own wrapper (``ops/absdiff_cuda.bind``).
At each shape it times (torch.profiler over 20 calls, µs a call) every
variant on the same input, the base first and again last, and ``x.sum()`` on
the same tensor as a yardstick of what one read of these bytes takes on this
card; it checks each variant against the plain version (float32 at rtol
1e-5, half types within one unit in the last place of the float32 result
cast) and prints each variant's registers and spills from ``-Xptxas -v``.
Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import sys

from bench_torch_median import device_us
from cuda_variants import build_variants, card, ptxas_report

SWEEP_ONE = """  for (long long u = u0 + threadIdx.x; u < u1; u += blockDim.x) {
    float prev[N];"""
# two units a thread an iteration (u and u + blockDim.x): each acc[r] takes its terms in the same order
SWEEP_TWO = """  long long u = u0 + threadIdx.x;
  for (; u + blockDim.x < u1; u += 2 * blockDim.x) {
    float p0[N], p1[N];
    load_unit<K, kVec>(x, first + u, p0);
    load_unit<K, kVec>(x, first + u + blockDim.x, p1);
#pragma unroll
    for (int r = 0; r < TC; ++r) {
      if (kFull || r < n) {
        float c0[N], c1[N];
        load_unit<K, kVec>(x, first + (r + 1) * stride + u, c0);
        load_unit<K, kVec>(x, first + (r + 1) * stride + u + blockDim.x, c1);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          acc[r] += fabsf(c0[j] - p0[j]);
          p0[j] = c0[j];
        }
#pragma unroll
        for (int j = 0; j < N; ++j) {
          acc[r] += fabsf(c1[j] - p1[j]);
          p1[j] = c1[j];
        }
      }
    }
  }
  for (; u < u1; u += blockDim.x) {
    float prev[N];"""
F32_BOUNDS = "__launch_bounds__(kMaxThreads, 2) absdiff_kernel("
HALF_BOUNDS = "__launch_bounds__(kMaxThreads) absdiff_kernel_16bit("
THREADS = "constexpr int kMaxThreads = 384;"
SPLIT = "constexpr int kSplitBlocksPerSM = 32;"
ROUND = "  p.per_slice = slices == 1 ? p.units : ((p.units + slices - 1) / slices + p.threads - 1) / p.threads * p.threads;"
# Earlier rounds (PERF.md, the B2 redesign) tried the launch bounds, TC = 8 / 32, 128 / 256 / 512 threads,
# 4 / 8 / 16 split blocks an SM, streaming loads (__ldcs) and two units an iteration on the design's first form.
VARIANTS = {
    "base": [],
    "split-16": [(SPLIT, "constexpr int kSplitBlocksPerSM = 16;")],
    "split-8": [(SPLIT, "constexpr int kSplitBlocksPerSM = 8;")],
    "no-round": [(ROUND, "  p.per_slice = (p.units + slices - 1) / slices;")],
    "threads-256": [(THREADS, "constexpr int kMaxThreads = 256;")],
    "f32-default-bounds": [(F32_BOUNDS, "__launch_bounds__(kMaxThreads) absdiff_kernel(")],
    "half-bounds-2": [(HALF_BOUNDS, "__launch_bounds__(kMaxThreads, 2) absdiff_kernel_16bit(")],
    "two-units": [(SWEEP_ONE, SWEEP_TWO)],
}
SHAPES = [((1, 192, 3 * 1024 * 1024), "float32"), ((1, 1440, 3 * 256 * 256), "float32"),
          ((32, 192, 9216), "float32"), ((32, 192, 9216), "float16"), ((32, 192, 9216), "bfloat16"),
          ((32, 192, 1024), "float32"), ((32, 192, 16), "float32"), ((1, 192, 3 * 1024 * 1024 + 3), "float32"),
          ((4, 48, 3 * 512 * 512), "float32"), ((32, 192, 256), "float32"), ((32, 192, 64), "float32"),
          ((2, 40, 99999), "float32"), ((1, 192, 3 * 1024 * 1024), "bfloat16"), ((1, 1440, 3 * 256 * 256), "float16")]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", nargs="*", help="variants to run besides base")
    args = parser.parse_args()
    import torch

    from ssar_tpu_torch.ops.absdiff import batch_absdiff_plain
    from ssar_tpu_torch.ops.absdiff_cuda import DTYPE_CODES, bind

    if not torch.cuda.is_available():
        sys.exit("explore_torch_absdiff: needs a CUDA card")
    print(card())
    names = ["base"] + [n for n in (args.only or VARIANTS) if n != "base"]
    fns = {}
    for name, (lib, ptxas) in build_variants("absdiff.cu", VARIANTS, names).items():
        fns[name] = bind(lib)
        print(f"[ptxas] {name}: {ptxas_report(ptxas)}")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    scratch = {n: torch.zeros(f[1](sms), dtype=torch.uint8, device=dev) for n, f in fns.items()}
    gen = torch.Generator(device=dev)
    for shape, dtype in SHAPES:
        gen.manual_seed(sum(shape))
        x = torch.randn(shape, generator=gen, device=dev).to(getattr(torch, dtype))
        B, T, E = shape
        want = batch_absdiff_plain(x.float()).to(x.dtype).float()
        tol = 1e-5 if x.dtype == torch.float32 else torch.finfo(x.dtype).eps
        line = [f"sum {device_us(lambda: x.sum()):.2f}"]
        for name in names + ["base"]:
            fn = fns[name][0]
            y = torch.empty(B, T, device=dev, dtype=x.dtype)

            def call():
                assert fn(x.data_ptr(), y.data_ptr(), DTYPE_CODES[x.dtype], B, T, E, sms,
                          scratch[name].data_ptr(), scratch[name].numel(), stream) == 0

            call()
            torch.cuda.synchronize()
            ok = bool(((y.float() - want).abs() <= tol * want.abs()).all()) or not bool(want.isfinite().all())
            line.append(f"{name} {device_us(call):.2f}{'' if ok else ' WRONG'}")
        print(f"{shape} {dtype}: " + ", ".join(line), flush=True)
        del x, want


if __name__ == "__main__":
    main()
