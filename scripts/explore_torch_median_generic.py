"""Variants of the generic (odd k > 31) sliding-median forward side by side on one CUDA card.

    python3 scripts/explore_torch_median_generic.py

Each variant is ``csrc/sliding_median.cu`` with a text substitution (the
generic tile's lines, the launch bounds), compiled with nvcc in parallel into
``build/sliding_median_variants/`` and bound with ctypes
(``scripts/cuda_variants.py``).  At (1025, 193) and (1025, 4321), both axes,
it times (torch.profiler over up to 20 calls, µs a call) every variant on
the same input at k = 33, 63, 127 and 255, the base first and again last,
beside the templated k = 31 kernel of the same library; it checks each
variant against ``median_filter_plain`` (torch.equal) and prints each
variant's registers and spills from ``-Xptxas -v``.  Prints the card's name
and power limit first.
"""
from __future__ import annotations

import ctypes
import sys

from bench_torch_median import device_us
from cuda_variants import build_variants, card, ptxas_report

LINES = "constexpr int kGenericLinesLog2 = 3;"
BOUNDS = "__launch_bounds__(kThreads, 4)\nsliding_median_generic_kernel("
VARIANTS = {
    "base": [],
    "lines-2": [(LINES, "constexpr int kGenericLinesLog2 = 1;")],
    "lines-4": [(LINES, "constexpr int kGenericLinesLog2 = 2;")],
    "lines-16": [(LINES, "constexpr int kGenericLinesLog2 = 4;")],
    # without the base's bound of 64 registers a thread (4 blocks of 256 threads an SM)
    "no-bounds": [(BOUNDS, "__launch_bounds__(kThreads)\nsliding_median_generic_kernel(")],
}
SHAPES = [(1025, 193), (1025, 4321)]
WIDTHS = [31, 33, 63, 127, 255]


def main():
    import torch

    from ssar_tpu_torch.ops.median import median_filter_plain
    from ssar_tpu_torch.ops.median_cuda import line_layout

    if not torch.cuda.is_available():
        sys.exit("explore_torch_median_generic: needs a CUDA card")
    print(card())
    names = list(VARIANTS)
    fns = {}
    for name, (lib, ptxas) in build_variants("sliding_median.cu", VARIANTS, names).items():
        fn = lib.ssar_sliding_median_f32
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int] \
            + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
        print(f"[ptxas] {name}: generic kernels {ptxas_report(ptxas, 'generic')}")
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev)
    for shape in SHAPES:
        gen.manual_seed(sum(shape))
        x = torch.rand(shape, generator=gen, device=dev)
        y = torch.empty_like(x)
        for k in WIDTHS:
            for axis in (1, 0):
                layout = line_layout(x.shape, axis)
                want = median_filter_plain(x, k, axis) if shape == SHAPES[0] else None
                line = []
                for name in (names + ["base"]) if k > 31 else ["base"]:
                    fn = fns[name]

                    def call():
                        assert fn(x.data_ptr(), y.data_ptr(), k, *layout, stream) == 0

                    call()
                    torch.cuda.synchronize()
                    ok = want is None or torch.equal(y, want)
                    line.append(f"{name} {device_us(call):.2f}{'' if ok else ' WRONG'}")
                print(f"{shape} k={k} axis={axis}: " + ", ".join(line), flush=True)


if __name__ == "__main__":
    main()
