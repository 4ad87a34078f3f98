"""Throughput of fp32 min/max, compare-select and the special-function unit
(SFU) on a CUDA card, beside fmaf.

    python3 scripts/bench_torch_minmax_rate.py

The sliding-median kernels are selection networks: the forward is fminf /
fmaxf, the backward compares and selects.  Their operations bound depends on
how many of those an SM executes a clock, which the data sheet's FLOP/s (an FMA
counted twice) does not say.  The S4D Vandermonde kernels are bound by the
SFU (three transcendentals a term): the script also times __sinf, __expf and
one whole Vandermonde term (reported as terms).  This builds ``scripts/torch_minmax_rate.cu``
with nvcc into ``build/``, runs each variant on a full grid and prints
operations a second and per clock per SM at the card's maximum SM clock
(``nvidia-smi``), with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    if not torch.cuda.is_available():
        sys.exit("bench_torch_minmax_rate: needs a CUDA card")
    from ssar_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    clock_hz = float(smi.split(",")[2].split()[0]) * 1e6
    out = ROOT / "build" / "kernels" / "libtorch_minmax_rate.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(Path(__file__).parent / "torch_minmax_rate.cu")], check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).ssar_rate_test
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * 8
    buf = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for op, name, per_round in ((0, "fmaf", 8), (1, "fminf + fmaxf", 16), (2, "compare + select + add", 24),
                                (3, "__sinf (MUFU.SIN)", 8), (4, "__expf (MUFU.EX2)", 8),
                                (5, "Vandermonde forward term (3 MUFU)", 8)):
        iters = 20000 if op < 3 else 2000  # the SFU's rounds are 8-30x slower
        if fn(op, buf.data_ptr(), blocks, iters, stream) != 0:
            sys.exit(f"launch of {name} failed")
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(5):
            fn(op, buf.data_ptr(), blocks, iters, stream)
        e1.record()
        e1.synchronize()
        seconds = e0.elapsed_time(e1) / 5 / 1e3
        ops = blocks * 256 * iters * per_round
        print(f"{name}: {ops / seconds / 1e12:.2f} T operations/s = {ops / seconds / sms / clock_hz:.1f} a clock an SM "
              f"at {clock_hz / 1e9:.2f} GHz ({sms} SMs)")


if __name__ == "__main__":
    main()
