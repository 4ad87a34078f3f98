"""The sliding-median kernels on a CUDA card: device time at HPSS shapes, and
the host's time of one call at the optimizer's shapes, piece by piece.

    python3 scripts/bench_torch_median.py [--tree DIR ...]

Device time (torch.profiler over 20 launches, the kernels' own time; 3 to 20
where a launch takes more than 10 ms) of the forward and the backward at
(1025, 4320) and (1025, 193), k = 31, along both axes, at (164, 82) k = 7 and
(82, 82) k = 9, and of the generic kernels (odd k > 31) at k = 33, 63, 127
and 255 at (1025, 193) and (1025, 4321), both axes.  At those last two shapes,
the test-time optimizer's, the kernels take a few microseconds and the call is
the host's: the script also times 1,000 calls of ``median_filter`` (forward
alone, and forward + backward through autograd), of the two ctypes wrappers,
and of each piece a wrapper may run per call, with ``time.perf_counter`` and
without synchronising inside the loop (the queue is drained before and after).
With ``--tree`` it repeats the device and whole-call rows in a subprocess for
each other checkout of the package (e.g. an unpacked parent commit), in turns
(this, other, other, this), so two versions are compared on one card in one
run.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_CALLS = 1000


def per_call_us(fn, n: int = N_CALLS) -> float:
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def device_us(fn, calls: int = 20) -> float:
    """Device time of one call from torch.profiler, in µs; fewer calls (at
    least 3) where one takes more than 10 ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    calls = max(3, min(calls, int(0.2 / max(time.perf_counter() - t0, 1e-9))))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation) / calls


def whole_calls() -> dict:
    """Device µs of the kernels, then host µs of the calls a user of the package makes."""
    import torch

    from ssar_tpu_torch.ops import median_cuda
    from ssar_tpu_torch.ops.median import median_filter

    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [((1025, 4320), 31), ((1025, 193), 31), ((164, 82), 7), ((82, 82), 9)]
    shapes += [((1025, T), k) for T in (193, 4321) for k in (33, 63, 127, 255)]  # the generic kernels
    for shape, k in shapes:
        x = torch.rand(shape, generator=gen, device="cuda")
        cot = torch.rand(shape, generator=gen, device="cuda")
        for axis in (1, 0):
            out = median_cuda.sliding_median_cuda(x, k, axis)
            tag = f"{shape} k={k} axis={axis}"
            rows[f"device forward {tag}"] = device_us(lambda: median_cuda.sliding_median_cuda(x, k, axis))
            rows[f"device backward {tag}"] = device_us(
                lambda: median_cuda.sliding_median_bwd_cuda(x, out, cot, k, axis))
    for shape, k in (((164, 82), 7), ((82, 82), 9)):
        x = torch.rand(shape, device="cuda")
        leaf = x.clone().requires_grad_()
        cot = torch.rand(shape, device="cuda")
        out = median_filter(x, k, 1)
        tag = f"{shape} k={k}"
        rows[f"median_filter {tag}"] = per_call_us(lambda: median_filter(x, k, 1))
        rows[f"median_filter + autograd.grad {tag}"] = per_call_us(
            lambda: torch.autograd.grad(median_filter(leaf, k, 1), leaf, cot))
        rows[f"sliding_median_cuda {tag}"] = per_call_us(lambda: median_cuda.sliding_median_cuda(x, k, 1))
        rows[f"sliding_median_bwd_cuda {tag}"] = per_call_us(
            lambda: median_cuda.sliding_median_bwd_cuda(x, out, cot, k, 1))
    return rows


def pieces() -> dict:
    """What a wrapper may do per call, each on its own, in µs."""
    import torch

    from ssar_tpu_torch.ops import _build, median_cuda

    x = torch.rand(164, 82, device="cuda")
    y = torch.empty_like(x)
    median_cuda.sliding_median_cuda(x, 7, 1)  # builds and binds
    fn = _build.load("sliding_median").ssar_sliding_median_f32
    layout = median_cuda.line_layout(x.shape, 1)
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    stream = torch.cuda.current_stream().cuda_stream

    def guard():
        with torch.cuda.device(x.device):
            pass

    rows = {
        "empty loop": lambda: None,
        "checks (device, dtype, k, shape, axis)": lambda: median_cuda._check(x, 7, 1, "t"),
        "line_layout": lambda: median_cuda.line_layout(x.shape, 1),
        "x.is_contiguous()": lambda: x.is_contiguous(),
        "x.contiguous() on a contiguous tensor": lambda: x.contiguous(),
        "torch.empty_like": lambda: torch.empty_like(x),
        "_build.load (dictionary walk) + attribute + argtypes test":
            lambda: _build.load("sliding_median").ssar_sliding_median_f32.argtypes is None,
        "torch.cuda.current_stream().cuda_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "torch.cuda.current_device()": lambda: torch.cuda.current_device(),
        "with torch.cuda.device(x.device)": guard,
        "x.data_ptr() x 2": lambda: (x.data_ptr(), y.data_ptr()),
        "the ctypes call (launch included)": lambda: fn(x.data_ptr(), y.data_ptr(), 7, *layout, stream),
    }
    if raw is not None:
        rows["torch._C._cuda_getCurrentRawStream"] = lambda: raw(0)
    return {name: per_call_us(f) for name, f in rows.items()}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", action="append", default=[], help="another checkout to time the whole calls of")
    parser.add_argument("--whole-only", action="store_true", help="print the whole-call rows as JSON and exit")
    args = parser.parse_args()
    sys.path.insert(0, os.environ.get("SSAR_TREE", str(ROOT)))
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_torch_median: needs a CUDA card")
    if args.whole_only:
        print(json.dumps(whole_calls()))
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"device rows: µs a launch (torch.profiler); the others: host µs a call, {N_CALLS} calls, no "
          "synchronisation inside the loop")
    trees = [str(ROOT)] + args.tree
    for tree in trees + trees[::-1]:  # in turns: this, other, other, this
        with contextlib.suppress(KeyError):
            os.environ.pop("PYTHONPATH")
        proc = subprocess.run([sys.executable, __file__, "--whole-only"], env=dict(os.environ, SSAR_TREE=tree),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"{tree}: {proc.stderr[-2000:]}")
        for name, us in json.loads(proc.stdout.strip().splitlines()[-1]).items():
            print(f"[{tree}] {name}: {us:.2f}")
    for name, us in pieces().items():
        print(f"[piece] {name}: {us:.2f}")


if __name__ == "__main__":
    main()
