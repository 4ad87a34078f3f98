"""The S4D Vandermonde kernels (B3) on a CUDA card: device time forward and
backward at the train path's and a 3-minute track's shapes, and the host's
time of one call at the train path's shape, piece by piece.

    python3 scripts/bench_torch_vandermonde.py [--tree DIR ...]

Device time (torch.profiler over 20 launches, the kernels' own time) of
``s4d_vandermonde_cuda`` and ``s4d_vandermonde_bwd_cuda`` at (H, N, L) =
(104, 32, 192) (the train path: hidden 32, fixed decoder), (56, 32, 192),
(104, 32, 4320) (a 3-minute track) and (104, 64, 4320) (an S4DLayer(104, 128)
on it), on the inputs of freshly initialised S4D layers.  At the train
path's shape the kernels take a few microseconds and the call is the host's:
the script also times 1,000 calls of the two ctypes wrappers, of
``s4d_vandermonde`` forward alone and forward + ``autograd.grad``, and of each
piece a wrapper may run per call, with ``time.perf_counter`` and without
synchronising inside the loop (the queue is drained before and after).  With
``--tree`` it repeats the device and whole-call rows in a subprocess for each
other checkout of the package (e.g. an unpacked parent commit), in turns
(this, other, other, this), so two versions are compared on one card in one
run, and prints what ``nvcc -Xptxas -v`` said of each tree's kernels.  Prints
the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

from bench_torch_median import device_us, per_call_us

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((104, 32, 192), (56, 32, 192), (104, 32, 4320), (104, 64, 4320))


def s4d_inputs(H: int, N: int, L: int):
    """The four (H, N) inputs of a freshly initialised S4D layer and a (H, L) cotangent."""
    import torch

    from ssar_tpu_torch.models.s4 import S4DLayer
    from ssar_tpu_torch.ops.vandermonde import zoh_factors

    torch.manual_seed(H + N)
    layer = S4DLayer(H, 2 * N).cuda()
    with torch.no_grad():
        args = [t.contiguous() for t in zoh_factors(layer.log_dt, layer._A_re(), layer.A_im, layer.C_re, layer.C_im)]
    return args, torch.randn(H, L, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")


def whole_calls() -> dict:
    """Device µs of the kernels, then host µs of the calls a user of the package makes."""
    import torch

    from ssar_tpu_torch.ops import _build, vandermonde_cuda
    from ssar_tpu_torch.ops.vandermonde import s4d_vandermonde

    rows = {}
    for H, N, L in SHAPES:
        args, g = s4d_inputs(H, N, L)
        rows[f"device forward {(H, N, L)}"] = device_us(lambda: vandermonde_cuda.s4d_vandermonde_cuda(*args, L))
        rows[f"device backward {(H, N, L)}"] = device_us(lambda: vandermonde_cuda.s4d_vandermonde_bwd_cuda(*args, g))
    H, N, L = SHAPES[0]
    args, g = s4d_inputs(H, N, L)
    leaves = [t.clone().requires_grad_() for t in args]
    tag = str((H, N, L))
    rows[f"s4d_vandermonde_cuda {tag}"] = per_call_us(lambda: vandermonde_cuda.s4d_vandermonde_cuda(*args, L))
    rows[f"s4d_vandermonde_bwd_cuda {tag}"] = per_call_us(lambda: vandermonde_cuda.s4d_vandermonde_bwd_cuda(*args, g))
    rows[f"s4d_vandermonde {tag}"] = per_call_us(lambda: s4d_vandermonde(*args, L))
    rows[f"s4d_vandermonde + autograd.grad {tag}"] = per_call_us(
        lambda: torch.autograd.grad(s4d_vandermonde(*leaves, L), leaves, g))
    ptxas = _build.build_log.get("s4d_vandermonde", {}).get("ptxas", "")
    rows["ptxas"] = [ln.strip() for ln in ptxas.splitlines() if "registers" in ln or "spill" in ln
                     or "Compiling entry" in ln]
    return rows


def pieces() -> dict:
    """What a wrapper may do per call, each on its own, in µs."""
    import torch

    from ssar_tpu_torch.ops import _build, vandermonde_cuda

    H, N, L = SHAPES[0]
    args, g = s4d_inputs(H, N, L)
    vandermonde_cuda.s4d_vandermonde_cuda(*args, L)  # builds and binds
    vandermonde_cuda.s4d_vandermonde_bwd_cuda(*args, g)
    lib = _build.load("s4d_vandermonde")
    fwd, bwd = lib.ssar_s4d_vandermonde_fwd_f32, lib.ssar_s4d_vandermonde_bwd_f32
    out = torch.empty(H, L, device="cuda")
    grads = torch.empty(4, H, N, device="cuda")
    ptrs = [t.data_ptr() for t in args]
    gptrs = [t.data_ptr() for t in grads]
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    stream = torch.cuda.current_stream().cuda_stream
    dev = args[0].device

    def guard():
        with torch.cuda.device(dev):
            pass

    rows = {
        "empty loop": lambda: None,
        "checks of four (H, N) tensors": lambda: vandermonde_cuda._check(args, "t"),
        "four .is_contiguous()": lambda: [t.is_contiguous() for t in args],
        "four .contiguous() on contiguous tensors": lambda: [t.contiguous() for t in args],
        "torch.empty (H, L)": lambda: torch.empty(H, L, device=dev, dtype=torch.float32),
        "torch.empty_like x 4": lambda: [torch.empty_like(args[0]) for _ in range(4)],
        "torch.empty (4, H, N) + iterate into views":
            lambda: tuple(torch.empty(4, H, N, device=dev, dtype=torch.float32)),
        "torch.empty (4, H, N) + .unbind()": lambda: torch.empty(4, H, N, device=dev, dtype=torch.float32).unbind(),
        "_build.load (dictionary walk) + attribute + argtypes test":
            lambda: _build.load("s4d_vandermonde").ssar_s4d_vandermonde_fwd_f32.argtypes is None,
        "torch.cuda.current_stream().cuda_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "torch.cuda.current_device()": lambda: torch.cuda.current_device(),
        "with torch.cuda.device(dev)": guard,
        "data_ptr() x 5": lambda: [t.data_ptr() for t in (*args, out)],
        "the forward ctypes call (launch included)": lambda: fwd(*ptrs, out.data_ptr(), H, N, L, stream),
        "the backward ctypes call (launch included)": lambda: bwd(*ptrs, g.data_ptr(), *gptrs, H, N, L, stream),
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
        sys.exit("bench_torch_vandermonde: needs a CUDA card")
    if args.whole_only:
        print(json.dumps(whole_calls()))
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print("device rows: µs a launch (torch.profiler); the others: host µs a call, 1000 calls, no "
          "synchronisation inside the loop")
    trees = [str(ROOT)] + args.tree
    for tree in trees + trees[::-1]:  # in turns: this, other, other, this
        with contextlib.suppress(KeyError):
            os.environ.pop("PYTHONPATH")
        proc = subprocess.run([sys.executable, __file__, "--whole-only"], env=dict(os.environ, SSAR_TREE=tree),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"{tree}: {proc.stderr[-2000:]}")
        for name, value in json.loads(proc.stdout.strip().splitlines()[-1]).items():
            if name == "ptxas":
                for line in value:
                    print(f"[{tree}] ptxas: {line}")
            else:
                print(f"[{tree}] {name}: {value:.3f}")
    for name, us in pieces().items():
        print(f"[piece] {name}: {us:.2f}")


if __name__ == "__main__":
    main()
