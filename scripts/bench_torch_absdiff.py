"""The absdiff kernel (B2) on a CUDA card: device time and call time at the
evaluation's and the train loss's shapes, in float32 and at the latents'
shape in float16 / bfloat16.

    python3 scripts/bench_torch_absdiff.py [--tree DIR ...]

Device time (torch.profiler over 20 calls: every kernel, copy and cast a
call puts on the card) and call time (median of 25 synchronised calls timed
with CUDA events, the host's share included) of ``batch_absdiff_cuda`` at
(1, 192, 3·1024·1024) (the 8 s clip at 1024 px), (1, 1440, 3·256·256) (60 s
at 256 px), (32, 192, 9216) in float32, float16 and bfloat16 (the latents),
and the train loss's four noise maps (32, 192, 1024 / 256 / 64 / 16), with
the sum of the loss's five float32 launches.  Inputs are drawn on the card
from one seed.  With ``--tree`` it repeats every row in a subprocess for
each other checkout of the package (e.g. an unpacked parent commit), in
turns (this, other, other, this), so two versions are compared on one card
in one run, and prints what ``nvcc -Xptxas -v`` said of each tree's kernels
(registers, spills; each tree's absdiff library is built anew for it).
Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

from bench_torch_median import device_us

ROOT = Path(__file__).resolve().parents[1]
LOSS = ((32, 192, 9216), (32, 192, 1024), (32, 192, 256), (32, 192, 64), (32, 192, 16))
ROWS = [((1, 192, 3 * 1024 * 1024), "float32"), ((1, 1440, 3 * 256 * 256), "float32"),
        ((32, 192, 9216), "float16"), ((32, 192, 9216), "bfloat16")] + [(s, "float32") for s in LOSS]


def call_us(fn, runs: int = 25) -> float:
    """Median of `runs` synchronised calls, µs, from CUDA events (after a warm-up)."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) * 1e3)
    return statistics.median(times)


def whole_calls() -> dict:
    """Device and call µs of this tree's ``batch_absdiff_cuda`` at every row."""
    import torch

    from ssar_tpu_torch.ops import _build, absdiff_cuda

    rows = {}
    gen = torch.Generator(device="cuda")
    for shape, dtype in ROWS:
        gen.manual_seed(sum(shape))
        x = torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, dtype))
        tag = f"{shape} {dtype}"
        rows[f"device {tag}"] = device_us(lambda: absdiff_cuda.batch_absdiff_cuda(x))
        rows[f"call {tag}"] = call_us(lambda: absdiff_cuda.batch_absdiff_cuda(x))
        if hasattr(absdiff_cuda, "plan"):
            rows[f"plan {tag}"] = absdiff_cuda.plan(x)
        del x
    for kind in ("device", "call"):
        rows[f"{kind} the loss's five float32 launches"] = sum(rows[f"{kind} {s} float32"] for s in LOSS)
    ptxas = _build.build_log.get("absdiff", {}).get("ptxas", "")
    rows["ptxas"] = [ln.strip() for ln in ptxas.splitlines() if "registers" in ln or "spill" in ln
                     or "Compiling entry" in ln]
    return rows


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", action="append", default=[], help="another checkout to time beside this one")
    parser.add_argument("--whole-only", action="store_true", help="print this tree's rows as JSON and exit")
    args = parser.parse_args()
    sys.path.insert(0, os.environ.get("SSAR_TREE", str(ROOT)))
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_torch_absdiff: needs a CUDA card")
    if args.whole_only:
        print(json.dumps(whole_calls()))
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print("µs a call: device = torch.profiler over 20 calls; call = median of 25 synchronised calls (CUDA events)")
    trees = [str(ROOT)] + args.tree
    for tree in trees:  # built anew, so that each tree's first run reports what ptxas said
        for lib in (Path(tree) / "build" / "kernels").glob("libabsdiff-*.so"):
            lib.unlink()
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
            elif isinstance(value, dict):
                print(f"[{tree}] {name}: {value}")
            else:
                print(f"[{tree}] {name}: {value:.3f}")


if __name__ == "__main__":
    main()
