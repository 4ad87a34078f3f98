"""Benchmark of the PyTorch / CUDA port on one H100: one run of one cell.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights from the seed, the set-up track through the entry: every
shape the window uses), then the measured window: one client renders the
mix's tracks back to back for `--seconds`; then the check of what the
window produced against the plain reference.  The last line of standard
output is the result (JSON).  With ``--trace 1`` the window runs under
torch.profiler and the line carries the cell's per-layer metrics.  Needs a
CUDA card: without one it exits non-zero and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache the program or torch builds lives inside the checkout, at a fixed path
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"
# one process with few threads: the host's share of a run (segmentation, the eager noise trees) steadier
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "2"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def count_median_launches(counts: list):
    """Record each forward launch's element count of kernel B1 into `counts`
    while the window runs (``ssar_tpu_torch.ops.median`` launches it)."""
    from ssar_tpu_torch.ops import median

    launch = median.sliding_median_cuda

    def counted(x, k, axis):
        counts.append(x.numel())
        return launch(x, k, axis)

    median.sliding_median_cuda = counted
    return lambda: setattr(median, "sliding_median_cuda", launch)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             bench: dict | None = None, config: dict | None = None, mix: dict | None = None,
             limits: dict | None = None, t_start: float = T_START) -> dict:
    """One run of `workload`; returns the result line's object.  `config`,
    `mix` and `limits` replace the files the cell names (the CPU tests run
    small sizes through the same code)."""
    import torch

    from port_bench import harness as H
    from port_bench.compare import judge, worst
    from port_bench.peaks import H100_SXM
    from port_bench.trace import read_profile
    from port_bench.traffic import Tracks, load_mix

    bench = bench or H.load_json(ROOT / "BENCHMARK.json")
    cell, config_entry, config_file = H.find_cell(workload, bench)
    config = config or config_file
    mix = mix or load_mix(cell["traffic"])
    limits = limits or H.load_json(H.HERE / "limits" / f"{workload}.json")["limits"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    counts: list = []
    restore_counter = count_median_launches(counts)
    tracks = Tracks(mix, seed)
    spans = H.Spans(trace, sync)
    system = importlib.import_module(f"port_bench.systems.{config['system']}").System(
        config, mix, seed, dev, spans, tracks)
    sync()
    setup_s = time.perf_counter() - t_start
    try:
        from ssar_tpu_torch.ops import _build

        for name, info in _build.build_log.items():
            H.log(f"cold set-up: built kernel library {name} in {info['seconds']:.3f} s (nvcc)")
    except ImportError:
        pass
    H.log(f"set-up {setup_s:.3f} s; window {seconds} s on {torch.cuda.get_device_name(dev) if cuda else 'cpu'}")

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    counts.clear()
    spans.records.clear()
    served, failed = [], 0
    prof = None
    if trace:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    with torch.profiler.record_function("span:window") if trace else contextlib.nullcontext():
        while time.perf_counter() < deadline:
            track = tracks.next()
            try:
                sink, captured, stages = system.serve(track, deadline)
            except Exception:   # a request that fails is counted, and the run is not correct
                H.log(f"track {track.index} (seed {track.seed}) failed:\n{traceback.format_exc()}")
                failed += 1
                continue
            served.append((track, sink, captured, stages))
        sync()
    t_end = time.perf_counter()
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    median_numel = list(counts)
    restore_counter()

    run = H.Run(seconds=seconds, loop_s=t_end - t0, frames=sum(s.in_window for _, s, _, _ in served),
                tracks=len(served) + failed, flops_per_frame=system.flops_per_frame, peaks=H100_SXM,
                counters={"sliding_median_numel": median_numel})
    for _, _, _, stages in served:
        for k, v in stages.items():
            run.stage_s[k] = run.stage_s.get(k, 0.0) + v
    H.log(f"window: {run.tracks} tracks, {run.frames} frames in {seconds} s, loop {run.loop_s:.3f} s, "
          f"stages {json.dumps({k: round(v, 4) for k, v in run.stage_s.items()})}")

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu", "count": 1,
                   "memory_peak_bytes": int(peak)}
    metrics, breakdown = {}, None
    if trace:
        run.trace = read_profile(prof, seconds)
        del prof
        device_info["busy_s"] = run.trace.busy_s()
        device_info["window_s"] = run.trace.end - run.trace.start
        breakdown = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.idle_gaps()}
        for m in bench["per_layer"]:
            if workload in m.get("workloads", [workload]):
                value = H.metric_reader(m["name"])(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"frames_per_s": run.frames / seconds, "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
        for m in bench["end_to_end"]:   # a quantity split by cell (frames_per_s.patch) reads as its first part
            if workload in m.get("workloads", [workload]) and m["name"].split(".")[0] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"].split(".")[0]], "unit": m["unit"]}

    # the check: after the window, with the port's state freed
    system.release()
    t_check = time.perf_counter()
    per_track = []
    for track, sink, captured, _ in served:
        try:
            want = system.reference(track, sorted(sink.kept))
            numbers = system.numbers(system.served(sink, captured), want)
        except Exception:
            H.log(f"check of track {track.index} (seed {track.seed}) failed:\n{traceback.format_exc()}")
            failed += 1
            continue
        H.log(f"track {track.index} (seed {track.seed}): {sink.n} frames, checked {sorted(sink.kept)}: "
              + ", ".join(f"{k} {v:.6g}" for k, v in numbers.items()))
        per_track.append(numbers)
    H.log(f"check of {len(served)} tracks took {time.perf_counter() - t_check:.3f} s")
    ok, checks = judge(worst(per_track), limits)
    result = {"correct": bool(ok and failed == 0 and per_track), "attempted": run.tracks, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from port_bench import harness as H

    import torch

    bench = H.load_json(ROOT / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    need = cell["chips"] if cell else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        H.log(f"needs {need} CUDA device(s); torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}")
        return 2
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
        H.log(f"card: {smi}")
    except (OSError, subprocess.SubprocessError) as e:
        H.log(f"nvidia-smi unreadable: {e}")

    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), bench=bench)
    bad = H.forbidden_modules()
    if bad:
        H.log(f"the run loaded {bad}: the port's benchmark may load neither JAX nor the JAX package")
        return 3
    for c in result["checks"].values():   # a gap that could not be computed reads as a string
        if c["value"] is not None and not math.isfinite(c["value"]):
            c["value"] = str(c["value"])
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
