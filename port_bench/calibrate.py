"""Readings the check's limits are set from, in one process per cell.

    python3 port_bench/calibrate.py --workload <name> --seeds 1,2,3 [--control-seeds 1,2,3]

For each seed: the cell's system built from that seed as a run builds it,
one whole track of the mix served through the port's entry (the cell's
sizes and batch), its outputs held against the plain reference: the
program's reading of each compared number.  For each control seed the
control (the reference one precision step down; ``reference/precision.py``)
takes the program's place on that track: the control's reading.  Prints a
line per seed and a summary JSON as its last line; the limits in
``limits/<cell>.json`` are set between the two readings.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import port_bench.run  # noqa: E402,F401  (the cache directories, before torch is imported)


def readings(workload: str, seeds: list[int], control_seeds: list[int], device: str = "cuda",
             config: dict | None = None, mix: dict | None = None) -> dict:
    import torch

    from port_bench import harness as H
    from port_bench.traffic import Tracks, load_mix

    bench = H.load_json(ROOT / "BENCHMARK.json")
    cell, _, config_file = H.find_cell(workload, bench)
    config = config or config_file
    mix = mix or load_mix(cell["traffic"])
    module = importlib.import_module(f"port_bench.systems.{config['system']}")
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    out = {"program": {}, "control": {}}
    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        tracks = Tracks(mix, seed, prepared=1)
        system = module.System(config, mix, seed, torch.device(device), H.Spans(False, sync), tracks)
        track = tracks.next()
        sink, captured, _ = system.serve(track)
        sync()
        system.release()
        frames = sorted(sink.kept)
        want = system.reference(track, frames)
        if seed in seeds:
            out["program"][seed] = system.numbers(system.served(sink, captured), want)
            H.log(f"seed {seed} program: {json.dumps(out['program'][seed])}")
        if seed in control_seeds:
            out["control"][seed] = system.numbers(system.reference(track, frames, control=True), want)
            H.log(f"seed {seed} control: {json.dumps(out['control'][seed])}")
        H.log(f"seed {seed}: {time.perf_counter() - t0:.1f} s")
        del system
    for side in ("program", "control"):
        per = list(out[side].values())
        if per:
            out[side + "_max"] = {k: max(p[k] for p in per) for k in per[0]}
            out[side + "_min"] = {k: min(p[k] for p in per) for k in per[0]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]   # noqa: E731
    print(json.dumps(readings(args.workload, ints(args.seeds), ints(args.control_seeds))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
