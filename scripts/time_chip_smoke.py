"""Wall time of ``chip_smoke.py`` in several checkouts, one after another, on one card.

    python3 scripts/time_chip_smoke.py TREE [TREE ...]

Runs ``python3 chip_smoke.py`` from the root of each checkout in the order
given (e.g. a parent commit unpacked with ``git archive`` and this tree
unpacked the same way), writes each run's output to
``chiprun_out/time_chip_smoke_<n>.txt``, and prints the card's name and
power limit, then each run's exit code, seconds and last line.  Compare two
versions only within one call: the script's host-bound phases move by tens
of seconds between machines.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 1250.0   # a run's limit: above the 1200 s that chip_smoke.py must finish in


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+", help="checkouts whose chip_smoke.py to run, in order")
    args = parser.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    for n, tree in enumerate(args.trees):
        log = out_dir / f"time_chip_smoke_{n}.txt"
        t0 = time.perf_counter()
        with open(log, "w") as f:
            try:
                rc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree, stdout=f, stderr=subprocess.STDOUT,
                                    timeout=TIMEOUT_S).returncode
            except subprocess.TimeoutExpired:
                rc = "timeout"
        seconds = time.perf_counter() - t0
        lines = log.read_text().strip().splitlines()
        print(f"[{tree}] rc {rc}, {seconds:.1f} s; last line: {lines[-1] if lines else ''}", flush=True)


if __name__ == "__main__":
    main()
