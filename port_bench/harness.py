"""The run: set-up, the measured window, the traced window's reading, the
check of the outputs against the plain reference, and the result line.

A cell is a configuration (``configs/<name>.json``, whose ``system`` names a
module of ``systems/``) under a traffic mix (``traffic/<mix>.json``); its
per-layer metrics are readers in ``layer_metrics/<metric>.py`` and its
comparison limits ``limits/<cell>.json``.  All are found by the names in
``BENCHMARK.json``.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ssar_tpu")


class WindowClosed(Exception):
    """Raised by the sink at the first frame past the window (or past a warm-up's frame budget)."""


def log(msg: str) -> None:
    print(f"[port_bench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Spans:
    """Named host-clock spans; in a traced run each is also a profiler range
    (``span:<name>``), so the trace's reader sees them on the device's clock."""

    def __init__(self, traced: bool, sync):
        self.traced, self.sync = traced, sync
        self.records: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.traced:
            yield
            return
        import torch

        self.sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"span:{name}"):
            try:
                yield
            finally:   # a stage cut by the window's close is a span too
                self.sync()
                self.records.append((name, t0, time.perf_counter()))


class Sink:
    """The host's frame writer: takes I420 frames, stamps each, keeps copies of
    the frames the check compares, and raises ``WindowClosed`` at the first
    frame after `deadline` or after `budget` frames."""

    def __init__(self, shape, deadline: float = math.inf, budget: int | None = None, keep=(), on_enter=None,
                 on_exit=None):
        self.shape, self.deadline, self.budget = tuple(shape), deadline, budget
        self.keep, self.kept = set(keep), {}
        self.n = self.in_window = 0
        self.t_enter = self.t_exit = None
        self._on_enter, self._on_exit = on_enter, on_exit

    def __enter__(self):
        self.t_enter = time.perf_counter()
        if self._on_enter:
            self._on_enter()
        return self

    def __exit__(self, *exc):
        self.t_exit = time.perf_counter()
        if self._on_exit:
            self._on_exit()
        return False

    def write_i420(self, frame):
        if frame.shape != self.shape or frame.dtype != np.uint8:
            raise ValueError(f"frame {frame.shape} {frame.dtype}, expected {self.shape} uint8")
        if time.perf_counter() > self.deadline or (self.budget is not None and self.n >= self.budget):
            raise WindowClosed
        if self.n in self.keep:
            self.kept[self.n] = frame.copy()
        self.n += 1
        self.in_window += 1

    def write(self, frame):
        raise ValueError(f"expected I420 frames of shape {self.shape}, got an RGB frame {frame.shape}")


@dataclass
class Run:
    """What a run measured, for the per-layer readers."""
    seconds: float                    # the window's length
    loop_s: float = 0.0               # window start to the end of the last track (past the window by its abort)
    frames: int = 0                   # frames delivered within the window
    tracks: int = 0
    stage_s: dict = field(default_factory=dict)        # stage -> seconds summed over the window's tracks
    flops_per_frame: float = 0.0
    peaks: dict = field(default_factory=dict)
    trace: "Trace | None" = None
    counters: dict = field(default_factory=dict)        # e.g. "sliding_median_numel": [numel a launch]


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def find_cell(name: str, bench: dict) -> tuple[dict, dict, dict]:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return cell, config, load_json(ROOT / config["file"])


def metric_reader(name: str):
    """The reader of a per-layer metric: ``layer_metrics/<quantity>.py``, the
    quantity being the name up to its first dot (``render_share.patch`` is
    ``render_share`` read in the cells whose end-to-end metric it moves)."""
    return importlib.import_module(f"port_bench.layer_metrics.{name.split('.')[0]}").read
