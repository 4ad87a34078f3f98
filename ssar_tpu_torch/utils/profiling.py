"""Tracing and timing helpers: a profiler trace, the program's spans, a stage
timer that waits for the card, and a grid autotuner.

Counterpart of ``ssar_tpu/utils/profiling.py``.  ``trace`` writes a
``torch.profiler`` Chrome trace (readable in Perfetto) where the JAX package
writes a ``jax.profiler`` one; ``span`` marks a stage of the program on that
trace (``span:<name>``); ``StageTimer`` synchronises the CUDA device where
the JAX one blocks on a result; ``autotune`` times each configuration with
CUDA events on the card.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from .device import resolve_device


@contextlib.contextmanager
def trace(log_dir: str = "build/torch-trace"):
    """Profile the block (host, and the card when there is one) and write its
    Chrome trace to ``<log_dir>/trace-<time>-<n>.json``; yields `log_dir`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    stem = time.strftime("trace-%Y%m%d-%H%M%S")
    n = len(list(out.glob(f"{stem}-*.json")))
    prof.export_chrome_trace(str(out / f"{stem}-{n}.json"))


@contextlib.contextmanager
def span(name: str, seconds: dict | None = None, key: str | None = None):
    """Mark the block as the program's stage `name`.

    While a torch profiler records, the block is the range ``span:<name>``
    on the profiler's clock, the device's; otherwise it costs a C call.  It
    never synchronises, so its host seconds are those of the enqueue unless
    the block waits itself.  With `seconds`, the block's host seconds are
    added to ``seconds[key]`` (`key` defaults to `name`) when it ends
    without raising, whether or not a profiler records."""
    t0 = time.perf_counter() if seconds is not None else 0.0
    if torch._C._autograd._profiler_enabled():
        with torch.profiler.record_function("span:" + name):
            yield
    else:
        yield
    if seconds is not None:
        k = name if key is None else key
        seconds[k] = seconds.get(k, 0.0) + time.perf_counter() - t0


def _wait(sync) -> None:
    """Wait for the CUDA device (``sync`` None) or for the current stream of
    each CUDA tensor in ``sync`` (a tensor, or a list / tuple / dict of
    them)."""
    if sync is None:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    elif isinstance(sync, dict):
        for v in sync.values():
            _wait(v)
    elif isinstance(sync, (list, tuple)):
        for v in sync:
            _wait(v)
    elif torch.is_tensor(sync) and sync.is_cuda:
        torch.cuda.current_stream(sync.device).synchronize()


@dataclass
class StageTimer:
    """Named stage timing that waits for the card; prints a summary table."""

    records: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time the block from its start to the end of its device work: the
        CUDA device is synchronised before and after it, or, with `sync`,
        the streams of what `sync` names after it."""
        if sync is None:
            _wait(None)
        t0 = time.perf_counter()
        yield
        _wait(sync)
        self.records.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> str:
        lines = ["stage".ljust(30) + "mean ms".rjust(10) + "calls".rjust(8)]
        for name, ts in self.records.items():
            lines.append(name.ljust(30) + f"{1e3 * sum(ts) / len(ts):10.2f}" + f"{len(ts):8d}")
        return "\n".join(lines)


def autotune(make_fn, configs: list[dict], args, iters: int = 10, warmup: int = 2,
             device: str | torch.device | None = None):
    """Time ``make_fn(**cfg)(*args)`` for each configuration; returns
    (best_config, results).  On the card (the default) each configuration is
    timed with CUDA events over `iters` calls after `warmup` ones; with
    ``device="cpu"`` by the host clock.  A configuration that raises is
    recorded with ``time = inf`` and its ``error`` and the sweep goes on."""
    device = resolve_device(device)
    results = []
    for cfg in configs:
        try:
            fn = make_fn(**cfg)
            for _ in range(1 + warmup):
                fn(*args)
            if device.type == "cuda":
                with torch.cuda.device(device):
                    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    e0.record()
                    for _ in range(iters):
                        fn(*args)
                    e1.record()
                    e1.synchronize()
                    seconds = e0.elapsed_time(e1) / 1e3 / iters
            else:
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn(*args)
                seconds = (time.perf_counter() - t0) / iters
            results.append({**cfg, "time": seconds})
        except Exception as e:  # a configuration that does not run is a result of the sweep
            results.append({**cfg, "time": float("inf"), "error": str(e)[:100]})
    best = min(results, key=lambda r: r["time"])
    return {k: v for k, v in best.items() if k not in ("time", "error")}, results
