"""Reading torch.profiler's trace of the window: device activity, the
benchmark's spans, and what the host was in while the device idled."""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

NOT_WORK = ("span:", "ProfilerStep")   # ranges the profiler mirrors on the device's timeline


def _ns(e, what: str) -> int:
    if hasattr(e, f"{what}_ns"):
        return int(getattr(e, f"{what}_ns")())
    return int(getattr(e, f"{what}_us")()) * 1000


@dataclass
class Trace:
    start: float                   # the window's start, seconds on the trace's clock
    end: float                     # the end of the window's last track
    deadline: float                # start + the run's seconds
    device: list = field(default_factory=list)     # (name, start, end) of each device operation, by start
    spans: list = field(default_factory=list)      # (name, start, end) of the benchmark's spans

    def merged(self, lo: float, hi: float) -> list[tuple[float, float]]:
        """The union of device activity within [lo, hi] as disjoint intervals."""
        out: list[list[float]] = []
        for _, s, e in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self, lo: float | None = None, hi: float | None = None) -> float:
        lo = self.start if lo is None else lo
        hi = self.end if hi is None else hi
        return sum(e - s for s, e in self.merged(lo, hi))

    def kernels(self, lo: float | None = None, hi: float | None = None) -> list[tuple[str, float, float]]:
        """Kernel launches (not copies or fills) that started within [lo, hi]."""
        lo = self.start if lo is None else lo
        hi = self.end if hi is None else hi
        return [d for d in self.device if lo <= d[1] <= hi and not d[0].startswith(("Memcpy", "Memset"))]

    def top_ops(self, n: int = 10) -> list[list]:
        """The `n` device operations that took most time, by name (cut to 160 characters)."""
        total: dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            total[name[:160]] += e - s
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def host_label(self, t: float) -> str:
        inner = [(e - s, name) for name, s, e in self.spans if s <= t <= e and name != "window"]
        return min(inner)[1] if inner else "outside the entry's spans"

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The `n` longest stretches of the window with no device activity,
        each named by the innermost span the host was in at its middle."""
        gaps, prev = [], self.start
        for s, e in self.merged(self.start, self.end) + [(self.end, self.end)]:
            if s > prev:
                gaps.append((s - prev, prev, s))
            prev = max(prev, e)
        gaps.sort(reverse=True)
        return [[self.host_label((a + b) / 2), g] for g, a, b in gaps[:n]]


def read_profile(prof, seconds: float) -> Trace:
    """The trace of a ``torch.profiler.profile`` whose window is the range
    ``span:window``; times in seconds on the profiler's clock."""
    from torch.autograd import DeviceType

    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = _ns(e, "start") * 1e-9
        t = s + _ns(e, "duration") * 1e-9
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith(NOT_WORK):
                device.append((name, s, t))
        elif name.startswith("span:"):
            spans.append((name[len("span:"):], s, t))
    window = [sp for sp in spans if sp[0] == "window"]
    if not window:
        raise RuntimeError("the trace holds no span:window range")
    _, start, end = window[0]
    device.sort(key=lambda d: d[1])
    return Trace(start, end, start + seconds, device, spans)
