"""The readers of the program's own spans (``render.loop``, ``render.wait``,
``render.noise``; ``ssar_tpu_torch.utils.profiling.span``): on traces written
out by hand, and on small traced runs of both cells on the CPU."""
import importlib
import random

import pytest

import port_bench.run as run
from port_bench.harness import Run
from port_bench.trace import Trace

from .conftest import LONGFORM, PATCH, bench, small

NEW = ("render_wait_share", "render_idle_share", "noise_share")


def read(name, run_):
    return importlib.import_module(f"port_bench.layer_metrics.{name}").read(run_)


def traced(spans, device=(("k1", 0.0, 0.5), ("k2", 2.0, 4.0), ("k3", 3.0, 5.0), ("k4", 9.5, 9.6))) -> Run:
    # window [0, 10] s; device busy on [0, 0.5], [2, 5] and [9.5, 9.6] (3.6 s)
    trace = Trace(0.0, 10.0, 9.0, sorted(device, key=lambda d: d[1]), [("window", 0.0, 10.0), *spans])
    return Run(seconds=9.0, loop_s=10.0, frames=90, tracks=1, trace=trace)


def test_known_answers():
    run_ = traced([("music_information", 0.0, 1.0), ("mir.features", 0.0, 1.0), ("render.loop", 1.0, 10.0),
                   ("render.noise", 1.0, 1.5), ("render.wait", 4.0, 5.0), ("render.noise", 5.0, 5.5),
                   ("render.wait", 9.0, 9.6)])
    # the device idles 6.4 s of the window; 5.9 of them inside the loop [1, 10] (busy 3.1 s there)
    assert read("device_idle_share", run_) == pytest.approx(64.0)
    assert read("render_idle_share", run_) == pytest.approx(59.0)
    assert read("render_wait_share", run_) == pytest.approx(16.0)
    assert read("noise_share", run_) == pytest.approx(10.0)
    # the gaps are named by the innermost span, the program's where one is open
    assert run_.trace.idle_gaps()[:2] == [["render.loop", pytest.approx(4.5)], ["render.noise", pytest.approx(1.5)]]


def test_spans_clipped_at_the_window_edges():
    run_ = traced([("render.loop", -2.0, 3.0), ("render.loop", 8.0, 12.0), ("render.wait", -1.0, 1.0),
                   ("render.wait", 9.5, 11.0), ("render.wait", 11.0, 12.0), ("render.noise", 10.5, 11.0)])
    # [0, 3]: busy 0.5 + 1.0, idle 1.5; [8, 10]: busy 0.1, idle 1.9
    assert read("render_idle_share", run_) == pytest.approx(34.0)
    assert read("render_wait_share", run_) == pytest.approx(15.0)
    assert read("noise_share", run_) is None     # its one span lies past the window


def test_none_without_the_programs_spans():
    run_ = traced([("render", 1.0, 10.0), ("features", 0.0, 1.0)])   # the benchmark's spans alone
    assert all(read(name, run_) is None for name in NEW)
    assert all(read(name, Run(seconds=9.0)) is None for name in NEW)


def test_render_idle_share_never_above_device_idle_share():
    rng = random.Random(5)
    for _ in range(200):
        device = []
        for _ in range(rng.randrange(0, 12)):
            s = rng.uniform(-1.0, 11.0)
            device.append((f"k{len(device)}", s, s + rng.uniform(0.0, 2.0)))
        cuts = sorted(rng.uniform(-2.0, 12.0) for _ in range(2 * rng.randrange(1, 5)))
        loops = [("render.loop", a, b) for a, b in zip(cuts[::2], cuts[1::2])]
        run_ = traced(loops, device)
        idle, inside = read("device_idle_share", run_), read("render_idle_share", run_)
        assert inside is None or inside <= idle + 1e-9


@pytest.mark.parametrize("workload", [LONGFORM, PATCH])
def test_small_traced_runs_report_the_new_entries(workload):
    config, mix = small(workload)
    result = run.run_cell(workload, 2**33 + 9, 2.0, True, device="cpu", config=config, mix=mix)
    assert result["correct"] is True
    listed = {m["name"] for m in bench()["per_layer"] if m["name"].split(".")[0] in NEW
              and workload in m["workloads"]}
    assert listed == ({"render_wait_share", "render_idle_share"} if workload == LONGFORM else
                      {"render_wait_share.patch", "render_idle_share.patch", "noise_share.patch"})
    got = result["metrics"]
    assert listed <= set(got)
    sfx = "" if workload == LONGFORM else ".patch"
    assert got["render_idle_share" + sfx]["value"] <= got["device_idle_share" + sfx]["value"] + 1e-9
    assert got["render_wait_share" + sfx]["value"] <= got["render_share" + sfx]["value"]
