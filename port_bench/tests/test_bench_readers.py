"""Every per-layer reader on a small synthetic run: spans, counters and a
device trace written out by hand."""
import importlib

import pytest

from port_bench.harness import Run
from port_bench.peaks import H100_SXM
from port_bench.trace import Trace

from .conftest import bench


def run_with_trace() -> Run:
    # window [0, 10] s, deadline 9 s; device busy on [0, 1], [2, 4] and [3, 5] (union 4 s)
    device = [("void sliding_median_kernel<31, true>(float const*)", 0.0, 0.5),
              ("Memcpy DtoH (Device -> Pinned)", 0.5, 1.0),
              ("sm90_xmma_fprop_kernel", 2.0, 4.0),
              ("void sliding_median_kernel<31, false>(float const*)", 3.0, 5.0),
              ("late_kernel", 9.5, 9.6)]
    spans = [("window", 0.0, 10.0), ("features", 0.0, 1.0), ("render", 1.0, 10.0), ("reactor", 5.5, 6.5)]
    trace = Trace(0.0, 10.0, 9.0, sorted(device, key=lambda d: d[1]), spans)
    return Run(seconds=9.0, loop_s=10.0, frames=90, tracks=2,
               stage_s={"features": 1.0, "reactor": 0.5, "render": 8.0, "segmentation": 0.25, "patch": 0.1,
                        "model_build": 0.2},
               flops_per_frame=1e12, peaks=H100_SXM, trace=trace,
               counters={"sliding_median_numel": [1_000_000, 2_000_000]})


def read(name, run):
    return importlib.import_module(f"port_bench.layer_metrics.{name}").read(run)


def test_shares():
    run = run_with_trace()
    assert read("render_share", run) == pytest.approx(80.0)
    assert read("features_share", run) == pytest.approx(10.0)
    assert read("reactor_share", run) == pytest.approx(5.0)
    assert read("segmentation_share", run) == pytest.approx(2.5)
    assert read("patch_share", run) == pytest.approx(1.0)
    assert read("model_build_share", run) == pytest.approx(2.0)


def test_mfu():
    run = run_with_trace()   # 90 frames of 1 TFLOP in 9 s against 989 TFLOP/s
    assert read("mfu", run) == pytest.approx(100 * 90e12 / 9 / 989e12)


def test_median_roofline():
    run = run_with_trace()   # 3e6 elements read and written as float32 over 3.35 TB/s, against 0.5 + 2 s
    assert read("median_roofline", run) == pytest.approx(100 * (8 * 3e6 / 3.35e12) / 2.5)
    run.counters["sliding_median_numel"] = [1]   # counts disagree with the trace: nothing to read
    assert read("median_roofline", run) is None


def test_device_idle_share_and_launches():
    run = run_with_trace()
    assert read("device_idle_share", run) == pytest.approx(100 * (1 - (1.0 + 3.0 + 0.1) / 10))
    # kernels started within the window's seconds (copies left out, the late kernel past the deadline)
    assert read("launches_per_frame", run) == pytest.approx(3 / 90)


def test_breakdown():
    trace = run_with_trace().trace
    ops = dict(trace.top_ops())
    assert ops["sm90_xmma_fprop_kernel"] == pytest.approx(2.0)
    gaps = trace.idle_gaps()
    assert gaps[0] == ["render", pytest.approx(4.5)]     # 5.0 -> 9.5, the host in the render span at 7.25
    assert gaps[1] == ["render", pytest.approx(1.0)]     # 1.0 -> 2.0


def test_nothing_to_read():
    empty = Run(seconds=9.0)
    for m in bench()["per_layer"]:
        assert read(m["name"].split(".")[0], empty) is None, m["name"]
