"""A whole run on the CPU at a small size: the result line's keys, the refusal
without a card, and the check that nothing of JAX or the JAX package is
loaded."""
import json
import subprocess
import sys
import types

import pytest

import port_bench.run as run
from port_bench import harness

from .conftest import LONGFORM, PATCH, ROOT, bench, small

E2E = {"frames_per_s", "frames_per_s.patch", "peak_mem_gib", "setup_s"}


def one(workload, trace, seconds=2.0):
    config, mix = small(workload)
    return run.run_cell(workload, 2**33 + 21, seconds, trace, device="cpu", config=config, mix=mix)


def test_result_line_untraced():
    result = one(LONGFORM, False)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"frames_per_s", "peak_mem_gib", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    assert set(result["checks"]) == {"features_gap", "latents_gap", "noise_gap", "frames_gap"}
    assert all(set(c) == {"value", "limit"} for c in result["checks"].values())
    json.dumps(result)


def test_result_line_traced():
    result = one(PATCH, True, seconds=3.0)
    assert result["correct"] is True
    listed = {m["name"] for m in bench()["per_layer"] if PATCH in m["workloads"]}
    assert set(result["metrics"]) <= listed and not set(result["metrics"]) & E2E
    assert {"render_share.patch", "patch_share", "features_share.patch"} <= set(result["metrics"])
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(result)[-1] == "checks"


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert run.main(["--workload", LONGFORM, "--seed", "1", "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_forbidden_module_no_result(capsys, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: {"correct": True, "checks": {}})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.main(["--workload", LONGFORM, "--seed", "1", "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name, hit", [("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
                                       ("flax.linen", True), ("optax", True), ("ssar_tpu", True),
                                       ("ssar_tpu.ops.median", True), ("ssar_tpu_torch", False),
                                       ("ssar_tpu_torch.ops", False), ("jaxtyping", False)])
def test_forbidden_names_compare_whole_top_level(monkeypatch, name, hit):
    for m in [m for m in sys.modules if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (harness.forbidden_modules() != []) == hit


def test_a_run_loads_nothing_forbidden():
    code = ("import sys; sys.path.insert(0, %r); import torch; torch.set_num_threads(2)\n"
            "from port_bench.tests.conftest import small, LONGFORM, PATCH\n"
            "import port_bench.run as run\n"
            "for w in (LONGFORM, PATCH):\n"
            "    c, m = small(w, seconds=2.0)\n"
            "    r = run.run_cell(w, 5, 1.0, False, device='cpu', config=c, mix=m)\n"
            "from port_bench.harness import forbidden_modules\n"
            "print('FORBIDDEN', forbidden_modules())\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "FORBIDDEN []"
