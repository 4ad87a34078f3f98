"""BENCHMARK.json against the benchmark's contract, and a new configuration,
traffic mix and per-layer metric added as files and entries alone: found
by name without an edit to any file already there."""
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

from .conftest import ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_meets_the_contract():
    b = bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    assert len(json.dumps(b)) < 64 * 1024
    assert 1 <= len(b["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p) for p in b["paths"])
    assert all(one_line(w) for w in b["command"]) and len(b["command"]) <= 32
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert one_line(c["source"]) and one_line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"])) and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        names.add(c["name"])
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in names and w["chips"] in (1, 4) and one_line(w["why"]) and NAME.match(w["traffic"])
        assert (ROOT / "port_bench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "port_bench" / "limits" / f"{w['name']}.json").is_file()
        cells.add(w["name"])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(cells) // 4)
    assert {c["name"] for c in b["configs"]} == {w["config"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    metric_names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(metric_names) == len(set(metric_names)) and all(NAME.match(n) for n in metric_names)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"} and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and 0.01 <= m["bound"] <= 0.25
    assert next(m for m in b["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    layers: dict = {}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e and UNIT.match(m["unit"]) and one_line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "port_bench" / "layer_metrics" / f"{m['name'].split('.')[0]}.py").is_file()
        assert layers.setdefault(m["name"].split(".")[0], m["layer"]) == m["layer"]
        moved = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
        assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells))
    for cell in cells:
        reported = [m for m in b["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in b["per_layer"])


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(tmp_path / "port_bench")
    pb = tmp_path / "port_bench"
    # a configuration: the reactor system at a small width
    config = json.loads((pb / "configs" / "sg2f1024-gru32x4.json").read_text())
    config["name"] = "sg2f128-gru32x4"
    config["generator"].update(resolution=128, max_channels=16)
    (pb / "configs" / "sg2f128-gru32x4.json").write_text(json.dumps(config))
    # a traffic mix: short tracks at 44.1 kHz
    mix = json.loads((pb / "traffic" / "longform.json").read_text())
    mix.update(seconds=3, sample_rate=44100, entry_batch_size=8, prepared_tracks=1, frames_checked=2)
    (pb / "traffic" / "short.json").write_text(json.dumps(mix))
    # the cell's limits and a per-layer metric of its own
    (pb / "limits" / "short.sg2f128-gru32x4.json").write_text(
        (pb / "limits" / "longform.sg2f1024-gru32x4.json").read_text())
    (pb / "layer_metrics" / "tracks_per_s.py").write_text(
        '"""Tracks served a second of the window."""\n\n\ndef read(run):\n'
        '    return run.tracks / run.seconds if run.tracks else None\n')
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "sg2f128-gru32x4", "source": "https://example.org/small", "reduced": ["generator"],
                         "file": "port_bench/configs/sg2f128-gru32x4.json", "why": "a test's small size"})
    b["workloads"].append({"name": "short.sg2f128-gru32x4", "config": "sg2f128-gru32x4", "traffic": "short",
                           "chips": 1, "why": "a test's cell"})
    b["per_layer"].append({"name": "tracks_per_s", "unit": "tracks/s", "better": "higher", "source": "host_clock",
                           "layer": "whole step", "moves": "frames_per_s", "workloads": ["short.sg2f128-gru32x4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    code = ("import sys, json; sys.path[:0] = [%r, %r]; import torch; torch.set_num_threads(2)\n"
            "import port_bench.run as run\n"
            "assert run.ROOT == __import__('pathlib').Path(%r)\n"
            "r = run.run_cell('short.sg2f128-gru32x4', 7, 2.0, True, device='cpu')\n"
            "print(json.dumps(r))\n") % (str(tmp_path), str(ROOT), str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and "tracks_per_s" in result["metrics"]
    after = digest(pb)
    assert {k: v for k, v in after.items() if k in before} == before
