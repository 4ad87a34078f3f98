"""Small sizes of the cells for the CPU tests: the configurations' widths cut
to a 128 px generator with 16 channels (12 W+ rows: three palette splits),
4 s tracks, batch 8."""
from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

LONGFORM, PATCH = "longform.sg2f1024-gru32x4", "patch.sg2f1024-patch"


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def small(workload: str, seconds: float = 4.0) -> tuple[dict, dict]:
    """The cell's configuration and mix at a size the CPU runs in seconds."""
    from port_bench.harness import find_cell
    from port_bench.traffic import load_mix

    cell, _, config = find_cell(workload, bench())
    config = copy.deepcopy(config)
    config["generator"].update(resolution=128, max_channels=16)
    mix = load_mix(cell["traffic"])
    mix.update(seconds=seconds, entry_batch_size=8, prepared_tracks=1, frames_checked=3)
    return config, mix


@pytest.fixture(autouse=True)
def few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
