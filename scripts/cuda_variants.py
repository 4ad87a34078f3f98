"""Variants of a kernel source of ``ssar_tpu_torch/csrc``, built side by side for the ``explore_torch_*`` scripts.

A variant is the source with a few text substitutions.  ``build_variants``
compiles every variant with nvcc in parallel into ``build/<stem>_variants/``
and loads each with ctypes; ``ptxas_report`` reads a variant's registers and
spills from nvcc's ``-Xptxas -v`` output.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _build(source: str, name: str, subs) -> tuple[Path, str]:
    from ssar_tpu_torch.ops import _build

    src = (_build.CSRC / source).read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"variant {name}: {old!r} not in {source}")
        src = src.replace(old, new)
    out_dir = ROOT / "build" / f"{Path(source).stem}_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"variant {name}: nvcc failed\n{proc.stderr[-3000:]}")
    return lib, proc.stderr


def build_variants(source: str, variants: dict, names: list[str]) -> dict[str, tuple[ctypes.CDLL, str]]:
    """``{name: (library, ptxas output)}`` for the variants `names` of csrc/`source`, compiled in parallel."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(lambda n: _build(source, n, variants[n]), names))
    return {n: (ctypes.CDLL(str(lib)), ptxas) for n, (lib, ptxas) in zip(names, built)}


def ptxas_report(ptxas: str, kernel: str = "") -> str:
    """Registers of the kernels whose name holds `kernel` (all kernels if empty), and any spills."""
    lines = ptxas.splitlines()
    regs = sorted({ln.split("Used ")[1].split(",")[0] for i, ln in enumerate(lines)
                   if "Used " in ln and any(kernel in p for p in lines[max(0, i - 2):i])})
    spills = sorted({ln.strip() for ln in lines if "spill" in ln and " 0 bytes spill stores" not in ln})
    return f"{regs}; {spills or 'no spills'}"
