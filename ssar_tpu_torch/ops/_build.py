"""Build the package's CUDA sources into shared libraries at first use, and
launch their entry points on PyTorch's stream.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/kernels/lib<name>-<hash>.so`` under the checkout (``build/`` is
git-ignored) and loaded with ``ctypes``.  The sources expose plain C entry
points, so no PyTorch header is compiled and a build takes seconds to a
minute.  The file name carries a hash of the source, the headers of
``csrc/`` it includes (transitively) and the flags, so an edited source or
header is rebuilt and a stale library is never loaded; ``host_emulation.h``,
which only a host build (``-DSSAR_HOST_EMULATION``) reads, is left out.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

HOST_ONLY_HEADERS = ("host_emulation.h",)
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_loaded: dict[str, ctypes.CDLL] = {}
_raw_stream = None  # device index -> the current stream's handle
build_log: dict[str, dict] = {}  # name -> {"seconds", "ptxas", "path"} of builds made in this process


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built from source on a machine "
                           "with the CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return found


def card_sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the headers of ``csrc/`` that a card build of it
    reads: its quoted includes, transitively, without the host-only ones."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [CSRC / inc for inc in _INCLUDE.findall(path.read_text())
                 if inc not in HOST_ONLY_HEADERS and (CSRC / inc).exists()]
    return found


def library_path(name: str) -> Path:
    content = b"".join(p.read_bytes() for p in card_sources(name)) + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(content).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists; return the path."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    build_log[name] = {"seconds": time.perf_counter() - t0, "ptxas": proc.stderr, "path": str(out)}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib


def current_stream(device: torch.device) -> int:
    """The device's current stream as a raw handle (without a Stream object,
    where this PyTorch has the call)."""
    global _raw_stream
    if _raw_stream is None:
        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) \
            or (lambda index: torch.cuda.current_stream(index).cuda_stream)
    return _raw_stream(device.index)


def launch(fn, device: torch.device, *args) -> int:
    """``fn(*args, stream)`` on the device's current stream; the device guard
    is entered only for a device that is not the current one."""
    if device.index == torch.cuda.current_device():
        return fn(*args, current_stream(device))
    with torch.cuda.device(device):
        return fn(*args, current_stream(device))
