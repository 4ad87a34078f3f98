"""Build the package's CUDA sources into shared libraries at first use, and
launch their entry points on PyTorch's stream.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/kernels/lib<name>-<hash>.so`` under the checkout (``build/`` is
git-ignored) and loaded with ``ctypes``.  The sources expose plain C entry
points, so no PyTorch header is compiled and a build takes seconds to a
minute.  The file name carries a hash of the source, the directory's headers
and the flags, so an edited source is rebuilt and a stale library is never
loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_raw_stream = None  # device index -> the current stream's handle
build_log: dict[str, dict] = {}  # name -> {"seconds", "ptxas", "path"} of builds made in this process


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built from source on a machine "
                           "with the CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return found


def library_path(name: str) -> Path:
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh")), *sorted(CSRC.glob("*.h"))]  # headers it may include
    content = b"".join(p.read_bytes() for p in sources) + " ".join(NVCC_FLAGS).encode()
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


def launch(fn, device: torch.device, *args) -> int:
    """``fn(*args, stream)`` on the device's current stream, read as a raw
    handle (without a Stream object, where this PyTorch has the call); the
    device guard is entered only for a device that is not the current one."""
    global _raw_stream
    if _raw_stream is None:
        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) \
            or (lambda index: torch.cuda.current_stream(index).cuda_stream)
    if device.index == torch.cuda.current_device():
        return fn(*args, _raw_stream(device.index))
    with torch.cuda.device(device):
        return fn(*args, _raw_stream(device.index))
