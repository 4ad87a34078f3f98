"""ctypes bindings for the repository's host-side C++ sources (``native/``).

Counterpart of ``ssar_tpu/utils/native.py``: exact quantiles and the
IQR-clamp standardisation (``native/efficient_quantile.cpp``), and the
memory-mapped window loader behind the raw streaming cache
(``native/window_loader.cpp``).  Each source is compiled by ``g++`` at first
use into ``build/native/lib<name>-<hash>.so`` under the checkout (``build/`` is
git-ignored); the name carries a hash of the source and the flags, so an
edited source is rebuilt and a stale library never loaded.  The sources are
read, never edited, and nothing is written next to them.  ``-march=native``
ties a library to the machine that built it, so it is built where it runs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = ROOT / "native"
BUILD_DIR = ROOT / "build" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")

_loaded: dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    content = (NATIVE_DIR / f"{name}.cpp").read_bytes() + " ".join(GXX_FLAGS).encode()
    return BUILD_DIR / f"lib{name}-{hashlib.sha256(content).hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``native/<name>.cpp`` unless its library exists; return the path."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(NATIVE_DIR / f"{name}.cpp"), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for native/{name}.cpp:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: another process never loads a partial file
    return out


def _load(name: str, signatures: dict) -> ctypes.CDLL:
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _loaded[name] = lib
    return lib


_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _quantile_lib() -> ctypes.CDLL:
    return _load("efficient_quantile", {
        "quantile_f32": (ctypes.c_double, [_F32P, ctypes.c_int64, ctypes.c_double]),
        "quantile_f32_cols": (None, [_F32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_double, _F64P]),
        "standardize_f32": (None, [_F32P, ctypes.c_int64, ctypes.c_double, ctypes.c_double]),
    })


def _loader_lib() -> ctypes.CDLL:
    return _load("window_loader", {
        "wl_open": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]),
        "wl_close": (None, [ctypes.c_void_p]),
        "wl_gather": (ctypes.c_int, [ctypes.c_void_p, _I64P, ctypes.c_int64, ctypes.c_int64, _F32P, ctypes.c_int]),
        "wl_rows": (ctypes.c_int64, [ctypes.c_void_p]),
    })


def _as_f32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x), dtype=np.float32)


def quantile(x, q: float) -> float:
    """Exact linear-interpolation quantile over all elements (C++ nth_element)."""
    buf = _as_f32(x).reshape(-1)
    return float(_quantile_lib().quantile_f32(buf.ctypes.data_as(_F32P), buf.size, float(q)))


def quantile_cols(x, q: float) -> np.ndarray:
    """Per-column quantiles of an (n, m) matrix."""
    buf = _as_f32(x)
    n, m = buf.shape
    out = np.empty(m, np.float64)
    _quantile_lib().quantile_f32_cols(buf.ctypes.data_as(_F32P), n, m, float(q), out.ctypes.data_as(_F64P))
    return out


def standardize(x, lo_q: float = 0.25, hi_q: float = 0.75) -> np.ndarray:
    """IQR clamp + min-max normalise, in C++."""
    buf = _as_f32(x).copy()
    flat = buf.reshape(-1)
    _quantile_lib().standardize_f32(flat.ctypes.data_as(_F32P), flat.size, float(lo_q), float(hi_q))
    return buf


def _npy_header(path) -> tuple[tuple, int]:
    """(shape, data offset in bytes) of a float32 .npy without loading it."""
    readers = {(1, 0): np.lib.format.read_array_header_1_0, (2, 0): np.lib.format.read_array_header_2_0}
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        if version not in readers:
            raise ValueError(f"{path}: .npy format {version} is not read here (np.save writes 1.0)")
        shape, fortran, dtype = readers[version](f)
        if fortran or dtype != np.float32:
            raise ValueError(f"{path}: the loader requires a C-order float32 .npy")
        return shape, f.tell()


class MmapWindows:
    """Windowed view of an on-disk float32 .npy (rows, ...), gathered by the
    C++ loader from a memory map: ``gather(starts)`` -> (n, window, *trailing)."""

    def __init__(self, path, window: int):
        shape, offset = _npy_header(path)
        self.window = int(window)
        self.trailing = tuple(shape[1:])
        self.rows = int(shape[0])
        self.cols = int(np.prod(self.trailing)) if self.trailing else 1
        self._lib = _loader_lib()
        self._h = self._lib.wl_open(str(path).encode(), self.rows, self.cols, offset)
        if not self._h:
            raise OSError(f"wl_open failed for {path}")

    def gather(self, starts, n_threads: int = 4) -> np.ndarray:
        """The windows that begin at `starts`; IndexError for a window that
        would run past the last row (or a negative start)."""
        starts = np.ascontiguousarray(starts, np.int64)
        out = np.empty((len(starts), self.window, self.cols), np.float32)
        rc = self._lib.wl_gather(self._h, starts.ctypes.data_as(_I64P), len(starts), self.window,
                                 out.ctypes.data_as(_F32P), n_threads)
        if rc != 0:
            raise IndexError("window start out of range")
        return out.reshape((len(starts), self.window) + self.trailing)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.wl_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
