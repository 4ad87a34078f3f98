"""StyleGAN3's filtered leaky ReLU in plain PyTorch, separable and polyphase.

The op of every synthesis layer of StyleGAN3 (NVlabs/stylegan3,
``torch_utils/ops/filtered_lrelu.py``; its ``_filtered_lrelu_ref`` fixes the
order): add the bias, upsample x``up`` with the up-filter ``fu`` (gain up²),
leaky ReLU with its gain and clamp, filter with ``fd`` and keep every
``down``-th sample.  The reference upsamples by inserting zeros and runs
each 1-D filter over the whole zero-filled grid.  Here no zero-inserted
tensor is built: along each axis the upsampling is a product with a banded
matrix whose row m holds the taps of phase m mod ``up`` (the polyphase
filter, padding and cropping included), and the down-filter a product with
a banded matrix that computes the kept samples alone (strided).  Each
product runs a block of ``TILE`` outputs at a time over the span of inputs
the block's band reaches, on the tensor cores in the layer's dtype with
float32 accumulation; the zeros inside a block's span are multiplied too,
which the counted work (``port_bench/sg3_counts.py``) leaves out.  The bias
is added where the reference adds it, on the op's input; the leaky ReLU and
the clamp run in place over the upsampled tensor, the gain folded into the
down-filter along H (and the clamp's bound divided by it).

The filters are designed once on the host (``design_lowpass_filter``, scipy's
``firwin``); a ``FilteredLReLU`` (one a layer) builds their matrices for an
input size once and keeps them.

On a CUDA tensor the op is kernel F1 (``csrc/filtered_lrelu.cu``), one launch
a call.  F1 replaces no TPU kernel (the JAX package has no StyleGAN3); it was
added because the banded products wrote the upsampled grid to device memory
and read it back about four times, 60-74 % of the StyleGAN3 cell's device
time at ~2 % of the op's byte bound.  A block takes a tile of output pixels
of one (sample, channel) plane, stages the input tile and its halo in shared
memory with the bias added and upsamples it along W by the taps of each
phase alone; a thread then takes a column, upsamples it along H, applies
the leaky ReLU and the clamp and filters it along H, the upsampled samples
streaming through registers into the kept rows; the kept samples along W
follow, and the tile is written once.  The upsampled grid never reaches
device memory, so F1 is bound by float32 FMAs and shared memory, not by
HBM.  It takes the three classes (up, down, taps of fu, taps of fd) of
StyleGAN3's schedule, (2, 2, 12, 12), (4, 2, 24, 12) and ToRGB's (1, 1, 1,
1), a slope in [0, 1], float16 (arithmetic in float32) or float32, no
gradient, and raises on anything else.  Its taps are the plain version's
matrix entries in float32, built once a layer (``launch_taps``) and passed
as the launch's parameters.  The banded products run for CPU tensors only:
they are the plain version, which the CPU tests use and the card tests hold
F1 to.

Counters: ``calls`` (ops applied), ``least_bytes`` (each call's input read
once and its output written once, at the call's dtype: the least that any
implementation of the op moves) and ``launches`` (F1 launches; on a card
every call is one).
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

calls = 0
least_bytes = 0
launches = 0

INDEX_LIMIT = 2**31 - 1
TILE = 256          # outputs a block of a banded filter matrix


# F1's classes: (up, down, taps of fu, taps of fd)
CLASSES = ((2, 2, 12, 12), (4, 2, 24, 12), (1, 1, 1, 1))

_fn = None   # the library's ssar_filtered_lrelu, once bound


def reset_counters() -> None:
    global calls, least_bytes, launches
    calls = least_bytes = launches = 0


class Taps(ctypes.Structure):
    """csrc/filtered_lrelu.cu's FlrTaps: the up-filter flipped and times up,
    the down-filter flipped (along W) and flipped and times the gain (along H),
    in float32, as the plain version's matrices hold them."""

    _fields_ = [("up", ctypes.c_float * 24), ("down_w", ctypes.c_float * 12), ("down_h", ctypes.c_float * 12)]


def bind(lib: ctypes.CDLL):
    """The library's entry point with its argument types, after checking that
    the binding's ``Taps`` has the size the source gives FlrTaps."""
    size = lib.ssar_filtered_lrelu_taps_size()
    if size != ctypes.sizeof(Taps):
        raise RuntimeError(f"filtered_lrelu.cu's taps are {size} bytes, the binding's {ctypes.sizeof(Taps)}")
    fn = lib.ssar_filtered_lrelu
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 7 \
        + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _card_entry(device: torch.device):
    global _fn
    if _fn is None:
        _fn = bind(_build.load("filtered_lrelu"))
    return lambda *args: _build.launch(_fn, device, *args)


def design_lowpass_filter(numtaps: int, cutoff: float, width: float, fs: float) -> np.ndarray | None:
    """Separable Kaiser-windowed sinc low-pass of `numtaps` taps (float64),
    or None for the identity (one tap)."""
    if numtaps == 1:
        return None
    import scipy.signal

    return scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width, fs=fs)


def up_matrix(f: np.ndarray | None, up: int, pad_lo: int, n: int, out_len: int) -> np.ndarray:
    """The upsampling along one axis as an (out_len, n) matrix of its polyphase taps.

    The reference's output sample m of the zero-inserted, `pad_lo`-padded
    signal is ``sum_k h[k] z[m + k]`` with h the flipped filter times `up`
    (the axis's share of the gain up²), and z holds x[i] at up * i + pad_lo:
    so ``M[m, i] = h[up * i + pad_lo - m]`` where that index is a tap.  Row m
    holds the taps of phase m mod up alone; no inserted zero is multiplied."""
    h = (np.ones(1) if f is None else np.asarray(f, np.float64)[::-1]) * up
    k = up * np.arange(n)[None, :] + pad_lo - np.arange(out_len)[:, None]
    valid = (k >= 0) & (k < len(h))
    return np.where(valid, h[np.clip(k, 0, len(h) - 1)], 0.0)


def down_matrix(f: np.ndarray | None, down: int, n: int, gain: float = 1.0) -> np.ndarray:
    """The filtering and downsampling along one axis as a (kept, n) matrix:
    ``D[j, m] = gain * h[m - down * j]`` (h the flipped filter), only the kept
    samples computed."""
    h = (np.ones(1) if f is None else np.asarray(f, np.float64)[::-1]) * gain
    kept = -(-(n - len(h) + 1) // down)
    k = np.arange(n)[None, :] - down * np.arange(kept)[:, None]
    valid = (k >= 0) & (k < len(h))
    return np.where(valid, h[np.clip(k, 0, len(h) - 1)], 0.0)


def band_tiles(m: np.ndarray, size: int = TILE) -> list[tuple[int, int, int, int, np.ndarray]]:
    """A banded (out, in) matrix as blocks of `size` outputs, each with the
    span of inputs its rows reach: (r0, r1, a, b, m[r0:r1, a:b])."""
    tiles = []
    for r0 in range(0, m.shape[0], size):
        block = m[r0:r0 + size]
        nz = np.flatnonzero(block.any(axis=0))
        a, b = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 1)
        tiles.append((r0, r0 + block.shape[0], a, b, block[:, a:b]))
    return tiles


def _rows(tiles: list, out_len: int, x: torch.Tensor) -> torch.Tensor:
    """The banded matrix of `tiles` applied along dim -2 of x (..., n, W): a
    batched product a tile, the tile shared by every plane (batch stride 0),
    each reading its span of rows of x in place and writing its rows of the
    output in place."""
    x3 = x.reshape(-1, *x.shape[-2:])
    out = x3.new_empty(x3.shape[0], out_len, x3.shape[2])
    for r0, r1, a, b, t in tiles:
        torch.bmm(t.expand(x3.shape[0], *t.shape), x3[:, a:b], out=out[:, r0:r1])
    return out.view(*x.shape[:-2], out_len, x.shape[-1])


def _cols(x: torch.Tensor, tiles: list, out_len: int) -> torch.Tensor:
    """The banded matrix of `tiles` (held transposed) applied along the last
    dim of x: one product a tile over all rows, in place."""
    x2 = x.reshape(-1, x.shape[-1])
    out = x2.new_empty(x2.shape[0], out_len)
    for r0, r1, a, b, t in tiles:
        torch.mm(x2[:, a:b], t, out=out[:, r0:r1])
    return out.view(*x.shape[:-1], out_len)


class FilteredLReLU:
    """One layer's filtered leaky ReLU, its filters in `dtype` on `device`.

    `fu`, `fd`: 1-D filters (numpy) or None; `padding` (px0, px1, py0, py1)
    on the upsampled grid, as the reference's; `channels` of the input.
    On a CUDA tensor a call is one launch of F1 with the layer's taps
    (``taps``, built here for F1's classes).  On a CPU tensor each axis's up-
    and down-filter is a banded matrix of its taps (``up_matrix``,
    ``down_matrix``), cut into blocks of ``TILE`` outputs with the span of
    inputs each reaches (``band_tiles``), built for an input size at its
    first call and kept; the op is then four products a block, the leaky
    ReLU and the clamp."""

    def __init__(self, fu, fd, up: int, down: int, padding, gain: float, slope: float, clamp: float | None,
                 channels: int, device=None, dtype=torch.float32):
        self.fu, self.fd = fu, fd
        self.up, self.down, self.slope = int(up), int(down), float(slope)
        self.padding = tuple(int(p) for p in padding)
        self.ku = 1 if fu is None else len(fu)
        self.kd = 1 if fd is None else len(fd)
        self.channels, self.device, self.dtype = channels, device, dtype
        self.gain = float(gain)
        self.bound = None if clamp is None else float(clamp) / self.gain
        self.identity = self.ku == self.kd == self.up == self.down == 1 and not any(self.padding)
        self._mats: dict = {}
        self.taps = launch_taps(fu, fd, self.up, self.gain) if (up, down, self.ku, self.kd) in CLASSES else None

    def out_size(self, h: int, w: int) -> tuple[int, int]:
        """The output's (height, width) for an (h, w) input."""
        px0, px1, py0, py1 = self.padding

        def kept(n, p0, p1):
            return -(-(n * self.up + p0 + p1 - self.ku + 1 - self.kd + 1) // self.down)

        return kept(h, py0, py1), kept(w, px0, px1)

    def matrices(self, h: int, w: int) -> tuple:
        """The tiles of the up-filter along H and along W and of the
        down-filter (with the gain) along H and along W for an (h, w) input,
        on the device, and the four output lengths."""
        if (h, w) not in self._mats:
            px0, px1, py0, py1 = self.padding
            lh, lw = h * self.up + py0 + py1 - self.ku + 1, w * self.up + px0 + px1 - self.ku + 1
            mats = (up_matrix(self.fu, self.up, py0, h, lh), up_matrix(self.fu, self.up, px0, w, lw),
                    down_matrix(self.fd, self.down, lh, self.gain), down_matrix(self.fd, self.down, lw))

            def put(a):
                return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32).to(self.device, self.dtype)

            self._mats[(h, w)] = tuple(
                ([(r0, r1, a, b, put(t if i % 2 == 0 else t.T)) for r0, r1, a, b, t in band_tiles(m)], m.shape[0])
                for i, m in enumerate(mats))
        return self._mats[(h, w)]

    def __call__(self, x: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
        global calls, least_bytes
        y = self.launch(x, b, _card_entry(x.device)) if x.device.type == "cuda" else self.plain(x, b)
        calls += 1
        least_bytes += (x.numel() + y.numel()) * x.element_size()
        return y

    def plain(self, x: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
        """The op as banded products (the CPU path and F1's reference)."""
        if b is not None:
            x = x + b.to(x.dtype)[:, None, None]
        if self.identity:
            y = self._act(x.clone() if b is None else x)
            if self.gain != 1.0:
                y.mul_(self.gain)
            return y
        (uh, lh), (uw, lw), (dh, mh), (dw, mw) = self.matrices(*x.shape[-2:])
        # frames in groups of under 2**31 upsampled values: 32-bit sizes stay safe, temporaries bounded
        per = max(1, INDEX_LIMIT // (self.channels * lh * lw))
        parts = [_cols(_rows(dh, mh, self._act(_cols(_rows(uh, lh, x[i:i + per]), uw, lw))), dw, mw)
                 for i in range(0, x.shape[0], per)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def launch(self, x: torch.Tensor, b: torch.Tensor | None, entry) -> torch.Tensor:
        """The op by one launch of F1 through ``entry(*args)`` (the library's
        ``ssar_filtered_lrelu`` with the stream bound), after checking the
        layer's class and the tensors; the output from ``torch.empty``."""
        global launches
        cls = (self.up, self.down, self.ku, self.kd)
        if cls not in CLASSES or (cls == (1, 1, 1, 1) and any(self.padding)) or not 0.0 <= self.slope <= 1.0:
            raise ValueError(f"filtered_lrelu: F1 takes (up, down, up taps, down taps) in {CLASSES} (the last "
                             f"without padding) and a slope in [0, 1], not {cls} with padding {self.padding} and "
                             f"slope {self.slope}")
        if x.dtype != self.dtype or x.dtype not in (torch.float16, torch.float32):
            raise TypeError(f"filtered_lrelu: the input is {x.dtype}; this layer's F1 takes {self.dtype}")
        if x.ndim != 4 or x.shape[1] != self.channels:
            raise ValueError(f"filtered_lrelu: the input is {tuple(x.shape)}, not (N, {self.channels}, H, W)")
        if not x.is_contiguous():
            raise ValueError("filtered_lrelu: the input is not contiguous")
        if torch.is_grad_enabled() and (x.requires_grad or (b is not None and b.requires_grad)):
            raise RuntimeError("filtered_lrelu: F1 has no backward; call it under torch.no_grad()")
        if b is not None:
            if b.device != x.device or tuple(b.shape) != (self.channels,):
                raise ValueError(f"filtered_lrelu: a bias of {tuple(b.shape)} on {b.device} for an input on "
                                 f"{x.device} with {self.channels} channels")
            b = b.to(torch.float32).contiguous()
        n, c, h, w = x.shape
        oh, ow = self.out_size(h, w)
        if oh <= 0 or ow <= 0:
            raise ValueError(f"filtered_lrelu: an input of {h}x{w} gives no output")
        y = torch.empty((n, c, oh, ow), device=x.device, dtype=x.dtype)
        px0, _, py0, _ = self.padding
        err = entry(*cls, int(x.dtype == torch.float16), x.data_ptr(), y.data_ptr(),
                    None if b is None else b.data_ptr(), ctypes.addressof(self.taps), n * c, c, h, w, oh, ow,
                    px0, py0, self.slope, math.inf if self.bound is None else self.bound)
        if err != 0:
            raise RuntimeError(f"filtered_lrelu launch failed: cudaError {err}")
        launches += 1
        return y

    def _act(self, y: torch.Tensor) -> torch.Tensor:
        """The leaky ReLU and the clamp, in place (the gain is the down-filter's)."""
        if self.slope != 1.0:
            F.leaky_relu_(y, self.slope)
        if self.bound is not None:
            y.clamp_(-self.bound, self.bound)
        return y


def launch_taps(fu, fd, up: int, gain: float) -> Taps:
    """F1's taps of a layer: the entries of ``up_matrix`` and ``down_matrix``
    (flipped filters, the up-filter times `up`, the H down-filter times the
    gain), rounded to float32 from float64 as the plain version rounds them."""
    taps = Taps()
    for field, f, scale in (("up", fu, up), ("down_w", fd, 1.0), ("down_h", fd, gain)):
        h = (np.ones(1) if f is None else np.asarray(f, np.float64)[::-1]) * scale
        getattr(taps, field)[:len(h)] = [float(v) for v in h.astype(np.float32)]
    return taps
