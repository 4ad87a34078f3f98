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
input size once and keeps them on the device.

Counters: ``calls`` (ops applied) and ``least_bytes`` (each call's input read
once and its output written once, at the call's dtype: the least that any
implementation of the op moves).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

calls = 0
least_bytes = 0

INDEX_LIMIT = 2**31 - 1
TILE = 256          # outputs a block of a banded filter matrix


def reset_counters() -> None:
    global calls, least_bytes
    calls = least_bytes = 0


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
    Each axis's up- and down-filter is a banded matrix of its taps
    (``up_matrix``, ``down_matrix``), cut into blocks of ``TILE`` outputs with
    the span of inputs each reaches (``band_tiles``), built on the host for
    an input size at its first call and kept on the device; the op is then
    four products a block, the leaky ReLU and the clamp."""

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
        if b is not None:
            x = x + b.to(x.dtype)[:, None, None]
        if self.identity:
            y = self._act(x.clone() if b is None else x)
            if self.gain != 1.0:
                y.mul_(self.gain)
        else:
            (uh, lh), (uw, lw), (dh, mh), (dw, mw) = self.matrices(*x.shape[-2:])
            # frames in groups of under 2**31 upsampled values: 32-bit sizes stay safe, temporaries bounded
            per = max(1, INDEX_LIMIT // (self.channels * lh * lw))
            parts = [_cols(_rows(dh, mh, self._act(_cols(_rows(uh, lh, x[i:i + per]), uw, lw))), dw, mw)
                     for i in range(0, x.shape[0], per)]
            y = parts[0] if len(parts) == 1 else torch.cat(parts)
        calls += 1
        least_bytes += (x.numel() + y.numel()) * x.element_size()
        return y

    def _act(self, y: torch.Tensor) -> torch.Tensor:
        """The leaky ReLU and the clamp, in place (the gain is the down-filter's)."""
        if self.slope != 1.0:
            F.leaky_relu_(y, self.slope)
        if self.bound is not None:
            y.clamp_(-self.bound, self.bound)
        return y
