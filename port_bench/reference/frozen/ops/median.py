# Frozen copy of ssar_tpu_torch/ops/median.py for the benchmark's plain reference.  It is not
# imported from the port, so a change to the port cannot change what the port is held to;
# port_bench/tests/test_bench_reference.py holds the two together at small sizes.
"""Median filters along one axis (HPSS's 31-tap windows, the segmentation's
7- and 9-tap ones), forward only, in plain PyTorch on every device: the
windows of the reflect-padded line and ``torch.median`` over each (the port
runs its sliding-median kernel there, which its tests hold equal to this).
"""
from __future__ import annotations

import torch


def reflect_indices(L: int, p: int, device=None) -> torch.Tensor:
    """The line positions that the reflect-padded positions -p .. L + p - 1
    mirror: a triangle wave of period 2(L - 1), the edge sample not repeated,
    which keeps reflecting when the pad is longer than the line (as numpy's
    and jax's 'reflect' do; ``F.pad`` refuses p >= L).  L = 1 repeats the
    sample."""
    q = torch.arange(-p, L + p, device=device)
    if L == 1:
        return torch.zeros_like(q)
    m = 2 * (L - 1)
    r = q.remainder(m)
    return torch.where(r < L, r, m - r)


def _windows(x: torch.Tensor, k: int) -> torch.Tensor:
    """(..., T) -> (..., T, k) windows of the reflect-padded last axis."""
    padded = x.index_select(-1, reflect_indices(x.shape[-1], k // 2, x.device))
    return padded.unfold(-1, k, 1)


def median_filter_plain(x: torch.Tensor, k: int, axis: int = -1) -> torch.Tensor:
    """Reflect-padded sliding median of odd width `k` along `axis` (any
    device, any length of the axis).  A window holding a NaN gives NaN."""
    return _windows(x.movedim(axis, -1), k).median(dim=-1).values.movedim(-1, axis)


def sliding_median_bwd_plain(x: torch.Tensor, out: torch.Tensor, g: torch.Tensor, k: int,
                             axis: int = -1) -> torch.Tensor:
    """Gradient of ``median_filter_plain(x, k, axis)`` for the cotangent `g`
    (any device): `g[t]` goes to the first tap of window t equal to `out[t]`
    (none when no tap is, e.g. a NaN), then the padded accumulator's halo is
    folded back by reflection.  The order of the adds is the kernel's: the
    taps ascending, then the halo after the interior, first the positions left
    of the line moving outward, then those right of it moving outward.  On a
    line longer than k // 2 each side folds in one flipped slice."""
    p = k // 2
    x, out, g = (t.movedim(axis, -1) for t in (x, out, g))
    T = x.shape[-1]
    eq = _windows(x, k) == out.unsqueeze(-1)
    sel = eq & (eq.cumsum(dim=-1) == 1)
    gwin = g.unsqueeze(-1) * sel.to(g.dtype)
    gxp = g.new_zeros(*x.shape[:-1], T + 2 * p)
    for i in range(k):
        gxp[..., i : i + T] += gwin[..., i]
    gx = gxp[..., p : p + T].clone()
    if T > p > 0:  # xp[p - j] == x[j] on the left, xp[2T + p - 2 - j] == x[j] on the right
        gx[..., 1 : p + 1] += gxp[..., :p].flip(-1)
        gx[..., T - p - 1 : T - 1] += gxp[..., p + T :].flip(-1)
    elif p:  # the halo wraps around the line: one padded position at a time
        mirror = reflect_indices(T, p).tolist()
        for q in [*range(p - 1, -1, -1), *range(p + T, T + 2 * p)]:
            gx[..., mirror[q]] += gxp[..., q]
    return gx.movedim(-1, axis)


PAD_MODES = ("reflect", "constant", "edge", "symmetric", "wrap")


def pad_indices(L: int, p: int, mode: str, device=None) -> torch.Tensor:
    """The line positions that the positions -p .. L + p - 1 of a line of
    length L padded in ``mode`` take (``np.pad``'s index maps; any p):
    "edge" repeats the end samples, "symmetric" reflects with the edge
    sample repeated, "wrap" is periodic.  ("reflect" is ``reflect_indices``;
    "constant" pads zeros and is no index map.)"""
    q = torch.arange(-p, L + p, device=device)
    if mode == "edge":
        return q.clamp(0, L - 1)
    if mode == "wrap":
        return q.remainder(L)
    if mode == "symmetric":
        r = q.remainder(2 * L)
        return torch.where(r < L, r, 2 * L - 1 - r)
    raise ValueError(f"no index map for mode {mode!r}")


def median_filter_padded(x: torch.Tensor, k: int, axis: int, mode: str) -> torch.Tensor:
    """The reference's path for every mode: pad `axis` by k // 2 in `mode`,
    then the median of each window; differentiable by autograd (the gradient
    goes to the tap ``torch.median`` returns, then back through the pad)."""
    x = x.movedim(axis, -1)
    p = k // 2
    if mode == "constant":
        padded = torch.nn.functional.pad(x, (p, p))
    else:
        padded = x.index_select(-1, pad_indices(x.shape[-1], p, mode, x.device))
    return padded.unfold(-1, k, 1).median(dim=-1).values.movedim(-1, axis)


def median_filter(x: torch.Tensor, k: int, axis: int = -1, mode: str = "reflect") -> torch.Tensor:
    """Sliding-window median of odd width `k` along `axis`, padded in `mode`
    (one of ``PAD_MODES``).  "reflect" does not repeat the edge sample, and an
    axis shorter than the pad keeps reflecting (``reflect_indices``): it runs
    the kernels on the card, is exact, and is differentiable by the
    first-equal-tap rule.  A window holding a NaN gives NaN."""
    if k % 2 != 1 or k < 1:
        raise ValueError(f"median_filter expects an odd window size, got {k}")
    if mode not in PAD_MODES:
        raise ValueError(f"median_filter takes mode in {PAD_MODES}, got {mode!r}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"median_filter runs on CUDA or CPU tensors, got {x.device}")
    axis = axis % x.ndim
    if mode != "reflect":
        return median_filter_padded(x, k, axis, mode)
    if x.dtype != torch.float32:
        return median_filter(x.float(), k, axis).to(x.dtype)
    return median_filter_plain(x, k, axis)


def median_filter2d_freq(S: torch.Tensor, ks: int = 31) -> torch.Tensor:
    """Median over the frequency axis (axis 0 of a (F, T) spectrogram)."""
    return median_filter(S, ks, axis=0, mode="reflect")


def median_filter2d_time(S: torch.Tensor, ks: int = 31) -> torch.Tensor:
    """Median over the time axis (axis 1 of a (F, T) spectrogram)."""
    return median_filter(S, ks, axis=1, mode="reflect")
