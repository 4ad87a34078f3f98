"""Operations and bytes of one StyleGAN3-T frame, counted from the
configuration's schedule (``reference/stylegan3.py:schedule``); a
multiply-add counts 2.

Operations: the Fourier input's mixing product; each layer's style affine,
demodulation product (``style**2 @ w2``) and modulated convolution (its full
output grid, ``in_size + k - 1`` a side); each filtered leaky ReLU's
multiply-adds at the nonzero taps of its polyphase up-filter (``up_taps /
up`` an output sample, along each axis) and of its strided down-filter
(``down_taps`` a kept sample, along each axis).  The mapping network is not
counted: the reactor's latents are W+ rows already, nothing is mapped.  Not
counted either: elementwise work (sines, modulation and demodulation
scales, bias, leaky ReLU, clamp, the I420 packing).

Bytes: each filtered-leaky-ReLU call's input read once and output written
once, at the layer's dtype (2 bytes in the half-precision layers, else 4):
the least any implementation moves.
"""
from __future__ import annotations

from .reference.stylegan3 import DEFAULTS, schedule


def _grid(layer: dict) -> tuple[int, int, int]:
    """(the convolution's output side, the upsampled side, the kept side)."""
    n = layer["in_size"] + layer["conv_kernel"] - 1
    px0, px1, _, _ = layer["padding"]
    up_len = n * layer["up"] + px0 + px1 - layer["up_taps"] + 1
    return n, up_len, layer["out_size"]


def filter_flops(layer: dict) -> int:
    """Multiply-adds (x 2) of one layer's filtered leaky ReLU on one frame."""
    n, u, m = _grid(layer)
    c = layer["out_channels"]
    total = 0
    if layer["up_taps"] > 1:
        per = layer["up_taps"] // layer["up"]
        total += 2 * per * c * (u * n + u * u)
    if layer["down_taps"] > 1:
        total += 2 * layer["down_taps"] * c * (m * u + m * m)
    return total


def synthesis_flops(g: dict) -> int:
    """Operations of one frame of StyleGAN3-T synthesis."""
    inp, layers = schedule(g)
    w_dim = {**DEFAULTS, **g}["w_dim"]
    total = 2 * w_dim * 4 + 2 * inp["channels"] ** 2 * inp["size"] ** 2
    for layer in layers:
        cin, cout, k = layer["in_channels"], layer["out_channels"], layer["conv_kernel"]
        n = layer["in_size"] + k - 1
        total += 2 * w_dim * cin + 2 * cin * cout * k * k * n * n
        if not layer["is_torgb"]:
            total += 2 * cin * cout
        total += filter_flops(layer)
    return total


def filter_least_bytes(g: dict, half_bytes: int = 2) -> list[int]:
    """Each layer's filtered-leaky-ReLU call's least bytes on one frame."""
    _, layers = schedule(g)
    out = []
    for layer in layers:
        n, _, m = _grid(layer)
        item = half_bytes if layer["use_fp16"] else 4
        out.append(layer["out_channels"] * (n * n + m * m) * item)
    return out
