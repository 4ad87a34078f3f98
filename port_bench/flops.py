"""Operations a frame takes, counted from the configuration's shapes (a
multiply-add counts 2).

Counted: the synthesis convolutions (the up-convolution as a transposed
convolution of the input grid), the 4 x 4 blurs (after each up-convolution
and on each skip upsampling), the style products of every modulated layer
and the demodulation's ``style**2 @ w2`` products, the ``to_rgb`` 1 x 1
convolutions, the mapping network where a system maps latents (amortised
over the frames it serves), and the reactor's GRU and linears where present.
Not counted: elementwise work (modulation and demodulation scales, noise,
bias and leaky ReLU, the I420 packing), which is a few operations a pixel
against hundreds in the convolutions.
"""
from __future__ import annotations


def channels(resolution: int, channel_multiplier: int = 2, max_channels: int = 512) -> dict[int, int]:
    cm = channel_multiplier
    full = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * cm, 128: 128 * cm, 256: 64 * cm, 512: 32 * cm,
            1024: 16 * cm}
    return {r: min(c, max_channels) for r, c in full.items() if r <= resolution}


def synthesis_flops(resolution: int, style_dim: int = 512, channel_multiplier: int = 2,
                    max_channels: int = 512, blur_taps: int = 4) -> int:
    """Operations of one frame of StyleGAN2 synthesis at `resolution`."""
    ch = channels(resolution, channel_multiplier, max_channels)
    blur = blur_taps * blur_taps
    total = 0

    def styled(cin, cout, k, pixels_in, up):
        # style product, demodulation product, the convolution (and its blur)
        ops = 2 * style_dim * cin + 2 * cin * cout + 2 * cin * cout * k * k * pixels_in
        if up:
            ops += 2 * blur * cout * 4 * pixels_in
        return ops

    def rgb(cin, pixels):
        return 2 * style_dim * cin + 2 * cin * 3 * pixels

    total += styled(ch[4], ch[4], 3, 16, False) + rgb(ch[4], 16)
    prev = 4
    for r in sorted(ch)[1:]:
        total += styled(ch[prev], ch[r], 3, prev * prev, True)
        total += styled(ch[r], ch[r], 3, r * r, False)
        total += rgb(ch[r], r * r) + 2 * blur * 3 * r * r   # to_rgb and the skip's upsampling blur
        prev = r
    return total


def mapping_flops(style_dim: int = 512, n_mlp: int = 8) -> int:
    """Operations of one latent through the mapping network."""
    return n_mlp * 2 * style_dim * style_dim


def gru_reactor_flops(n_features: int, hidden: int, num_layers: int) -> int:
    """Operations of one frame through the envelope reactor: the input and
    output linears and `num_layers` GRU layers of width `hidden`."""
    gru = num_layers * 2 * 3 * hidden * (hidden + hidden)
    return 2 * n_features * hidden + gru + 2 * hidden * hidden
