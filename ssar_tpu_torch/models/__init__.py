"""Reactor models (features -> W+ latents + noise), the other model families,
and the extractors.

Re-exports the names that ``ssar_tpu/models/__init__.py`` exports, each the
port's counterpart of the same name.
"""
from .backbones import BACKBONES, ConvNeXtSeq2Seq, MLPSeq2Seq, MultiLayerRNN, S4Backbone, TransformerEncoder
from .hippo import HiPPOTimeseries, encode_leg_s, encode_leg_t, init_leg_s, init_leg_t, transition
from .reactor import (
    EnvelopeReactor,
    FixedLatentNoiseDecoder,
    LatentNoiseReactor,
    LayerwiseLinear,
    LearnedLatentNoiseDecoder,
    Normalize,
)
from .audio2latent import Audio2Latent, Audio2Latent2, LayerwiseConv
from .psagan import ProgressiveDiscriminator, ProgressiveGenerator
from .s4 import S4Block, S4DLayer, s4d_conv, s4d_kernel, s4d_step
from .sashimi import Sashimi
from .selfsupervised import (
    LSTMReactor,
    PatchContrastor,
    StyleVideoDiscriminator,
    StyleVideoGenerator,
    sample_patches_1d,
)
