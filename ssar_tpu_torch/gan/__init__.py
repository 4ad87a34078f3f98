"""StyleGAN2 synthesis, rendering, video output, the discriminator and pSp.

Re-exports the names that ``ssar_tpu/gan/__init__.py`` exports, each the
port's counterpart of the same name.
"""
from .discriminator import Discriminator, PSPEncoder
from .psp import (backbone_encoder_w, backbone_encoder_wplus, convert_psp,
                  gradual_style_encoder, invert_frames, psp_apply)
from .stylegan2 import StyleGAN2Config, generate, init_generator, mapping, synthesis, w_to_wplus
from .video_io import VideoWriter, write_video
from .wrapper import StyleGAN2, StyleGAN2Mapper, StyleGAN2Synthesizer, make_noise_pyramid
