"""Generation: the serve path, test-time optimization and the random-patch system."""
from .latent import latent_patch, natural_cubic_spline, spline_loop_latents
from .mir import ALLFEATS, UNITFEATS, retrieve_music_information, salience_weighted
from .noise import Average, Blend, Loop, Modulate, Multiply, Noise, ScaleBias, noise_patch
from .patch import Patch
from . import audioreactive
from .audioreactive import RandomPatch, load_patch_module, render_patch
