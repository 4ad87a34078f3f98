"""The ported example patches of plain envelopes and loops
(``ssar_tpu_torch/examples/``) against the JAX package's ``examples/``,
through ``render_patch``, small, on the CPU: the same track, palette and
32 px weights in both, JAX's draws in ``keys`` (tests/torch_examples.py for
the tolerances).

``section_scene_switch`` reads the CQT segmentation's hard labels, which
flip on round-off: on this track both packages label alike.
"""
import pytest

from torch_examples import jax_draws, run_example, synths  # noqa: F401  (fixtures)
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

PLAIN = ["chroma_expand_color_patch", "addnoise_bend_patch", "multiband_depth_patch", "drum_reactive_patch",
         "pitch_melody_patch", "tracklist_palettes_patch", "section_scene_switch", "intro_drop_crossfade_patch",
         "timed_drops_patch", "cosmictuba_noise_patch", "spatial_mask_noise_patch"]


@pytest.mark.parametrize("name", PLAIN)
def test_plain_examples_match_jax(jax_draws, synths, rng, monkeypatch, name):
    run_example(name, synths, rng, monkeypatch)
