"""The ported example patches that load another patch by path, and those
with animated or layer-0 bends, against the JAX package's originals through
``render_patch``, small, on the CPU (tests/torch_examples.py for the
tolerances); and fault C5, ``set_bends`` taking a modulation that is a
tensor.

Frames of a bent patch are compared with its own noise: ``shella`` and
``reflexangle`` hand double-width fields to the levels after their layer-0
pad, and ``scrolling_drop``'s roll is compared at the two frames it moves
most.
"""
import numpy as np
import pytest
import torch

from ssar_tpu_torch import examples
from ssar_tpu_torch.generate import audioreactive as t_ar
from torch_examples import AUDIO, FPS, SR, T, jax_draws, run_example, synths  # noqa: F401  (fixtures)
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

BENDS = ["mirage_inherited_patch", "reflexangle_patch", "scrolling_drop_patch", "shella_patch", "tvgf_patch"]


@pytest.mark.parametrize("name", BENDS)
def test_bend_examples_match_jax(jax_draws, synths, rng, monkeypatch, name):
    run_example(name, synths, rng, monkeypatch)


def test_scroll_bend_rolls_each_sample_along_width(rng):
    """The port's NCHW roll is JAX's per-sample ``jnp.roll`` of NHWC axis 1
    (W), with the shift truncated toward zero."""
    import jax.numpy as jnp

    mod = t_ar.load_patch_module(examples.path("scrolling_drop_patch"))
    x = rng.randn(3, 2, 4, 10).astype(np.float32)
    frac = np.array([0.0, 0.37, 0.999], np.float32)
    shift = (frac * 10).astype(np.int32)
    want = np.stack([np.asarray(jnp.roll(jnp.asarray(xi.transpose(1, 2, 0)), s, axis=1)) for xi, s in zip(x, shift)])
    got = mod.scroll(torch.as_tensor(x), torch.as_tensor(frac))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    np.testing.assert_array_equal(mod.scroll_shift(torch.as_tensor(frac), 10).numpy(), shift)


@pytest.mark.parametrize("kind", ["cpu tensor", "requires grad"])
def test_set_bends_takes_tensor_modulations(synths, kind):
    """C5: a modulation given as a CPU tensor, or as one that requires grad,
    renders what the numpy modulation renders."""
    _, tsyn = synths
    mod = t_ar.load_patch_module(examples.path("scrolling_drop_patch"))
    frac = np.linspace(0, 0.9, T).astype(np.float32)
    lat = torch.as_tensor(np.random.RandomState(3).randn(2, tsyn.config.n_latent, 512).astype(np.float32))
    fi = torch.tensor([10, 40])
    tsyn.set_bends([{"layer": 2, "transform": mod.scroll, "modulation": frac}])
    want = tsyn(lat, frame_idx=fi)
    given = torch.as_tensor(frac) if kind == "cpu tensor" else torch.as_tensor(frac).requires_grad_()
    tsyn.set_bends([{"layer": 2, "transform": mod.scroll, "modulation": given}])
    got = tsyn(lat, frame_idx=fi)
    tsyn.set_bends({})
    assert torch.equal(got, want)
