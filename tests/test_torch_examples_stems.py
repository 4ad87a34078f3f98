"""The ported stem patches and the two example scripts against the JAX
package's originals, small, on the CPU.

Stem patches run on the bare mix and with stems written to ``tmp_path``
(``chip_smoke.write_stems``: band-passed copies of the track at twice its
sample rate, so each envelope takes its stem's own rate), through
``render_patch``
(tests/torch_examples.py for the tolerances).  ``six_stem_modulation`` and
``stem_separated`` key latents by the chromagram's argmax and read the CQT
segmentation's labels, which flip on round-off: on this track and its stems
both packages choose alike.

The scripts run their ``main`` at ``--resolution 32`` on one .npz of
weights in both packages, on their own synthetic demo track, with
``render_latents_to_video`` replaced by a recorder: the latents and the
noise pyramid they would render, within 1e-3 (JAX's draws in ``keys``).
"""
import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from ssar_tpu_torch import examples
from ssar_tpu_torch.generate import audioreactive as t_ar
from torch_examples import ROOT, SR, close, j_ar, jax_draws, run_example, synths  # noqa: F401  (fixtures)
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

BARE = ["six_stem_modulation_patch", "stem_separated_patch"]


@pytest.mark.parametrize("name", BARE)
def test_stem_examples_match_jax_on_the_mix(jax_draws, synths, rng, monkeypatch, name):
    run_example(name, synths, rng, monkeypatch)


@pytest.mark.parametrize("name", sorted(examples.STEMS))
def test_stem_examples_match_jax_with_stems(jax_draws, synths, rng, monkeypatch, tmp_path, name):
    """With the stems the patch reads beside the mix: the same as JAX, and
    the port read every one of them."""
    read, load = [], t_ar.load_audio
    monkeypatch.setattr(t_ar, "load_audio", lambda path, *a, **kw: read.append(Path(path).stem) or load(path, *a, **kw))
    stems = chip_smoke.write_stems(tmp_path / "mix.wav", chip_smoke.two_part_track(2 * SR), 2 * SR)
    run_example(name, synths, rng, monkeypatch, audio_file=stems)
    assert sorted(read) == sorted(examples.STEMS[name])


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A random full-width 32 px StyleGAN2 as an .npz both packages load."""
    js = importlib.import_module("ssar_tpu.gan.stylegan2")
    j_convert = importlib.import_module("ssar_tpu.gan.convert")
    path = tmp_path_factory.mktemp("g") / "g32.npz"
    params = js.init_generator(jax.random.PRNGKey(0), js.StyleGAN2Config(resolution=32))
    j_convert.save_npz(str(path), jax.tree_util.tree_map(np.asarray, params))
    return str(path)


@pytest.mark.parametrize("name", examples.SCRIPTS)
def test_example_scripts_match_jax(jax_draws, monkeypatch, weights, tmp_path, name):
    j_mod = j_ar.load_patch_module(str(ROOT / "examples" / f"{name}.py"))
    t_mod = importlib.import_module(f"ssar_tpu_torch.examples.{name}")
    rendered = {}
    for tag, mod in (("jax", j_mod), ("port", t_mod)):
        monkeypatch.setattr(mod, "render_latents_to_video", lambda syn, latents, noises, out, tag=tag, **kw:
                            rendered.setdefault(tag, (latents, noises)))
    flags = ["--resolution", "32", "--model_file", weights, "--out", str(tmp_path / "out.mp4")]
    monkeypatch.setattr(sys, "argv", [name, *flags])
    j_mod.main()
    t_mod.main([*flags, "--device", "cpu"])
    (lat_j, noise_j), (lat_t, noise_t) = rendered["jax"], rendered["port"]
    assert tuple(lat_t.shape) == lat_j.shape == (6 * 24, 8, 512)
    close(lat_t, lat_j, 1e-3, 1e-3)
    assert len(noise_t) == len(noise_j) == 7
    for a, b in zip(noise_t, noise_j):
        assert tuple(a.shape) == np.shape(b)
        close(a, jnp.asarray(b), 1e-3, 1e-3)
