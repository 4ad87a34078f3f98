"""The port's serve path end to end vs the JAX package, small, on the CPU;
and the port's guard rails (no JAX imports, no silent CPU fallback).

Each package runs its own chain on the same waveform, weights and base
noise: audio2features -> LatentNoiseReactor (GRU, fixed decoder with
env_guard_eps, envelope sums kept away from 0) -> StyleGAN2 synthesis
(128 px, float32) -> I420 frames.
Features are held within the docs/PARITY.md budgets; the final 8-bit frames
may differ by at most one level (float32 differences carried through the
chain round differently only at quantisation edges).
"""
import ast
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssar_tpu_torch import examples
from ssar_tpu_torch.audio.features import PARITY_BUDGETS, audio2features
from ssar_tpu_torch.gan import stylegan2 as ts
from ssar_tpu_torch.gan.wrapper import StyleGAN2Synthesizer
from ssar_tpu_torch.generate.audio2video import react, render_reaction
from ssar_tpu_torch.models.reactor import LatentNoiseReactor

j_feat = importlib.import_module("ssar_tpu.audio.features")
j_reactor = importlib.import_module("ssar_tpu.models.reactor")
js = importlib.import_module("ssar_tpu.gan.stylegan2")
j_render = importlib.import_module("ssar_tpu.gan.render")
j_a2v = importlib.import_module("ssar_tpu.generate.audio2video")

ROOT = Path(__file__).resolve().parents[1]
FPS = 24


class _Sink:
    def __init__(self):
        self.frames = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def write_i420(self, frame):
        self.frames.append(np.array(frame))


def test_slice_matches_jax(rng, monkeypatch):
    sr = 44100
    t = np.arange(3 * sr) / sr
    audio = (0.4 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.randn(len(t))).astype(np.float32)
    audio[:: sr // 2] += 1.0

    # features
    F_j = np.asarray(j_feat.audio2features(jnp.asarray(audio), sr, FPS, tuning=0.0))
    F_t = audio2features(audio, sr, FPS, tuning=0.0, device="cpu")
    for group, (cols, budget) in PARITY_BUDGETS.items():
        assert np.abs(F_t.numpy()[:, cols] - F_j[:, cols]).max() <= budget, group
    T = F_j.shape[0]

    # reactor: flax params converted into the port, the same base noise
    H = 4
    cfg = dict(resolution=128, max_channels=16)
    jc, tc = js.StyleGAN2Config(**cfg), ts.StyleGAN2Config(**cfg)
    palette = rng.randn(3 * H, jc.n_latent, 512).astype(np.float32)
    base = [rng.randn(1, T, 2 ** (i + 2), 2 ** (i + 2)).astype(np.float32) for i in range(4)]
    # a floor on the std: near-constant feature columns would magnify the
    # stack's float32 differences into the reactor's input
    mean, std = F_j.mean(0), np.maximum(F_j.std(0), 0.05)
    jm = j_reactor.LatentNoiseReactor(jnp.asarray(mean), jnp.asarray(std), jnp.asarray(palette), backbone="gru",
                                      hidden_size=H, num_layers=2, env_guard_eps=0.1)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        {"params": jax.random.PRNGKey(1), "noise": jax.random.PRNGKey(2)}, jnp.asarray(F_j[None])))
    # lift the palette envelopes: the guard keeps the sign of each split's sum,
    # so a sum crossing 0 flips its latents, and round-off decides the side
    out = variables["params"]["EnvelopeReactor_0"]["Dense_1"]
    out["bias"] = out["bias"] + np.where(np.arange(out["bias"].shape[0]) < 3 * H, 1.0, 0.0).astype(np.float32)
    it = iter(base)
    monkeypatch.setattr(j_reactor, "_smoothed_noise", lambda key, bt, size, sigma=5.0: jnp.asarray(next(it)))
    lat_j, noise_j = jm.apply(variables, jnp.asarray(F_j[None]), rngs={"noise": jax.random.PRNGKey(3)})

    tm = LatentNoiseReactor(mean, std, palette, backbone="gru", hidden_size=H, num_layers=2, env_guard_eps=0.1)
    tm.load_flax(variables)
    monkeypatch.setattr(tm.decoder, "forward", lambda x, base_noise=None, generator=None,
                        _f=tm.decoder.forward: _f(x, base_noise=base))
    lat_t, noise_t = react(tm, F_t)

    # synthesis + I420: the JAX side as its render loop does it, one batch
    p = jax.tree_util.tree_map(np.asarray, js.init_generator(jax.random.PRNGKey(0), jc))
    dup = j_a2v._duplicate_pyramid([np.asarray(n[0])[:, None] for n in noise_j])
    noises = [jnp.transpose(jnp.asarray(n), (0, 2, 3, 1)) for n in dup]
    img = js.synthesis(jax.tree_util.tree_map(jnp.asarray, p), lat_j[0], noises + [None] * (jc.num_layers - 7),
                       jc, s2d=False)
    want = np.asarray(j_render.rgb_to_i420((img + 1.0) / 2.0))

    syn = StyleGAN2Synthesizer(config=tc, dtype=torch.float32, device="cpu", params=ts.params_from_jax(p))
    sink = render_reaction(lat_t, noise_t, output_size=(128, 128), batch_size=16, gan_config=tc,
                           synthesizer=syn, writer=_Sink())
    got = np.stack(sink.frames)
    assert got.shape == want.shape == (T, 192, 128)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# ------------------------------------------------------------ guard rails --
def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_nothing_of_jax():
    files = sorted((ROOT / "ssar_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    names = {str(path.relative_to(ROOT)) for path in files}
    assert {"ssar_tpu_torch/generate/optimize.py", "ssar_tpu_torch/models/hippo.py", "ssar_tpu_torch/audio/segment.py",
            "ssar_tpu_torch/audio/beat_host.py", "ssar_tpu_torch/parallel/features_sp.py",
            "ssar_tpu_torch/gan/convert.py", "ssar_tpu_torch/ops/resize.py", "chip_smoke.py",
            "ssar_tpu_torch/generate/keys.py", "ssar_tpu_torch/generate/audioreactive.py",
            "ssar_tpu_torch/generate/sample.py", "ssar_tpu_torch/generate/interactive.py",
            "ssar_tpu_torch/metrics/rhythmic.py", "ssar_tpu_torch/examples/base_patch.py",
            "ssar_tpu_torch/examples/widescreen_bend_patch.py", "ssar_tpu_torch/metrics/correlation.py",
            "ssar_tpu_torch/metrics/chroma.py", "ssar_tpu_torch/metrics/sectional.py",
            "ssar_tpu_torch/video/features.py", "ssar_tpu_torch/video/flow.py",
            "ssar_tpu_torch/video/visual_beats.py", "ssar_tpu_torch/models/backbones.py",
            "ssar_tpu_torch/models/sashimi.py", "ssar_tpu_torch/models/audio2latent.py",
            "ssar_tpu_torch/models/psagan.py", "ssar_tpu_torch/models/selfsupervised.py",
            "ssar_tpu_torch/gan/discriminator.py", "ssar_tpu_torch/metrics/context_fid.py",
            "ssar_tpu_torch/metrics/ood.py", "ssar_tpu_torch/train/trainers.py",
            "ssar_tpu_torch/train/latent_augmenter.py", "ssar_tpu_torch/train/palette_g.py",
            "ssar_tpu_torch/train/evaluate.py", "ssar_tpu_torch/utils/native.py", "ssar_tpu_torch/utils/plot.py",
            "ssar_tpu_torch/metrics/analysis.py", "ssar_tpu_torch/metrics/preliminary.py",
            "ssar_tpu_torch/metrics/generate.py", "ssar_tpu_torch/metrics/comparison.py",
            "ssar_tpu_torch/metrics/study.py", "ssar_tpu_torch/audio/extra.py", "ssar_tpu_torch/audio/parity.py",
            "ssar_tpu_torch/utils/profiling.py", "ssar_tpu_torch/models/resnet.py",
            "ssar_tpu_torch/models/slowfast_r50.py", "ssar_tpu_torch/models/extractors.py",
            "ssar_tpu_torch/models/convert_extractors.py", "ssar_tpu_torch/gan/psp.py",
            "ssar_tpu_torch/parallel/mesh.py", "ssar_tpu_torch/parallel/synthesis_tp.py",
            "ssar_tpu_torch/parallel/dryrun.py", "ssar_tpu_torch/parallel/launch.py",
            "ssar_tpu_torch/experiments.py", "ssar_tpu_torch/scripts/make_record_dataset.py",
            "ssar_tpu_torch/scripts/train_calibration_g.py", "ssar_tpu_torch/scripts/ood_absolute.py",
            "ssar_tpu_torch/scripts/run_study.py", "ssar_tpu_torch/gan/stylegan3.py",
            "ssar_tpu_torch/ops/filtered_lrelu.py", "ssar_tpu_torch/ops/styled_epilogue.py"} <= names
    # every example of the JAX package has its port, and the check reads it
    ported = examples.PATCHES + examples.SCRIPTS
    assert sorted(p.stem for p in (ROOT / "examples").glob("*.py")) == sorted(ported)
    assert {f"ssar_tpu_torch/examples/{name}.py" for name in ported} <= names
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "ssar_tpu"), f"{path.relative_to(ROOT)} imports {mod}"
            # the pipeline entry points keep their own copies of the root's experiments.py and scripts/
            assert top not in ("experiments", "scripts", "make_record_dataset"), f"{path.relative_to(ROOT)} imports {mod}"


# the names of the JAX package's subpackages that the port does not re-export: Pallas and TPU names (mapped in
# the docstring of the port's ops and utils packages) and metrics' three, which would cycle through models
NOT_REEXPORTED = {
    "ops": {"absdiff_pallas", "absdiff_ref", "sliding_median_lastaxis", "s4d_vandermonde_pallas",
            "s4d_vandermonde_ref"},
    "utils": {"on_tpu", "pallas_interpret"},
    "metrics": {"CausalCNNEncoder", "context_fid", "train_encoder"},
}


@pytest.mark.parametrize("pkg", sorted(p.parent.name for p in (ROOT / "ssar_tpu").glob("*/__init__.py")))
def test_each_subpackage_exports_the_jax_packages_names(pkg):
    """Each subpackage's ``__init__`` exports the names the JAX package's
    exports (C8: ``train`` exported none), less the documented ones, whose
    absence its docstring states."""
    jax_names = [a.asname or a.name for node in ast.parse((ROOT / "ssar_tpu" / pkg / "__init__.py").read_text()).body
                 if isinstance(node, ast.ImportFrom) for a in node.names]
    port = importlib.import_module(f"ssar_tpu_torch.{pkg}")
    left_out = NOT_REEXPORTED.get(pkg, set())
    assert left_out <= set(jax_names)
    missing = [n for n in jax_names if n not in left_out and not hasattr(port, n)]
    assert not missing, f"ssar_tpu_torch.{pkg} lacks {missing}"
    assert all(n in port.__doc__ for n in left_out)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        audio2features(np.zeros(24576, np.float32), 24576, FPS)
    with pytest.raises(RuntimeError, match="CUDA"):
        StyleGAN2Synthesizer(config=ts.StyleGAN2Config(resolution=8, max_channels=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        audio2features(np.zeros(24576, np.float32), 24576, FPS, device="cuda")
