"""Parity of the port's configuration tree and checkpoint evaluation
(``ssar_tpu_torch/utils/config.py``, ``ssar_tpu_torch/train/evaluate.py``)
with the JAX package's, on the CPU.

Tolerances: ``Config`` dicts, overrides and run names are equal; a
checkpoint loaded back gives the trained model's output exactly
(``torch.equal``) and its stored palette equals the trainer's rebuild exactly;
``feature_sensitivity`` is within 1e-4 of the largest JAX delta (float32
reactor forwards, the same weights, base noise and permutations).
"""
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssar_tpu_torch.gan.stylegan2 import StyleGAN2Config
from ssar_tpu_torch.generate import keys
from ssar_tpu_torch.train import evaluate as t_eval
from ssar_tpu_torch.train import train as t_train
from ssar_tpu_torch.utils import config as t_config
from torch_parity import close, jax_keys, one_torch_thread  # noqa: F401

j_config = importlib.import_module("ssar_tpu.utils.config")
j_eval = importlib.import_module("ssar_tpu.train.evaluate")
j_reactor = importlib.import_module("ssar_tpu.models.reactor")

_OVERRIDES = [
    ["train.lr=3e-4", "model.backbone=sashimi"],
    ["--model.residual=true", "model.hidden_size=32", "train.cache_dir=none", "gan.model_file=null"],
    ["model.dropout=0.25", "audio.clamp=0", "train.out_dir=/tmp/x", "gan.output_size=(1,2)"],
    ["model.residual=yes", "train.n_examples=64", "model.decoder=fixed"],
]


@pytest.mark.parametrize("overrides", _OVERRIDES)
def test_config_overrides_and_run_name_match_jax(overrides):
    got = t_config.Config().apply_overrides(list(overrides))
    want = j_config.Config().apply_overrides(list(overrides))
    assert got.to_dict() == want.to_dict()
    assert got.run_name() == want.run_name()


def test_config_round_trip_and_bad_keys_match_jax(tmp_path):
    d = j_config.Config().apply_overrides(["train.lr=1e-3", "model.num_layers=2"]).to_dict()
    d["gan"]["output_size"] = [512, 256]
    d["model"]["not_a_field"] = 1
    got, want = t_config.Config.from_dict(d), j_config.Config.from_dict(d)
    assert got.to_dict() == want.to_dict() and got.gan.output_size == want.gan.output_size == [512, 256]
    got.save(str(tmp_path / "c.json"))
    assert t_config.Config.load(str(tmp_path / "c.json")).to_dict() == want.to_dict()
    assert json.loads((tmp_path / "c.json").read_text()) == json.loads(json.dumps(want.to_dict()))
    for bad in (["model.nope=1"], ["nope.lr=1"]):
        with pytest.raises(AttributeError):
            j_config.Config().apply_overrides(bad)
        with pytest.raises(AttributeError):
            t_config.Config().apply_overrides(bad)
    with pytest.raises(ValueError):
        t_config.Config().apply_overrides(["train.lr=fast"])
    with pytest.raises(ValueError):
        j_config.Config().apply_overrides(["train.lr=fast"])


# ------------------------------------------------------------- checkpoints --
_RUN = ["--decoder", "fixed", "--backbone", "gru", "--loss", "ssabsdiff", "--hidden_size", "8", "--num_layers", "1",
        "--duration", "1", "--batch_size", "8", "--n_examples", "16", "--eval_every", "8", "--ckpt_every", "8",
        "--dropout", "0.1", "--no-render_at_ckpt", "--no-fcd", "--device", "cpu"]


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    log_dir, _ = t_train.main(_RUN + ["--out_dir", str(tmp_path_factory.mktemp("runs"))])
    return log_dir


def test_load_checkpoint_reproduces_the_trained_model(tiny_run):
    args = t_train.build_parser().parse_args(_RUN)
    state = torch.load(t_train._latest_checkpoint(tiny_run), weights_only=True)["params"]
    trained = t_train.make_model(args, np.load(tiny_run / "input_mean.npy"), np.load(tiny_run / "input_std.npy"),
                                 state["decoder.latents"])
    trained.load_state_dict(state)
    trained.eval()
    model, cfg = t_eval.load_checkpoint(str(tiny_run), device="cpu")
    assert cfg is None   # the trainer's flat flag dump, as in the JAX package
    assert not model.training and model.envelopes.backbone.dropout == 0.1   # every stored flag holds
    x = torch.as_tensor(np.random.RandomState(0).randn(2, 24, 59).astype(np.float32))
    lat_a, noise_a = trained(x, generator=torch.Generator().manual_seed(5))
    lat_b, noise_b = model(x, generator=torch.Generator().manual_seed(5))
    assert torch.equal(lat_a, lat_b) and all(torch.equal(a, b) for a, b in zip(noise_a, noise_b))
    assert t_eval.checkpoint_steps(tiny_run) == [8, 16]
    early, _ = t_eval.load_checkpoint(str(tiny_run), step=8, device="cpu")
    assert not torch.equal(early.envelopes.inp.weight, model.envelopes.inp.weight)


def test_stored_palette_equals_the_rebuild(tiny_run):
    """The palette is a buffer of the checkpoint; it equals what the JAX
    package's ``load_checkpoint`` rebuilds: the mapper of seed 0 over
    RandomState(42) z's."""
    from ssar_tpu_torch.gan.wrapper import StyleGAN2Mapper

    model, _ = t_eval.load_checkpoint(str(tiny_run), device="cpu")
    z = np.random.RandomState(42).randn(3 * 8, 512).astype(np.float32)
    assert torch.equal(model.decoder.latents, StyleGAN2Mapper(seed=0, device="cpu")(z))


def test_load_checkpoint_sectioned_config_and_stored_normalisation(tiny_run, tmp_path):
    import shutil

    run = tmp_path / "run"
    shutil.copytree(tiny_run, run)
    (run / "input_mean.npy").unlink()
    (run / "input_std.npy").unlink()
    cfg = t_config.Config().apply_overrides(["model.decoder=fixed", "model.backbone=gru", "model.hidden_size=8",
                                             "model.num_layers=1"])
    cfg.save(str(run / "config.json"))
    model, got = t_eval.load_checkpoint(str(run), device="cpu")
    assert got.to_dict() == cfg.to_dict()
    # the normalisation is a buffer of the checkpoint: the run's own statistics, not the identity
    for name in ("mean", "std"):
        stored = torch.as_tensor(np.load(tiny_run / f"input_{name}.npy"), dtype=torch.float32)
        assert torch.equal(getattr(model.envelopes.normalize, name), stored)


def test_generate_longform_and_data_split_on_the_cpu(tiny_run, tmp_path):
    from ssar_tpu_torch.gan.stylegan2 import StyleGAN2Config
    from ssar_tpu_torch.train.data import synthetic_dataset

    class Sink:
        frames = 0

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def write_i420(self, frame):
            Sink.frames += 1

    sr = 24 * 1024
    audio = np.random.RandomState(1).randn(sr).astype(np.float32) * 0.1
    cfg = StyleGAN2Config(resolution=32, max_channels=16)
    t_eval.generate_longform(str(tiny_run), audio, sr, gan_config=cfg, output_size=(32, 32), device="cpu",
                             writer=Sink())
    assert Sink.frames == 24
    outs = t_eval.generate_by_data_split(str(tiny_run), synthetic_dataset(n_windows=2, n_frames=12), str(tmp_path),
                                         gan_config=cfg, output_size=(32, 32), device="cpu")
    assert [w.frames_written for w in outs] == [12, 12]
    assert all((tmp_path / f"split_render_{i}.mp4").stat().st_size > 0 for i in range(2))


def test_evaluate_raises_without_cuda(monkeypatch, tiny_run):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_eval.load_checkpoint(str(tiny_run))


# -------------------------------------------------------- feature sensitivity --
def test_feature_sensitivity_matches_jax(monkeypatch):
    """The same flax weights in both packages, JAX's base noise injected into
    both and JAX's permutations into ``keys``."""
    jax_keys(monkeypatch)
    rng = np.random.RandomState(3)
    T, H = 16, 8
    feats = rng.randn(T, 59).astype(np.float32)
    mean, std = feats.mean(0), feats.std(0) + 0.1
    palette = rng.randn(3 * H, 18, 512).astype(np.float32)
    base = {2 ** (i + 2): rng.randn(1, T, 2 ** (i + 2), 2 ** (i + 2)).astype(np.float32) for i in range(4)}
    jm = j_reactor.LatentNoiseReactor(jnp.asarray(mean), jnp.asarray(std), jnp.asarray(palette), backbone="gru",
                                      hidden_size=H, num_layers=1, env_guard_eps=0.1)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        {"params": jax.random.PRNGKey(1), "noise": jax.random.PRNGKey(2)}, jnp.asarray(feats[None])))
    # lift the palette envelopes away from a sum of zero (the guard's sign flip is round-off's choice)
    out = variables["params"]["EnvelopeReactor_0"]["Dense_1"]
    out["bias"] = out["bias"] + np.where(np.arange(out["bias"].shape[0]) < 3 * H, 1.0, 0.0).astype(np.float32)
    monkeypatch.setattr(j_reactor, "_smoothed_noise", lambda key, bt, size, sigma=5.0: jnp.asarray(base[size]))
    want = j_eval.feature_sensitivity(jm, variables, jnp.asarray(feats), seed=4)

    tm = t_train.LatentNoiseReactor(mean, std, palette, backbone="gru", hidden_size=H, num_layers=1,
                                    env_guard_eps=0.1)
    tm.load_flax(variables)
    monkeypatch.setattr(tm.decoder, "forward", lambda x, base_noise=None, generator=None, _f=tm.decoder.forward:
                        _f(x, base_noise=[base[2 ** (i + 2)] for i in range(4)]))
    got = t_eval.feature_sensitivity(tm, torch.as_tensor(feats), seed=4)
    assert list(got) == list(want) and len(got) == 59 * 4
    close(np.array(list(got.values())), np.array(list(want.values())), 1e-4, "deltas")
    assert min(want.values()) > 0


def test_perturbations_match_jax(monkeypatch):
    jax_keys(monkeypatch)
    col = np.random.RandomState(5).randn(20).astype(np.float32)
    for name, fn in j_eval.PERTURBATIONS.items():
        want = np.asarray(fn(jnp.asarray(col), jax.random.PRNGKey(9)))
        got = t_eval.PERTURBATIONS[name](torch.as_tensor(col), keys.PRNGKey(9))
        assert np.array_equal(got.numpy(), want), name


# --------------------------------------------- the comparison's checkpoint sweep --
_AUDIO = (0.3 * np.sin(2 * np.pi * 220.0 * np.arange(24 * 1024) / (24 * 1024))).astype(np.float32)


def test_evaluate_trained_checkpoint_dirs_on_a_port_run(monkeypatch, tmp_path):
    """``metrics.comparison.evaluate_trained_checkpoint_dirs`` over two
    checkpoints of a tiny port run: each rebuilt and predicting (the scoring
    is ``evaluate_clip``'s, tests/test_torch_study.py), with the run's flags
    in the records."""
    from ssar_tpu_torch.gan.wrapper import StyleGAN2
    from ssar_tpu_torch.metrics import comparison as t_cmp

    tG = StyleGAN2(config=StyleGAN2Config(resolution=16, max_channels=16), dtype=torch.float32, device="cpu")
    seen = []

    def predict_only(G, predictor, audio, sr):
        latents, _ = predictor.predict(audio, sr)
        seen.append(latents)
        return {"correlation": float(latents.std())}

    monkeypatch.setattr(t_cmp, "evaluate_clip", predict_only)
    flags = ["--decoder", "learned", "--backbone", "gru", "--loss", "supervised", "--hidden_size", "4",
             "--num_layers", "1", "--duration", "1", "--batch_size", "8", "--n_examples", "24", "--ckpt_every", "8",
             "--eval_every", "100000", "--no-render_at_ckpt", "--no-fcd", "--device", "cpu"]
    run, _ = t_train.main(flags + ["--out_dir", str(tmp_path / "runs")])
    records = t_cmp.evaluate_trained_checkpoint_dirs([run], "ckpts", [("clip0", _AUDIO, 24 * 1024)], tG, n_ckpts=2,
                                                     out_dir=str(tmp_path))
    assert [r["steps"] for r in records] == [8, 24]
    assert all(r["backbone"] == "gru" and r["decoder"] == "learned" and np.isfinite(r["correlation"])
               for r in records)
    assert len(seen) == 2 and seen[0].shape == (len(_AUDIO) // 1024, 18, 512) and not torch.equal(seen[0], seen[1])
