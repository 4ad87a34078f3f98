"""The extractors against the JAX package on the CPU: the ResNet-50 trunk and
``swav_extractor``, SlowFast R50 and its per-layer extractor, VGGish with
its log-mel front end, ``SlowFastVideo``, ``synchro_saliency``, and the
weight loaders of ``models/convert_extractors.py``.

Each network gets the same weights in both packages: the JAX package's tree
carried across by ``from_flax_*``, or an upstream-layout ``state_dict``
built here (the JAX tests' own helpers) loaded into the port as it is and
into JAX through its converter.  BatchNorm statistics are perturbed so that
they take part.  The fp32 networks are held within 1e-4 of the largest
reference value at the JAX tests' small configurations (ResNet-50 at narrow
widths, SlowFast R50 ``TINY``); the full-width cases are marked ``slow``,
as the JAX package marks its own.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssar_tpu_torch.models import convert_extractors as tc
from ssar_tpu_torch.models import extractors as tx
from ssar_tpu_torch.models import resnet as tr
from ssar_tpu_torch.models import slowfast_r50 as tsf
from test_slowfast import TINY as J_TINY
from test_slowfast import _build_torch_sd as slowfast_upstream_sd
from torch_parity import close, np_tree, one_torch_thread  # noqa: F401

jc = importlib.import_module("ssar_tpu.models.convert_extractors")
jx = importlib.import_module("ssar_tpu.models.extractors")
jr = importlib.import_module("ssar_tpu.models.resnet")
jsf = importlib.import_module("ssar_tpu.models.slowfast_r50")

NARROW = (4, 8, 8, 16)
TINY = tsf.SlowFastConfig(**{f: getattr(J_TINY, f) for f in J_TINY.__dataclass_fields__})


def _perturb_bn(tree, rng):
    """Random BN statistics and affines in a JAX-layout tree (in place)."""
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) == {"scale", "bias", "mean", "var"}:
            c = v["scale"].shape
            tree[k] = {"scale": (1 + 0.1 * rng.randn(*c)).astype(np.float32),
                       "bias": (0.1 * rng.randn(*c)).astype(np.float32),
                       "mean": (0.1 * rng.randn(*c)).astype(np.float32),
                       "var": (1 + 0.1 * np.abs(rng.randn(*c))).astype(np.float32)}
        elif isinstance(v, dict):
            _perturb_bn(v, rng)
    return tree


def _roundtrip(tree, tmp_path, name):
    tc.save_converted(tree, str(tmp_path / f"{name}.npz"))
    return tc.load_converted(str(tmp_path / f"{name}.npz"))


def _assert_state_dicts_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------- ResNet-50 --
def test_resnet50_narrow_matches_jax_and_loads_upstream(rng, tmp_path):
    tree = _perturb_bn(tr.init_random_tree(widths=NARROW), rng)
    x = rng.rand(2, 40, 40, 3).astype(np.float32)
    want = np.asarray(jr.resnet50_features(tree, jnp.asarray(x)))

    model = tr.ResNet50(NARROW)
    model.load_state_dict(tc.from_flax_resnet50(tree))
    got = tr.resnet50_features(model, torch.as_tensor(x))
    assert got.shape == want.shape == (2, 64)
    close(got, want, 1e-4, "resnet50 narrow")

    # the tree through the .npz round trip carries the same weights
    _assert_state_dicts_equal(tc.from_flax_resnet50(_roundtrip(tree, tmp_path, "r50")), tc.from_flax_resnet50(tree))
    # an upstream SwAV-style state dict (module. prefix, fc and heads) loads as it is
    upstream = {f"module.{k}": v for k, v in model.state_dict().items()}
    upstream |= {"module.fc.weight": torch.zeros(10, 64), "module.projection_head.0.weight": torch.zeros(3, 3),
                 "module.prototypes.weight": torch.zeros(3, 3)}
    close(tr.resnet50_features(tc.load_resnet50(upstream), torch.as_tensor(x)), want, 1e-4, "resnet50 upstream")


def test_swav_extractor_matches_jax(rng):
    tree = _perturb_bn(tr.init_random_tree(widths=NARROW), rng)
    model = tr.ResNet50(NARROW)
    model.load_state_dict(tc.from_flax_resnet50(tree))
    images = rng.rand(5, 45, 45, 3).astype(np.float32)
    want = np.asarray(jr.swav_extractor(tree, resize_to=32, batch_size=2)(jnp.asarray(images)))
    got = tr.swav_extractor(model, resize_to=32, batch_size=2)(torch.as_tensor(images))
    assert got.shape == want.shape == (5, 64)
    close(got, want, 1e-4, "swav_extractor")


def test_resnet50_init_draws_the_jax_weights():
    want = tc.from_flax_resnet50(jr.init_random_params())
    model = tr.init_random_params()
    assert not model.training and len(want) == 5 * 53
    assert all(torch.equal(model.state_dict()[k], v) for k, v in want.items())


@pytest.mark.slow
def test_resnet50_full_width_matches_jax(rng):
    tree = _perturb_bn(jr.init_random_params(), rng)
    x = rng.rand(1, 64, 64, 3).astype(np.float32)
    want = np.asarray(jr.resnet50_features(tree, jnp.asarray(x)))
    model = tr.ResNet50()
    model.load_state_dict(tc.from_flax_resnet50(tree))
    close(tr.resnet50_features(model, torch.as_tensor(x)), want, 1e-4, "resnet50 full width")


# ------------------------------------------------------------ SlowFast R50 --
def _slowfast_input(rng, B=2, T=8, H=32):
    x = (rng.rand(B, T, H, H, 3) * 2 - 1).astype(np.float32)
    fast = torch.as_tensor(np.transpose(x, (0, 4, 1, 2, 3)))
    return x, fast[:, :, :: TINY.alpha], fast


def test_slowfast_r50_tiny_matches_jax(rng, tmp_path):
    tree = _perturb_bn(np_tree(jsf.init_random_params(3, J_TINY)), rng)
    x, slow, fast = _slowfast_input(rng)
    want = jax.jit(jsf.slowfast_features, static_argnums=3)(tree, jnp.asarray(x[:, :: TINY.alpha]), jnp.asarray(x),
                                                            J_TINY)
    model = tsf.SlowFastR50(TINY)
    model.load_state_dict(tc.from_flax_slowfast_r50(_roundtrip(tree, tmp_path, "sf")))
    got = tsf.slowfast_features(model, slow, fast)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert [g.shape[-1] for g in got] == TINY.feature_dims()
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, np.asarray(w), 1e-4, f"slowfast_r50 level {i}")
    close(tsf.slowfast_embed(model, slow, fast), np.asarray(want[-1]).mean(1), 1e-4, "slowfast_embed")


def test_slowfast_r50_loads_a_facebook_checkpoint(rng):
    sd = slowfast_upstream_sd(J_TINY)
    want = jsf.slowfast_features(jc.convert_slowfast_r50({k: v.numpy() for k, v in sd.items()}),
                                 *(jnp.asarray(a) for a in (_slowfast_input(rng)[0][:, :: TINY.alpha],
                                                            _slowfast_input(np.random.RandomState(42))[0])), J_TINY)
    ckpt = {"model_state": {f"module.{k}": v for k, v in sd.items()}
            | {"module.head.projection.weight": torch.zeros(400, 2304)}}
    model = tc.load_slowfast_r50(ckpt, alpha=TINY.alpha)
    assert model.config == TINY
    _, slow, fast = _slowfast_input(np.random.RandomState(42))
    for g, w in zip(tsf.slowfast_features(model, slow, fast), want):
        close(g, np.asarray(w), 1e-4, "slowfast_r50 from a facebook state_dict")


def test_slowfast_r50_extractor_matches_jax(rng):
    tree = jsf.init_random_params(0, J_TINY)
    for T in (20, 5):  # two clips and a rest; a short clip tiled to one
        video = rng.rand(T, 3, 32, 32).astype(np.float32)
        want = jsf.SlowFastR50Extractor(params=tree, config=J_TINY, clip_len=8)(video)
        got = tsf.SlowFastR50Extractor(config=TINY, clip_len=8, device="cpu")(video)
        assert len(got) == 5
        for g, w in zip(got, want):
            close(g, np.asarray(w), 1e-4, f"SlowFastR50Extractor T={T}")


@pytest.mark.slow
def test_slowfast_r50_full_width_matches_jax(rng):
    cfg = tsf.SlowFastConfig()
    tree = _perturb_bn(np_tree(jsf.init_random_params(0, jsf.SlowFastConfig())), rng)
    x, slow, fast = _slowfast_input(rng, B=1, T=32, H=64)
    want = jsf.slowfast_features(tree, jnp.asarray(x[:, :: cfg.alpha]), jnp.asarray(x), jsf.SlowFastConfig())
    model = tsf.init_random_params(0, cfg)
    model.load_state_dict(tc.from_flax_slowfast_r50(tree))
    got = tsf.slowfast_features(model, slow, fast)
    assert [g.shape[-1] for g in got] == [88, 352, 704, 1408, 2304]
    for g, w in zip(got, want):
        close(g, np.asarray(w), 1e-4, "slowfast_r50 full width")


# ------------------------------------------------------- VGGish, SlowFastVideo --
def _vggish_tree(seed: int = 0) -> dict:
    """A VGGish flax tree of numpy weights at its one (full) width, fan-in scaled."""
    rng = np.random.default_rng(seed)
    p, cin = {}, 1
    for i, co in enumerate([64, 128, 256, 256, 512, 512]):
        p[f"Conv_{i}"] = {"kernel": rng.standard_normal((3, 3, cin, co), np.float32) / np.float32(np.sqrt(9 * cin)),
                          "bias": 0.05 * rng.standard_normal(co, np.float32)}
        cin = co
    for j, (di, do) in enumerate([(512 * 24, 4096), (4096, 4096), (4096, 128)]):
        p[f"Dense_{j}"] = {"kernel": rng.standard_normal((di, do), np.float32) / np.float32(np.sqrt(di)),
                           "bias": 0.05 * rng.standard_normal(do, np.float32)}
    return {"params": p}


def test_vggish_matches_jax_and_converts(rng, tmp_path):
    tree = _vggish_tree()
    sd = tc.from_flax_vggish(tree)
    _assert_state_dicts_equal(tc.from_flax_vggish(_roundtrip(tree, tmp_path, "vggish")), sd)
    # the JAX converter's torch layout, converted forward by JAX and back by the port, is unchanged
    _assert_state_dicts_equal(tc.from_flax_vggish(jc.convert_vggish({k: v.numpy() for k, v in sd.items()})), sd)
    model = tc.load_vggish(sd)   # a torchvggish state_dict loads as it is
    audio = (0.3 * rng.randn(24576 * 2)).astype(np.float32)

    want_mel = np.asarray(jx.vggish_log_mel(jnp.asarray(audio[:16000 * 2])))
    got_mel = tx.vggish_log_mel(torch.as_tensor(audio[:16000 * 2]))
    assert want_mel.shape == (2, 96, 64)
    close(got_mel, want_mel, 1e-5, "vggish_log_mel")

    want = np.asarray(jx.VggishExtractor(params=tree)(audio, 24576))
    got = tx.VggishExtractor(model, device="cpu")(audio, 24576)
    assert want.shape == (2, 128)
    close(got, want, 1e-4, "VggishExtractor at 24576 Hz")


def _slowfast_video_tree():
    from torch_parity import init

    return init(jx.SlowFastVideo(), np.zeros((1, 16, 32, 32, 3), np.float32))


def test_slowfast_video_matches_jax(rng, tmp_path):
    tree = _slowfast_video_tree()
    sd = tc.from_flax_slowfast(_roundtrip(tree, tmp_path, "sfv"))
    _assert_state_dicts_equal(tc.from_flax_slowfast(jc.convert_slowfast({k: v.numpy() for k, v in sd.items()})), sd)
    video = rng.rand(37, 3, 34, 30).astype(np.float32)   # odd sizes: SAME pads the extra pixel at the end
    want = np.asarray(jx.SlowFastExtractor(params=tree)(video))
    got = tx.SlowFastExtractor(tc.load_slowfast(sd), device="cpu")(video)
    assert want.shape == (2, 256)
    close(got, want, 1e-4, "SlowFastExtractor")
    close(tx.SlowFastExtractor(tc.load_slowfast(sd), device="cpu")(np.transpose(video, (0, 2, 3, 1))), want, 1e-4)


def test_synchro_saliency_matches_jax(rng, monkeypatch):
    """Both packages' extractors get the same weights: JAX's through flax's
    ``init`` (replaced, as its eager init of SlowFastVideo takes 16 s), the
    port's through its seams."""
    sr, fps = 16000, 24
    audio = (0.3 * rng.randn(sr * 3)).astype(np.float32)
    video = rng.rand(48, 3, 32, 32).astype(np.float32)
    vgg_tree, sfv = _vggish_tree(2), _slowfast_video_tree()
    monkeypatch.setattr(jx.VGGish, "init", lambda self, key, x: vgg_tree)
    monkeypatch.setattr(jx.SlowFastVideo, "init", lambda self, key, x: sfv)
    want = np.asarray(jx.synchro_saliency(audio, sr, video, fps, seed=0))
    monkeypatch.setattr(tx, "random_vggish", lambda seed: tc.load_vggish(tc.from_flax_vggish(vgg_tree)))
    monkeypatch.setattr(tx, "random_slowfast_video", lambda seed: tc.load_slowfast(tc.from_flax_slowfast(sfv)))
    got = tx.synchro_saliency(audio, sr, video, fps, seed=0, device="cpu")
    assert want.shape == (3,)
    close(got, want, 1e-4, "synchro_saliency")


# ----------------------------------------------------------- CLI, entry points --
def test_convert_cli_writes_the_port_state_dict(tmp_path):
    tree = _slowfast_video_tree()
    jc.save_converted(tree, str(tmp_path / "sfv.npz"))
    tc.main([str(tmp_path / "sfv.npz"), str(tmp_path / "sfv.pt"), "--arch", "slowfast"])
    _assert_state_dicts_equal(torch.load(tmp_path / "sfv.pt"), tc.from_flax_slowfast(tree))

    sd = slowfast_upstream_sd(J_TINY)
    torch.save({"model_state": sd}, tmp_path / "sf.pyth")
    tc.main([str(tmp_path / "sf.pyth"), str(tmp_path / "sf.pt"), "--arch", "slowfast_r50"])
    got = torch.load(tmp_path / "sf.pt")
    assert all(torch.equal(got[k], v) for k, v in sd.items())


def test_extractor_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tx.VggishExtractor(tx.VGGish()), lambda: tx.SlowFastExtractor(tx.SlowFastVideo()),
                 lambda: tsf.SlowFastR50Extractor(tsf.SlowFastR50(TINY), config=TINY),
                 lambda: tx.synchro_saliency(np.zeros(16000, np.float32), 16000, np.zeros((16, 3, 8, 8)), 24)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
