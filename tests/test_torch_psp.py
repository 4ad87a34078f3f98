"""pSp (``gan/psp.py``) against the JAX package on the CPU: the three
encoders from an upstream-layout pSp ``state_dict`` (the JAX tests' own
helper) and from the JAX package's random trees, ``adaptive_avg_pool``,
``psp_apply`` with style mixing and zero-masking through a small StyleGAN2
decoder, and ``invert_frames``' chunking.

Tolerances: codes and frames within 1e-4 of the largest reference value at
the JAX tests' small IR configuration (``tests/test_psp.py`` ``STAGES``,
32 px inputs); the pool within 1e-6; ``invert_frames`` at batch 4 against
batch 1 within 1e-5 (a frame's code does not depend on its batch).  The
full-width IR-SE50 case is marked ``slow``, as the JAX package marks its own.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssar_tpu_torch.gan import psp as tp
from ssar_tpu_torch.gan import stylegan2 as ts
from ssar_tpu_torch.models import convert_extractors as tc
from test_psp import STAGES
from test_psp import _build_torch_sd as psp_upstream_sd
from torch_parity import close, np_tree, one_torch_thread  # noqa: F401

jp = importlib.import_module("ssar_tpu.gan.psp")
jsg = importlib.import_module("ssar_tpu.gan.stylegan2")


def _images(seed: int, n: int = 2, res: int = 32) -> np.ndarray:
    return (np.random.RandomState(seed).rand(n, res, res, 3) * 2 - 1).astype(np.float32)


@pytest.mark.parametrize("wplus", [False, True])
def test_encoders_from_an_upstream_checkpoint_match_jax(wplus):
    n_styles, style_dim = (5, 16) if wplus else (8, 16)
    sd = psp_upstream_sd(n_styles, style_dim, wplus=wplus)
    x = _images(1 if wplus else 0)
    jparams = jp.convert_psp({k: v.numpy() for k, v in sd.items()}, stages=STAGES)
    name = "BackboneEncoderUsingLastLayerIntoWPlus" if wplus else "GradualStyleEncoder"
    want = np.asarray(jp.ENCODERS[name](jparams["encoder"], jnp.asarray(x), STAGES))

    ckpt = {f"encoder.{k[len('encoder.'):]}": v for k, v in sd.items()} | {"latent_avg": torch.zeros(n_styles, 16)}
    psp = tp.convert_psp(ckpt, stages=STAGES)
    assert type(psp["encoder"]) is tp.ENCODERS[name]
    assert psp["latent_avg"].shape == (n_styles, 16) and "decoder" not in psp
    got = tp.encode(psp["encoder"], torch.as_tensor(x))
    assert got.shape == want.shape == (2, n_styles, style_dim)
    close(got, want, 1e-4, name)
    # the JAX package's tree carries the same weights across
    enc = tp.make_encoder(name, STAGES, n_styles, style_dim, input_res=32)
    enc.load_state_dict(tc.from_flax_psp(np_tree(jparams["encoder"])))
    assert torch.equal(tp.encode(enc.eval(), torch.as_tensor(x)), got)


@pytest.mark.parametrize("encoder_type", list(tp.ENCODERS))
def test_random_encoders_match_jax_and_roundtrip(encoder_type, tmp_path):
    kw = dict(stages=STAGES, n_styles=8, input_res=32, style_dim=16, encoder_type=encoder_type)
    tree = jp.init_random_params(**kw)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, tp.init_random_tree(**kw), tree))
    x = _images(2)
    want = np.asarray(jp.ENCODERS[encoder_type](tree, jnp.asarray(x), STAGES))
    enc = tp.init_random_params(**kw)
    got = {"GradualStyleEncoder": tp.gradual_style_encoder, "BackboneEncoderUsingLastLayerIntoW": tp.backbone_encoder_w,
           "BackboneEncoderUsingLastLayerIntoWPlus": tp.backbone_encoder_wplus}[encoder_type](enc, torch.as_tensor(x))
    close(got, want, 1e-4, encoder_type)

    tc.save_converted(tree, str(tmp_path / "enc.npz"))
    sd = tc.from_flax_psp(tc.load_converted(str(tmp_path / "enc.npz")))
    assert set(sd) == {k for k in enc.state_dict() if not k.endswith("num_batches_tracked")}
    assert all(torch.equal(enc.state_dict()[k], v) for k, v in sd.items())


def test_adaptive_avg_pool_matches_jax():
    for h in (2, 15, 16, 28):
        x = np.random.RandomState(h).rand(1, h, h, 3).astype(np.float32)
        close(tp.adaptive_avg_pool(torch.as_tensor(x), 7), np.asarray(jp.adaptive_avg_pool(jnp.asarray(x), 7)), 1e-6)


def test_psp_apply_mixing_and_masking_match_jax():
    cfg_j = jsg.StyleGAN2Config(resolution=32, max_channels=32)
    cfg = ts.StyleGAN2Config(resolution=32, max_channels=32)
    enc_tree = jp.init_random_params(stages=STAGES, n_styles=cfg.n_latent, input_res=32)
    dec_tree = np_tree(jsg.init_generator(jax.random.PRNGKey(0), cfg_j))
    avg = 0.1 * np.ones((cfg.n_latent, 512), np.float32)
    jparams = {"encoder": enc_tree, "decoder": dec_tree, "latent_avg": avg}
    psp = {"encoder": tp.init_random_params(stages=STAGES, n_styles=cfg.n_latent, input_res=32),
           "decoder": ts.params_from_jax(dec_tree), "latent_avg": torch.as_tensor(avg)}
    x = _images(0)
    inj = np.random.RandomState(1).randn(2, cfg.n_latent, 512).astype(np.float32)

    for kwargs in ({}, {"latent_mask": [0, 1], "alpha": 0.5}, {"latent_mask": [3]}):
        j_kw = dict(kwargs, inject_latent=jnp.asarray(inj)) if "alpha" in kwargs else kwargs
        t_kw = dict(kwargs, inject_latent=torch.as_tensor(inj)) if "alpha" in kwargs else kwargs
        want_f, want_c = jp.psp_apply(jparams, jnp.asarray(x), cfg_j, stages=STAGES, **j_kw)
        with torch.no_grad():
            got_f, got_c = tp.psp_apply(psp, torch.as_tensor(x), cfg, **t_kw)
        assert got_f.shape == (2, 32, 32, 3) and got_c.shape == (2, cfg.n_latent, 512)
        close(got_c, np.asarray(want_c), 1e-4, f"codes {kwargs}")
        close(got_f, np.asarray(want_f), 1e-4, f"frames {kwargs}")
        if not kwargs:
            codes = got_c
        elif "alpha" in kwargs:
            close(got_c[:, 0], 0.5 * inj[:, 0] + 0.5 * codes[:, 0].numpy(), 1e-5, "mixed row")
            assert torch.equal(got_c[:, 2], codes[:, 2])
        else:
            assert got_c[:, 3].abs().max() == 0


def test_invert_frames_chunks_match_jax():
    kw = dict(stages=STAGES, n_styles=8, input_res=32, style_dim=16)
    tree = jp.init_random_params(**kw)
    avg = np.random.RandomState(3).randn(8, 16).astype(np.float32)
    frames = np.random.RandomState(0).rand(7, 32, 32, 3).astype(np.float32)
    want = np.asarray(jp.invert_frames({"encoder": tree, "latent_avg": avg}, jnp.asarray(frames), stages=STAGES,
                                       batch_size=4))
    psp = {"encoder": tp.init_random_params(**kw), "latent_avg": torch.as_tensor(avg)}
    w4 = tp.invert_frames(psp, frames, batch_size=4, device="cpu")
    w1 = tp.invert_frames(psp, torch.as_tensor(frames), batch_size=1, device="cpu")
    assert w4.shape == (7, 8, 16)
    np.testing.assert_allclose(w4.numpy(), w1.numpy(), atol=1e-5, rtol=1e-4)
    close(w4, want, 1e-4, "invert_frames")


def test_invert_frames_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.invert_frames({"encoder": torch.nn.Identity()}, np.zeros((1, 8, 8, 3), np.float32))


@pytest.mark.slow
def test_ir_se50_full_width_matches_jax():
    """The IR-SE50 GradualStyleEncoder at full width (18 styles x 512) on a
    64 px input, from the JAX package's random tree (fan-in scaled: the
    upstream-layout helper's fixed scales overflow to NaN at full depth).
    At this depth float32 itself is the limit: against a float64 run of the
    same weights JAX's codes are 0.9e-3 and the port's 1.9e-3 of the largest
    value off, so the two packages are held within 5e-3 of each other, and
    the port within 3e-3 of float64."""
    kw = dict(stages=50, n_styles=18, input_res=64, style_dim=512)
    tree = jp.init_random_params(**kw)
    x = _images(0, n=1, res=64)
    want = np.asarray(jp.gradual_style_encoder(tree, jnp.asarray(x), 50))
    assert np.isfinite(want).all()
    enc = tp.make_encoder("GradualStyleEncoder", 50, 18, 512, input_res=64)
    enc.load_state_dict(tc.from_flax_psp(tree))
    got = tp.gradual_style_encoder(enc.eval(), torch.as_tensor(x))
    close(got, want, 5e-3, "IR-SE50 full width")
    exact = tp.gradual_style_encoder(enc.double(), torch.as_tensor(x).double())
    close(got, exact.detach().numpy(), 3e-3, "IR-SE50 full width, float32 against float64")
