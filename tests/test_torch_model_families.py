"""The port's other model families vs the JAX package, on the CPU: Audio2Latent
v1 and v2, PSAGAN, StyleVideoGAN, the LSTM reactor and the patch contrastor,
the StyleGAN2 discriminator and pSp encoder, the context-FID encoder and the
latent augmenter.

flax parameters (perturbed, so that zero biases and gates take part) go into
the port through ``load_flax``; the same seeded numpy inputs go through both.
Dropout, attention-dropout and zoneout masks are JAX's recorded draws; the
GANs' noise, the patch starts, the triplet crops and the augmenter's choices
are JAX's through ``ssar_tpu_torch.generate.keys``.  Tolerances, of the
largest magnitude: 1e-5 for feed-forward parts, 1e-4 for recurrent and
attention parts and for gradients; ``frechet_distance`` and ``context_fid``
1e-4 relative; ``procedural_targets`` 1e-5.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssar_tpu_torch.gan import discriminator as td
from ssar_tpu_torch.generate import keys
from ssar_tpu_torch.metrics import context_fid as tcf
from ssar_tpu_torch.metrics.ood import frechet_distance
from ssar_tpu_torch.models import audio2latent as ta
from ssar_tpu_torch.models import psagan as tp
from ssar_tpu_torch.models import selfsupervised as tss
from ssar_tpu_torch.models._flax import flax_tree
from ssar_tpu_torch.ops.upfirdn import downsample2x
from ssar_tpu_torch.train import latent_augmenter as tla
from ssar_tpu_torch.train import palette_g as tpg
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_parity import close, init, jax_keys, perturb, record_bernoulli, replay_bernoulli, tree_close

ja = importlib.import_module("ssar_tpu.models.audio2latent")
jp = importlib.import_module("ssar_tpu.models.psagan")
jss = importlib.import_module("ssar_tpu.models.selfsupervised")
jd = importlib.import_module("ssar_tpu.gan.discriminator")
jcf = importlib.import_module("ssar_tpu.metrics.context_fid")
jood = importlib.import_module("ssar_tpu.metrics.ood")
jup = importlib.import_module("ssar_tpu.ops.upfirdn")
jla = importlib.import_module("ssar_tpu.train.latent_augmenter")
jpg = importlib.import_module("ssar_tpu.train.palette_g")

B, T, F = 2, 16, 12


def _grads_match(jfn, params, tm, t_out, r, rtol=1e-4, tree=None):
    """The gradient of sum(out * r) in both packages."""
    grads = jax.jit(jax.grad(lambda p: jnp.sum(jfn(p) * r)))(params)
    (t_out * torch.as_tensor(r)).sum().backward()
    tree_close(flax_tree(tm, grad=True) if tree is None else tree(tm), grads, rtol)


# ------------------------------------------------------------ Audio2Latent --
def _feat(rng, n=B, t=T, f=F):
    x = rng.randn(n, t, f).astype(np.float32)
    return x, x.mean((0, 1)), x.std((0, 1))


@pytest.mark.parametrize("backbone,layerwise", [("gru", "dense"), ("lstm", "dense"), ("conv", "dense"),
                                                ("gru", "conv")])
def test_audio2latent_forward_and_gradients_match_jax(rng, backbone, layerwise):
    x, mean, std = _feat(rng)
    kw = dict(hidden_size=8, num_layers=2, n_outputs=6, output_size=16, backbone=backbone, layerwise=layerwise)
    jm = ja.Audio2Latent(jnp.asarray(mean), jnp.asarray(std), **kw)
    params = perturb(init(jm, x)["params"], rng)
    tm = ta.Audio2Latent(mean, std, **kw).load_flax(params).eval()
    jfn = jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(x)))
    got = tm(torch.as_tensor(x))
    close(got, jfn(params), 1e-4, backbone)
    _grads_match(jfn, params, tm, got, rng.randn(*got.shape).astype(np.float32))


@pytest.mark.parametrize("T_in", (7, 8))
def test_conv_transpose_matches_flax(rng, T_in):
    """flax's SAME transposed conv at stride 2, odd and even lengths."""
    import flax.linen as nn

    jm = nn.ConvTranspose(5, (5,), strides=(2,), padding="SAME")
    x = rng.randn(B, T_in, 3).astype(np.float32)
    params = perturb(init(jm, x)["params"], rng)
    tm = ta.ConvTranspose1d(3, 5)
    tm.load_flax(params)
    with torch.no_grad():
        got = tm(torch.as_tensor(x))
    assert got.shape == (B, 2 * T_in, 5)
    close(got, jm.apply({"params": params}, jnp.asarray(x)), 1e-5, "conv_transpose")


def test_audio2latent_dropout_with_jax_draws(rng, monkeypatch):
    """Training at dropout 0.2: the LSTM's locked masks, the attention skip's
    and its attention weights' dropout, the heads', all JAX's."""
    x, mean, std = _feat(rng)
    kw = dict(hidden_size=8, num_layers=2, n_outputs=6, output_size=16, backbone="lstm", dropout=0.2)
    jm = ja.Audio2Latent(jnp.asarray(mean), jnp.asarray(std), **kw)
    params = perturb(init(jm, x)["params"], rng)
    tm = ta.Audio2Latent(mean, std, **kw).load_flax(params)
    draws = record_bernoulli(monkeypatch)
    want = jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(x), deterministic=False,
                                      rngs={"dropout": jax.random.PRNGKey(9)}))(params)
    jax.effects_barrier()
    left = replay_bernoulli(monkeypatch, draws)
    with torch.no_grad():
        got = tm.train()(torch.as_tensor(x))
    assert next(left, None) is None
    close(got, want, 1e-4, "dropout")


@pytest.mark.parametrize("context,correlation", [("gru", "eca"), ("conv", "linear"), ("transformer", "linear")])
def test_audio2latent2_forward_and_gradients_match_jax(rng, context, correlation):
    x, mean, std = _feat(rng)
    kw = dict(hidden_size=8, num_layers=4, n_outputs=6, output_size=16, context=context, correlation=correlation)
    jm = ja.Audio2Latent2(jnp.asarray(mean), jnp.asarray(std), **kw)
    params = perturb(init(jm, x)["params"], rng)
    tm = ta.Audio2Latent2(mean, std, **kw).load_flax(params).eval()
    jfn = jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(x)))
    got = tm(torch.as_tensor(x))
    close(got, jfn(params), 1e-4, context)
    _grads_match(jfn, params, tm, got, rng.randn(*got.shape).astype(np.float32))


# ------------------------------------------------------------------ PSAGAN --
def test_psagan_generator_and_discriminator_match_jax(rng, monkeypatch):
    """G with JAX's z (through keys.normal), D on G's output: forward and gradients."""
    jax_keys(monkeypatch)
    cond = rng.randn(B, 32, F).astype(np.float32)
    jg, jdm = jp.ProgressiveGenerator(out_dim=10, features=8, n_stages=3, noise_dim=4), \
        jp.ProgressiveDiscriminator(features=8, n_stages=3)
    gp = perturb(init(jg, cond, jax.random.PRNGKey(1)), rng, 0.1)["params"]
    fake = np.asarray(jg.apply({"params": gp}, jnp.asarray(cond), jax.random.PRNGKey(2)))
    dp = perturb(init(jdm, fake, cond), rng, 0.1)["params"]
    tg = tp.ProgressiveGenerator(F, out_dim=10, features=8, n_stages=3, noise_dim=4).load_flax(gp)
    tdm = tp.ProgressiveDiscriminator(10, F, features=8, n_stages=3).load_flax(dp)
    got = tg(torch.as_tensor(cond), jax.random.PRNGKey(2))
    close(got, fake, 1e-4, "G")
    score = tdm(got.detach(), torch.as_tensor(cond))
    close(score, jdm.apply({"params": dp}, jnp.asarray(fake), jnp.asarray(cond)), 1e-4, "D")
    _grads_match(lambda p: jg.apply({"params": p}, jnp.asarray(cond), jax.random.PRNGKey(2)), gp, tg, got,
                 rng.randn(*got.shape).astype(np.float32))
    _grads_match(lambda p: jdm.apply({"params": p}, jnp.asarray(fake), jnp.asarray(cond)), dp, tdm, score,
                 rng.randn(B).astype(np.float32))


# ------------------------------------------------------------ StyleVideoGAN --
def test_stylevideo_generator_and_discriminator_match_jax(rng):
    s = rng.randn(B, 6, 8).astype(np.float32)
    jg, jdm = jss.StyleVideoGenerator(n_styles=2, latent_dim=8), jss.StyleVideoDiscriminator(6, 2, 8)
    gp = perturb(init(jg, s)["params"], rng, 0.1)
    tg = tss.StyleVideoGenerator(n_styles=2, latent_dim=8).load_flax(gp)
    jfn = jax.jit(lambda p: jg.apply({"params": p}, jnp.asarray(s)))
    got = tg(torch.as_tensor(s))
    want = np.asarray(jfn(gp))
    close(got, want, 1e-4, "G")
    _grads_match(jfn, gp, tg, got, rng.randn(*got.shape).astype(np.float32))
    dp = perturb(init(jdm, want)["params"], rng, 0.1)
    tdm = tss.StyleVideoDiscriminator(6, 2, 8).load_flax(dp)
    dfn = jax.jit(lambda p: jdm.apply({"params": p}, jnp.asarray(want)))
    score = tdm(torch.as_tensor(want))
    close(score, dfn(dp), 1e-5, "D")
    _grads_match(dfn, dp, tdm, score, rng.randn(B).astype(np.float32))


# ------------------------------------------------------- LSTM reactor, NCE --
def _reactor(rng, zoneout=0.0):
    x = rng.randn(B, 8, F).astype(np.float32)
    m = rng.randn(B, 6).astype(np.float32)
    jm = jss.LSTMReactor(hidden_size=6, num_layers=2, n_styles=2, zoneout=zoneout)
    params = perturb(init(jm, x, m, rngs={"params": jax.random.PRNGKey(0), "zoneout": jax.random.PRNGKey(1)})
                     ["params"], rng, 0.1)
    tm = tss.LSTMReactor(F, hidden_size=6, num_layers=2, n_styles=2, zoneout=zoneout).load_flax(params)
    return jm, params, tm, x, m


def test_lstm_reactor_matches_jax(rng):
    jm, params, tm, x, m = _reactor(rng)
    jfn = jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(m)))
    want = jfn(params)
    got = tm.eval()(torch.as_tensor(x), torch.as_tensor(m))
    for g, w, what in zip(got, want, ("w", "outputs", "cells")):
        close(g, w, 1e-4, what)
    _grads_match(lambda p: jfn(p)[0], params, tm, got[0], rng.randn(*got[0].shape).astype(np.float32))


def test_lstm_reactor_zoneout_with_jax_draws(rng, monkeypatch):
    jm, params, tm, x, m = _reactor(rng, zoneout=0.3)
    draws = record_bernoulli(monkeypatch)
    want = jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(m), deterministic=False,
                                      rngs={"zoneout": jax.random.PRNGKey(3)}))(params)
    jax.effects_barrier()
    assert len(draws) == 2 * 8   # one mask a step a layer
    left = replay_bernoulli(monkeypatch, draws)
    with torch.no_grad():
        got = tm.train()(torch.as_tensor(x), torch.as_tensor(m))
    assert next(left, None) is None
    for g, w in zip(got, want):
        close(g, w, 1e-4, "zoneout")


def test_sslstm_features_and_inference_match_jax(rng, monkeypatch):
    """The contrastive LSTM's (T, 32) input features, and a reactor's W+
    sequence from them with JAX's motion seed (through keys.normal)."""
    jax_keys(monkeypatch)
    sr = 22050
    t = np.arange(2 * sr) / sr
    audio = (0.4 * np.sin(2 * np.pi * 330 * t) + 0.3 * np.sin(2 * np.pi * 495 * t) * (t % 0.5 < 0.1)).astype(np.float32)
    want = np.asarray(jss.sslstm_features(jnp.asarray(audio), sr))
    close(tss.sslstm_features(audio, sr, device="cpu"), want, 1e-5, "features")
    jm = jss.LSTMReactor(hidden_size=6, num_layers=1, n_styles=2)
    params = perturb(init(jm, want[None], np.zeros((1, 6), np.float32))["params"], rng, 0.1)
    j_w, _ = jss.sslstm_inference(jm, {"params": params}, jnp.asarray(audio), sr, seed=3)
    t_w, _ = tss.sslstm_inference(tss.LSTMReactor(32, 6, 1, 2).load_flax(params), audio, sr, seed=3, device="cpu")
    close(t_w, j_w, 1e-4, "w_seq")


def test_patches_and_contrastor_match_jax(rng, monkeypatch):
    jax_keys(monkeypatch)
    seq = rng.randn(B, 10, 3).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want_p = np.asarray(jss.sample_patches_1d(key, jnp.asarray(seq), 4, 3))
    got_p = tss.sample_patches_1d(key, torch.as_tensor(seq), 4, 3)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    b = rng.randn(*want_p.shape).astype(np.float32)
    jc = jss.PatchContrastor(embed_dim=8)
    params = perturb(init(jc, want_p, b)["params"], rng, 0.1)
    tc = tss.PatchContrastor(9, 9, embed_dim=8).load_flax(params)
    jfn = jax.jit(lambda p: jc.apply({"params": p}, jnp.asarray(want_p), jnp.asarray(b)))
    loss = tc(got_p, torch.as_tensor(b))
    close(loss, jfn(params), 1e-5, "nce")
    _grads_match(jfn, params, tc, loss, np.float32(1.0))


# ----------------------------------------------- discriminator and encoder --
def test_downsample2x_matches_jax(rng):
    x = rng.randn(2, 8, 8, 3).astype(np.float32)
    got = downsample2x(torch.as_tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    close(got, jup.downsample2x(jnp.asarray(x)), 1e-6, "downsample2x")


def test_discriminator_matches_jax(rng):
    img = rng.randn(4, 16, 16, 3).astype(np.float32)
    jm = jd.Discriminator(resolution=16, channel_multiplier=1)
    params = perturb(init(jm, img)["params"], rng, 0.1)
    tm = td.Discriminator(resolution=16, channel_multiplier=1).load_flax(params)
    jfn = jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(img)))
    score = tm(torch.as_tensor(img))
    close(score, jfn(params), 1e-5, "score")
    with torch.no_grad():
        close(tm(torch.as_tensor(img), features=True), jm.apply({"params": params}, jnp.asarray(img), features=True),
              1e-5, "features")
    _grads_match(jfn, params, tm, score, rng.randn(4).astype(np.float32),
                 tree=lambda m: td.discriminator_flax_tree(m, grad=True))
    np.testing.assert_allclose(td.discriminator_flax_tree(tm)["Dense_0"]["kernel"].numpy(),
                               params["Dense_0"]["kernel"])


def test_psp_encoder_matches_jax(rng):
    img = rng.randn(2, 16, 16, 3).astype(np.float32)
    jm = jd.PSPEncoder(n_styles=4, resolution=16)
    params = perturb(init(jm, img)["params"], rng, 0.1)
    tm = td.PSPEncoder(n_styles=4, resolution=16).load_flax(params)
    jfn = jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(img)))
    got = tm(torch.as_tensor(img))
    close(got, jfn(params), 1e-5, "psp")
    _grads_match(jfn, params, tm, got, rng.randn(*got.shape).astype(np.float32))


# ------------------------------------------------------------ context FID --
def test_frechet_distance_matches_jax(rng):
    a, b = rng.randn(40, 5), rng.randn(30, 5) * 1.5 + 0.3
    want = jood.frechet_distance(a.astype(np.float32), b.astype(np.float32))
    assert abs(frechet_distance(a.astype(np.float32), b.astype(np.float32)) - want) <= 1e-4 * abs(want)


def test_causal_encoder_triplet_and_fcd_match_jax(rng, monkeypatch):
    """The encoder's forward, the triplet loss with JAX's crops and its
    gradients, 3 Adam steps of train_encoder from the same weights, and the
    FCD of the fitted encoders."""
    jax_keys(monkeypatch)
    seqs = rng.randn(6, 20, 5).astype(np.float32)
    jm = jcf.CausalCNNEncoder(features=8, depth=3, embed_dim=4)
    params = perturb(init(jm, seqs[:1])["params"], rng, 0.1)
    tm = tcf.CausalCNNEncoder(5, features=8, depth=3, embed_dim=4).load_flax(params)
    with torch.no_grad():
        close(tm(torch.as_tensor(seqs)), jm.apply({"params": params}, jnp.asarray(seqs)), 1e-5, "encoder")
    key = jax.random.PRNGKey(3)
    jfn = jax.jit(lambda p: jcf.triplet_loss(lambda q, b: jm.apply({"params": q}, b), p, jnp.asarray(seqs), key))
    loss = tcf.triplet_loss(tm, torch.as_tensor(seqs), key)
    close(loss, jfn(params), 1e-5, "triplet")
    _grads_match(jfn, params, tm, loss, np.float32(1.0))

    enc_params = init(jcf.CausalCNNEncoder(features=8, embed_dim=4), seqs[:1], rngs=jax.random.PRNGKey(0))
    j_enc = jcf.train_encoder(seqs, n_steps=3, features=8, embed_dim=4)
    t_enc = tcf.train_encoder(seqs, n_steps=3, features=8, embed_dim=4, device="cpu", params=enc_params)
    fake = (seqs * 0.7 + 0.2).astype(np.float32)
    close(t_enc(fake), j_enc(fake), 1e-4, "fitted encoder")
    want = jcf.context_fid(j_enc, seqs, fake)
    assert abs(tcf.context_fid(t_enc, seqs, fake) - want) <= 1e-4 * abs(want)


# -------------------------------------------------- augmenter, palette G --
def test_latent_augmenter_matches_jax(rng, monkeypatch):
    jax_keys(monkeypatch)
    P = rng.randn(512, 4 * 16).astype(np.float32) / 20

    def j_mapper(z):
        return (jnp.asarray(z) @ P).reshape(-1, 4, 16)

    def t_mapper(z):
        return (torch.as_tensor(z) @ torch.as_tensor(P)).reshape(-1, 4, 16)

    feats = np.abs(rng.randn(2, 12, 59)).astype(np.float32)
    j_aug, t_aug = jla.LatentAugmenter(j_mapper, n_patches=4, n_ws=64), tla.LatentAugmenter(t_mapper, 4, 64)
    key = jax.random.PRNGKey(5)
    for got, want in zip(t_aug(torch.as_tensor(feats), key), j_aug(jnp.asarray(feats), key)):
        close(got, want, 1e-5, "augmenter")


def test_procedural_targets_match_jax(rng):
    w = rng.randn(3, 512).astype(np.float32)
    P = jpg.target_basis(512)
    np.testing.assert_array_equal(tpg.target_basis(512).numpy(), np.asarray(P))
    close(tpg.procedural_targets(torch.as_tensor(w), tpg.target_basis(512), 24),
          jpg.procedural_targets(jnp.asarray(w), P, 24), 1e-5, "targets")


def test_keys_fold_in_and_shaped_randint():
    k = keys.PRNGKey(3)
    assert keys.fold_in(k, 1) == keys.fold_in(k, 1) != keys.fold_in(k, 2) != k
    a = keys.randint(k, 2, 9, shape=(50,))
    assert a.dtype == torch.int64 and a.shape == (50,) and 2 <= int(a.min()) and int(a.max()) < 9
    assert torch.equal(a, keys.randint(k, 2, 9, shape=(50,))) and isinstance(keys.randint(k, 2, 9), int)
    m = keys.bernoulli(torch.Generator().manual_seed(0), 0.25, (4000,))
    assert m.dtype == torch.bool and 0.2 < float(m.float().mean()) < 0.3
