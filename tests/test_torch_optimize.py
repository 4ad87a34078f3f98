"""The port's test-time optimizer and HiPPO parameterization vs the JAX
package's, small, on the CPU: the same numpy inputs go through both.

Tolerances.  HiPPO matrices: the port builds A_t, B_t in float64 and rounds
once, the JAX package runs the same forward substitution in float32, so they
agree to a few float32 ulps of their largest entry (atol 2e-6); encodings and
decodings of [0, 1) envelopes within 1e-5.  Loss functions: rtol 1e-4 (float32
sums in another order; tr(X'Y) taken as sum(X * Y)).  The optimizer as a whole:
the per-step losses within rtol 1e-4 of JAX's from the same initial envelopes,
noise bases and palette; the final latents within 1e-3; the final envelopes
within 2e-2 only, because Adam moves a coefficient whose gradient is round-off
by about +-lr a step whichever sign the round-off has, and the decoder's
softmax cancels such shifts in the latents.
"""
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssar_tpu_torch.gan.stylegan2 import StyleGAN2Config
from ssar_tpu_torch.generate import optimize as t_opt
from ssar_tpu_torch.models import hippo as t_hippo

j_hippo = importlib.import_module("ssar_tpu.models.hippo")
j_opt = importlib.import_module("ssar_tpu.generate.optimize")
j_sg = importlib.import_module("ssar_tpu.gan.stylegan2")

N, L = 32, 160


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# --------------------------------------------------------------------- hippo --
@pytest.mark.parametrize("measure", ["lmu", "legs"])
def test_transition_matches_jax(measure):
    for got, want in zip(t_hippo.transition(measure, 16), j_hippo.transition(measure, 16)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        t_hippo.transition("fourier", 4)


def test_init_leg_t_matches_jax():
    for got, want in zip(t_hippo.init_leg_t(N, 1.0 / L), j_hippo.init_leg_t(N, 1.0 / L)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_init_leg_s_matches_jax_and_float64_solves():
    A_j, B_j, E_j = j_hippo.init_leg_s(N, L)
    A_t, B_t, E_t = (a.numpy() for a in t_hippo.init_leg_s(N, L, device="cpu"))
    assert A_t.shape == (L, N, N) and B_t.shape == (L, N) and E_t.shape == (L, N) and A_t.dtype == np.float32
    _close(A_t, A_j, 0, 2e-6)
    _close(B_t, B_j, 0, 2e-6)
    np.testing.assert_array_equal(E_t, E_j)
    # against dense float64 solves of the bilinear discretisation: within float32 rounding
    A, B = t_hippo.transition("legs", N)
    for t in (1, 2, 7, L):
        lhs = np.eye(N) - A / (2 * t)
        _close(A_t[t - 1], np.linalg.solve(lhs, np.eye(N) + A / (2 * t)), 0, 1e-7)
        _close(B_t[t - 1], np.linalg.solve(lhs, B / t)[:, 0], 0, 1e-7)


def test_encodes_match_jax(rng):
    f = rng.rand(L, 5).astype(np.float32)
    A_j, B_j, _ = j_hippo.init_leg_s(N, L)
    A_t, B_t, _ = t_hippo.init_leg_s(N, L, device="cpu")
    want = np.asarray(j_hippo.encode_leg_s(jnp.asarray(f), A_j, B_j))
    got = t_hippo.encode_leg_s(torch.as_tensor(f), A_t, B_t)
    assert got.shape == (5, N)
    _close(got, want, 0, 1e-5)
    # the blocked unroll, with a ragged last block, is the same recurrence
    _close(t_hippo.encode_leg_s_parallel(torch.as_tensor(f), A_t, B_t, block=64), want, 0, 1e-5)
    _close(np.asarray(j_hippo.encode_leg_s_parallel(jnp.asarray(f), A_j, B_j, block=64)), want, 0, 1e-5)
    _close(t_hippo.encode_leg_s_parallel(torch.as_tensor(f[:100]), A_t, B_t, block=32),
           t_hippo.encode_leg_s(torch.as_tensor(f[:100]), A_t, B_t), 0, 1e-5)

    Ad, Bd, _ = j_hippo.init_leg_t(N, 1.0 / L)
    _close(t_hippo.encode_leg_t(torch.as_tensor(f), Ad, Bd), np.asarray(j_hippo.encode_leg_t(jnp.asarray(f), Ad, Bd)),
           1e-4, 1e-5)


@pytest.mark.parametrize("invariance", ["s", "t"])
def test_hippo_timeseries_matches_jax(rng, invariance):
    T, C = 64, 7
    f = rng.rand(T, C).astype(np.float32)
    jm = j_hippo.HiPPOTimeseries(T, C, N=N, invariance=invariance, padding=48)
    tm = t_hippo.HiPPOTimeseries(T, C, N=N, invariance=invariance, padding=48, device="cpu")
    assert [n for n, _ in tm.named_parameters()] == ["c"] and tm.c.shape == (C, N)
    assert sorted(n for n, _ in tm.named_buffers()) == ["A", "B", "E"] and not tm.state_dict().keys() - {"c"}
    params_j = jm.init_params(jnp.asarray(f))
    params_t = tm.init_params(torch.as_tensor(f))
    _close(params_t["c"].detach(), np.asarray(params_j["c"]), 1e-4, 1e-5)
    want = np.asarray(jm.decode(params_j))
    got = tm.decode(params_t)
    assert got.shape == (T, C) and got.requires_grad
    _close(got.detach(), want, 0, 1e-4 if invariance == "s" else 1e-3)
    _close(tm.decode().detach(), got.detach(), 0, 0)

    # the JAX state carried across: its parameters and matrices give its decode
    carried = t_hippo.HiPPOTimeseries.from_reference_state(
        {"c": np.asarray(params_j["c"])}, jm.A, jm.B, jm.E, padding=48, invariance=invariance, device="cpu")
    _close(carried.decode().detach(), want, 0, 1e-5)
    _close(carried.init_params(torch.as_tensor(f))["c"].detach(), np.asarray(params_j["c"]), 1e-4, 1e-5)


def test_hippo_selects_the_parallel_encode_for_long_small(monkeypatch):
    calls = []
    monkeypatch.setattr(t_hippo, "encode_leg_s_parallel",
                        lambda f, A, B: calls.append("parallel") or torch.zeros(f.shape[1], A.shape[-1]))
    monkeypatch.setattr(t_hippo, "encode_leg_s",
                        lambda f, A, B: calls.append("sequential") or torch.zeros(f.shape[1], A.shape[-1]))
    t_hippo.HiPPOTimeseries(2049, 1, N=8, padding=0, device="cpu").init_params(torch.zeros(2049, 1))
    t_hippo.HiPPOTimeseries(2048, 1, N=8, padding=0, device="cpu").init_params(torch.zeros(2048, 1))
    t_hippo.HiPPOTimeseries(16, 1, N=8, padding=0, device="cpu").init_params(torch.zeros(16, 1))
    assert calls == ["parallel", "sequential", "sequential"]


# -------------------------------------------------------------- loss functions --
def test_autocorrelation_rv2_abscos_match_jax(rng):
    X = rng.randn(40, 3, 4).astype(np.float32)
    Y = rng.randn(40, 6).astype(np.float32)
    Xt, Yt = torch.as_tensor(X).requires_grad_(), torch.as_tensor(Y)
    _close(t_opt.autocorrelation(Xt).detach(), np.asarray(j_opt.autocorrelation(jnp.asarray(X))), 1e-4, 1e-4)
    for t_fn, j_fn in ((t_opt.rv2, j_opt.rv2), (t_opt.abscos, j_opt.abscos)):
        want, want_g = jax.value_and_grad(lambda a: j_fn(a, jnp.asarray(Y)))(jnp.asarray(X))
        got = t_fn(Xt, Yt)
        (got_g,) = torch.autograd.grad(got, Xt)
        _close(got.detach(), want, 1e-4)
        _close(got_g, want_g, 1e-3, 1e-3 * float(np.abs(want_g).max()))


def _soft_segmentation(rng, T, k):
    logits = 3.0 * rng.randn(T, k).astype(np.float32)
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


def test_sinkhorn_and_lap_losses_match_jax(rng):
    cost = (10 * rng.rand(4, 4)).astype(np.float32)
    P = t_opt.sinkhorn_assignment(torch.as_tensor(cost))
    _close(P, np.asarray(j_opt.sinkhorn_assignment(jnp.asarray(cost))), 1e-4, 1e-6)
    _close(P.sum(dim=0), np.ones(4), 1e-4)

    target = _soft_segmentation(rng, 30, 4)
    pred = target[:, [2, 0, 3, 1]] * 0.9 + 0.1 * _soft_segmentation(rng, 30, 4)  # a relabelled, blurred copy
    want, want_g = jax.value_and_grad(lambda p: j_opt.lap_loss(jnp.asarray(target), p))(jnp.asarray(pred))
    pt = torch.as_tensor(pred).requires_grad_()
    got = t_opt.lap_loss(torch.as_tensor(target), pt)
    (got_g,) = torch.autograd.grad(got, pt)
    _close(got.detach(), want, 1e-4)
    _close(got_g, want_g, 1e-3, 1e-6)
    # a batch of targets for one prediction is the single losses stacked
    other = _soft_segmentation(rng, 30, 4)
    both = t_opt.lap_loss(torch.as_tensor(np.stack([target, other])), pt.detach())
    _close(both, [float(got.detach()), float(j_opt.lap_loss(jnp.asarray(other), jnp.asarray(pred)))], 1e-4)

    assert t_opt.lap_loss_host(target, pred) == pytest.approx(j_opt.lap_loss_host(target, pred), rel=1e-6)
    assert t_opt.lap_loss_host(target, pred) < 0.05 < t_opt.lap_loss_host(target, target[:, ::-1] * 0 + 0.25)


def test_decoder_matches_jax(rng):
    S, G, H, n_noise, T, n_ws = 3, 2, 2, 2, 10, 6
    palette = rng.randn(S * G * H, n_ws, 16).astype(np.float32)
    x = rng.randn(T, S * G * H + 2 * n_noise).astype(np.float32)
    bases = [rng.randn(T, 2 ** (i + 2), 2 ** (i + 2)).astype(np.float32) for i in range(n_noise)]
    jd = j_opt.FixedLatentNoiseDecoderOpt(jnp.asarray(palette), S, G, H, n_noise)
    td = t_opt.FixedLatentNoiseDecoderOpt(torch.as_tensor(palette), S, G, H, n_noise)
    lat_j, noise_j = jd(jnp.asarray(x), [jnp.asarray(b) for b in bases])
    lat_t, noise_t = td(torch.as_tensor(x), [torch.as_tensor(b) for b in bases])
    assert lat_t.shape == (T, n_ws, 16)
    _close(lat_t, np.asarray(lat_j), 1e-5, 1e-6)
    for a, b in zip(noise_t, noise_j):
        _close(a, np.asarray(b), 1e-6, 1e-6)
    drawn = td.noise_bases(T)
    assert [tuple(b.shape) for b in drawn] == [(T, 4, 4), (T, 8, 8)]
    with pytest.raises(ValueError):
        t_opt.FixedLatentNoiseDecoderOpt(torch.as_tensor(palette[:5]), S, G, H, n_noise)


def test_cosine_schedule_and_adam_match_optax(rng):
    import optax

    want = optax.cosine_decay_schedule(1e-3, 20, alpha=0.01)
    got = t_opt.cosine_decay_schedule(1e-3, 20, alpha=0.01)
    _close([got(i) for i in range(25)], [float(want(i)) for i in range(25)], 1e-6)

    p0 = rng.randn(4, 5).astype(np.float32)
    grads = [rng.randn(4, 5).astype(np.float32) for _ in range(5)]
    opt = optax.adam(want)
    pj, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    pt = torch.as_tensor(p0.copy())
    adam = t_opt.ClippedAdam([pt], 1e-3)
    for i, g in enumerate(grads):
        updates, state = opt.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, updates)
        adam.lr = got(i)
        adam.step([torch.as_tensor(g)])
    _close(pt, np.asarray(pj), 1e-6, 1e-7)


# --------------------------------------------------- the optimizer end to end --
FPS, SEED, T_FRAMES, N_NOISE = 12, 3, 48, 2
BASE = dict(fps=FPS, n_steps=6, n_params=64, log_steps=1, n_noise=N_NOISE, ks=(2, 4), seed=SEED,
            n_latent_split=1, n_latent_groups=1, n_latent_per_group=3)
MODES = {
    "rv2": {},
    "procrustes": dict(objective="procrustes", norm_grads=False, use_audio_segmentation_features=True,
                       feature_weight_boosts={"onsets": 3.0, "rms": 10.0, "rosa_segmentation": 2.0}),
    "amplitude": dict(lambda_amplitude=1.0, emphasize_feature="onsets"),
    "lap": dict(lambda_lap=1.0, prediction_similarity_penalty=0.1),
}


def _track():
    """4 s in two halves: a quiet-noise 220 Hz half and a noisy 330 Hz half,
    with a click every half second.  Both discrete choices of the set-up
    have a wide margin on it, so they come out the same in both packages
    whatever the round-off: the tuning estimate (the argmax of a histogram:
    32 candidates in the top bin against 17 in the next) and the hard CQT
    segmentation labels (an argmax over soft k-means assignments of 9
    beat-synchronous frames; they survive 1e-3 dB of noise on the CQT)."""
    sr = 1024 * FPS
    t = np.arange(sr * 4) / sr
    rng = np.random.RandomState(0)
    audio = (0.4 * np.sin(2 * np.pi * np.cumsum(np.where(t < 2.0, 220.0, 330.0)) / sr)
             + np.where(t < 2.0, 0.02, 0.15) * rng.randn(len(t))).astype(np.float32)
    audio[:: sr // 2] += 1.0
    return audio, sr


@pytest.mark.parametrize("mode", list(MODES))
def test_optimize_matches_jax(rng, monkeypatch, tmp_path, mode):
    """JAX ``optimize`` against the port from the same initial envelopes,
    noise bases (JAX's own draws for this seed, injected into the port) and
    palette: each step's loss, the final latents, envelopes and noise."""
    audio, sr = _track()
    kw = dict(BASE, audio=audio, sr=sr, out_dir=str(tmp_path), **MODES[mode])
    n_env = 3 + 2 * N_NOISE
    palette = rng.randn(3, 8, 512).astype(np.float32)
    interp = rng.randn(T_FRAMES, 512).astype(np.float32) if mode == "procrustes" else None

    env_j, lat_j, noise_j, losses_j = j_opt.optimize(
        palette=jnp.asarray(palette), interp=interp, gan_config=j_sg.StyleGAN2Config(resolution=32, max_channels=64),
        **kw)

    init_f = np.array(jax.random.uniform(jax.random.PRNGKey(SEED), (T_FRAMES, n_env)))
    key, draws = jax.random.PRNGKey(SEED), {}
    for i in range(N_NOISE):
        key, sub = jax.random.split(key)
        size = 2 ** (i + 2)
        draws[size] = np.array(jax.random.normal(sub, (T_FRAMES, size, size)))
    monkeypatch.setattr(t_opt, "initial_envelopes", lambda n, e, generator, device: torch.as_tensor(init_f))
    monkeypatch.setattr(t_opt, "noise_base_draw", lambda T, size, generator, device: torch.as_tensor(draws[size]))
    env_t, lat_t, noise_t, losses_t = t_opt.optimize(
        palette=palette, interp=interp, gan_config=StyleGAN2Config(resolution=32, max_channels=64), device="cpu", **kw)

    assert len(losses_t) == len(losses_j) == 6 and losses_j[-1] < losses_j[0]
    _close(losses_t, losses_j, 1e-4)
    assert env_t.shape == (T_FRAMES, n_env) and lat_t.shape == (T_FRAMES, 8, 512)
    _close(lat_t, np.asarray(lat_j), 0, 1e-3)
    _close(env_t, np.asarray(env_j), 0, 2e-2)
    for a, b in zip(noise_t, noise_j):
        _close(a, np.asarray(b), 0, 5e-2)


def test_optimize_chunks_losses_and_evals(rng, monkeypatch, tmp_path):
    """``losses[i]`` is the loss at step i * log_steps; with ``render`` a chunk
    never runs past an eval boundary, and every boundary renders."""
    audio, sr = _track()
    palette = rng.randn(3, 8, 512).astype(np.float32)
    kw = dict(BASE, audio=audio, sr=sr, out_dir=str(tmp_path), palette=palette, device="cpu",
              gan_config=StyleGAN2Config(resolution=32, max_channels=64))
    every = t_opt.optimize(**kw)[3]
    assert t_opt.optimize(**dict(kw, log_steps=4))[3] == [every[0], every[4]]

    rendered = []
    monkeypatch.setattr(t_opt, "_render_eval", lambda audio_file, latents, noise, out_file, *a, **k:
                        rendered.append((Path(out_file).name, tuple(latents.shape), len(noise))))
    chunked = t_opt.optimize(**dict(kw, log_steps=4, render=True, eval_steps=3))[3]
    assert chunked == [every[0], every[3]]
    assert rendered == [(f"hippo_synthetic_{SEED}_{it}.mp4", (T_FRAMES, 8, 512), N_NOISE) for it in (3, 6)]


def test_render_eval_duplicates_the_noise_pyramid(rng):
    frames = []

    class Sink:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def write_i420(self, frame):
            frames.append(frame.shape)

    cfg = StyleGAN2Config(resolution=32, max_channels=16)
    latents = torch.as_tensor(rng.randn(5, cfg.n_latent, 512).astype(np.float32))
    noise = [torch.as_tensor(rng.randn(5, 2 ** (i + 2), 2 ** (i + 2)).astype(np.float32)) for i in range(6)]
    t_opt._render_eval(None, latents, noise, None, None, FPS, cfg, device="cpu", writer=Sink())
    assert frames == [(48, 32)] * 5


def test_optimize_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_opt.optimize(audio=np.zeros(12288, np.float32), sr=12288, fps=12)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_hippo.HiPPOTimeseries(16, 2, N=8)

