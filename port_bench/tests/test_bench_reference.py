"""The plain reference against the port at small sizes on the CPU, so that
neither the frozen copies nor the written-out reference drift from the
port's semantics unseen."""
import numpy as np
import pytest
import torch

from port_bench.reference import reactor as ref_reactor, synthesis as ref_synth
from port_bench.traffic import track_audio

SR, FPS = 24576, 24


@pytest.fixture(scope="module")
def audio():
    return track_audio(1234, SR, 4.0, 1.0)


def test_features_equal(audio):
    from port_bench.reference.frozen.audio.features import audio2features as frozen
    from ssar_tpu_torch.audio.features import audio2features

    want = audio2features(audio, SR, FPS, device="cpu")
    got = frozen(audio, SR, FPS, device="cpu")
    assert got.shape == (96, 59)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_music_information_and_patch_equal(audio):
    from port_bench.reference.frozen.generate.mir import retrieve_music_information as frozen_mir
    from port_bench.reference.frozen.generate.patch import Patch as FrozenPatch
    from ssar_tpu_torch.generate.mir import retrieve_music_information
    from ssar_tpu_torch.generate.patch import Patch

    f1, s1, t1 = retrieve_music_information(audio, SR, device="cpu")
    f2, s2, t2 = frozen_mir(audio, SR, device="cpu")
    assert t1 == t2 and f1.keys() == f2.keys() and s1.keys() == s2.keys()
    for k in f1:
        torch.testing.assert_close(f2[k], f1[k], rtol=0, atol=0)
    for k in s1:
        assert torch.equal(s1[k], s2[k]), k
    palette = torch.randn(180, 12, 512, generator=torch.Generator().manual_seed(0))
    lat1, noise1 = Patch(f1, s1, t1, fps=FPS, seed=77).forward(palette, downscale_factor=8)
    lat2, noise2 = FrozenPatch(f2, s2, t2, fps=FPS, seed=77).forward(palette, downscale_factor=8)
    torch.testing.assert_close(lat2, lat1, rtol=0, atol=0)
    assert len(noise1) == len(noise2) == 17
    for a, b in zip(noise1, noise2):
        torch.testing.assert_close(b(40, 8), a(40, 8), rtol=0, atol=0)


def test_weights_and_mapping_equal():
    from ssar_tpu_torch.gan import stylegan2 as sg

    cfg = sg.StyleGAN2Config(resolution=128, max_channels=16)
    port = sg.init_generator(cfg, torch.Generator().manual_seed(99))
    ref = ref_synth.init_like_port(128, 99, max_channels=16)
    flat = lambda p: [t for t in _leaves(p)]   # noqa: E731
    assert len(flat(ref)) == len(flat({k: v for k, v in port.items() if k != "w_avg"}))
    for a, b in zip(flat(ref), flat({k: v for k, v in port.items() if k != "w_avg"})):
        assert torch.equal(a, b)
    z = torch.randn(5, 512, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(ref_synth.mapping(ref, z), sg.mapping(port, z, cfg), rtol=1e-6, atol=1e-6)


def _leaves(p):
    if isinstance(p, torch.Tensor):
        yield p
    elif isinstance(p, dict):
        for k in sorted(p):
            yield from _leaves(p[k])
    else:
        for v in p:
            yield from _leaves(v)


def test_synthesis_and_i420_match_the_port():
    from port_bench.systems.reactor import draw_synthesis_params
    from ssar_tpu_torch.gan import stylegan2 as sg
    from ssar_tpu_torch.gan.render import rgb_to_i420

    cfg = sg.StyleGAN2Config(resolution=128, max_channels=16)
    params = draw_synthesis_params(cfg, torch.Generator().manual_seed(5), "cpu")
    g = torch.Generator().manual_seed(6)
    latents = torch.randn(3, cfg.n_latent, 512, generator=g)
    noises = [torch.randn(3, 1, h, w, generator=g) for h, w in cfg.noise_shapes()]
    want = sg.synthesis(params, latents, [n.permute(0, 2, 3, 1) for n in noises], cfg, dtype=torch.float32)
    got = ref_synth.synthesis(params, latents, noises)
    torch.testing.assert_close(got.permute(0, 2, 3, 1), want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    half = ref_synth.synthesis(params, latents, noises, size=32)
    assert half.shape == (3, 3, 32, 32)
    port_i420 = rgb_to_i420(torch.clamp((want + 1) / 2, 0, 1)).numpy().astype(int)
    ref_i420 = ref_synth.to_i420(got).numpy().astype(int)
    assert np.abs(port_i420 - ref_i420).max() <= 1 and np.abs(port_i420 - ref_i420).mean() < 0.01


def test_reactor_matches_the_port(audio):
    from port_bench.systems.reactor import draw_reactor_state
    from ssar_tpu_torch.audio.features import audio2features
    from ssar_tpu_torch.generate.audio2video import react
    from ssar_tpu_torch.models.reactor import LatentNoiseReactor

    feats = audio2features(audio, SR, FPS, device="cpu")
    palette = torch.randn(96, 12, 512, generator=torch.Generator().manual_seed(3))
    model = LatentNoiseReactor(feats.mean(0), feats.std(0) + 1e-6, palette, backbone="gru", hidden_size=32,
                               num_layers=4, decoder="fixed", n_latent_split=3, n_noise=4)
    state = draw_reactor_state(model, 32, 3, torch.Generator().manual_seed(4), "cpu")
    model.load_state_dict(state, strict=False)
    model.eval()
    lat1, noise1 = react(model, feats, torch.Generator().manual_seed(8))
    sd = dict(state, **{"envelopes.normalize.mean": feats.mean(0), "envelopes.normalize.std": feats.std(0) + 1e-6})
    lat2, noise2 = ref_reactor.react(feats, sd, palette, hidden=32, n_split=3, n_noise=4, num_layers=4,
                                     generator=torch.Generator().manual_seed(8))
    torch.testing.assert_close(lat2, lat1, rtol=1e-4, atol=1e-5 * float(lat1.abs().max()))
    for a, b in zip(noise1, noise2):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-5 * float(a.abs().max()))
