"""The port's StyleGAN3-T (``gan/stylegan3.py``, ``ops/filtered_lrelu.py``)
against the benchmark's plain reference (``port_bench/reference/stylegan3.py``),
on the CPU, in float32, small and seeded.

The schedule at 1024 px is held to the published numbers; the filters to
``scipy.signal.firwin``; the polyphase filtered leaky ReLU to the
zero-inserting reference at every (up, down) the network uses within 1e-5
of the largest magnitude (the same products summed in another order); a
whole 64 px network within 1e-4 of the largest pixel (fourteen layers of
it).  ``audio2video`` renders a StyleGAN3 configuration end to end through
``render_reaction`` with a reactor that has no noise, and the two repairs
of that path (a palette split that does not divide the W+ rows raises; an
empty noise list renders without noise) leave StyleGAN2's path as it was.
"""
import dataclasses

import numpy as np
import pytest
import scipy.signal
import torch

from port_bench import sg3_counts
from port_bench.reference import stylegan3 as ref
from ssar_tpu_torch.gan import stylegan3 as sg3
from ssar_tpu_torch.gan import stylegan2 as sg2
from ssar_tpu_torch.gan.render import render_latents_to_video
from ssar_tpu_torch.gan.wrapper import StyleGAN2Synthesizer, StyleGAN3Synthesizer
from ssar_tpu_torch.generate import audio2video as a2v
from ssar_tpu_torch.models.reactor import FixedLatentNoiseDecoder, LatentNoiseReactor
from ssar_tpu_torch.ops import filtered_lrelu as flr

SMALL = sg3.StyleGAN3Config(resolution=64, channel_base=512, channel_max=16)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Sink:
    def __init__(self):
        self.frames = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def write_i420(self, frame):
        self.frames.append(np.array(frame))

    def write(self, frame):
        self.frames.append(np.array(frame))


def _params(config, seed=0):
    """Seeded weights with a nonzero input affine (the transform path runs)
    and nonzero biases; magnitudes set from the reference as the benchmark
    sets them."""
    g = torch.Generator().manual_seed(seed)
    p = sg3.init_generator(config, g)
    p["input"]["affine"]["weight"] = 0.3 * torch.randn(p["input"]["affine"]["weight"].shape, generator=g)
    for layer in p["layers"]:
        layer["bias"] = 0.1 * torch.randn(layer["bias"].shape, generator=g)
        layer["affine"]["bias"] = 1 + 0.1 * torch.randn(layer["affine"]["bias"].shape, generator=g)
    ws = torch.randn((4, config.n_latent, config.w_dim), generator=g)
    ref.magnitudes(p, ws, dataclasses.asdict(config), block=2)
    return p


def test_schedule_at_1024_is_the_published_one():
    config = sg3.StyleGAN3Config()
    layers = config.schedule()
    assert config.n_latent == 16 and len(layers) == 15
    assert [s.out_size for s in layers] == [36, 36, 52, 52, 84, 148, 148, 276, 276, 532, 1044, 1044, 1044, 1024,
                                            1024]
    assert [s.out_channels for s in layers] == [512] * 7 + [323, 203, 128, 81, 51, 32, 32, 3]
    assert config.input_spec() == {"channels": 512, "size": 36, "sampling_rate": 16.0, "bandwidth": 2.0}
    assert [s.out_sampling_rate for s in layers] == [16, 16, 32, 32, 64, 128, 128, 256, 256, 512] + [1024] * 5
    assert [s.use_fp16 for s in layers] == [False] * 5 + [True] * 10
    assert {(s.up, s.down) for s in layers} == {(2, 2), (4, 2), (1, 1)}
    assert [s.up_taps for s in layers] == [12 * s.up // 2 if s.up > 1 else 1 for s in layers]
    assert layers[0].padding == (9, 8, 9, 8) and layers[2].padding == (-6, -9, -6, -9)
    assert layers[13].padding == (-11, -12, -11, -12) and layers[14].padding == (0, 0, 0, 0)
    # the reference derives the same schedule on its own
    inp, rlayers = ref.schedule({})
    assert inp == config.input_spec()
    for s, r in zip(layers, rlayers):
        assert {k: getattr(s, k) for k in r if hasattr(s, k)} == {k: v for k, v in r.items() if hasattr(s, k)}


def test_designed_filters_are_firwins():
    config = sg3.StyleGAN3Config()
    for s in config.schedule():
        fu, fd = config.filters(s)
        rfu, rfd = ref.filters(dataclasses.asdict(s))
        for f, r, taps, cutoff, hw in ((fu, rfu, s.up_taps, s.in_cutoff, s.in_half_width),
                                       (fd, rfd, s.down_taps, s.out_cutoff, s.out_half_width)):
            if taps == 1:
                assert f is None and r is None
                continue
            want = scipy.signal.firwin(numtaps=taps, cutoff=cutoff, width=2 * hw, fs=s.tmp_sampling_rate)
            np.testing.assert_array_equal(f, want)
            np.testing.assert_allclose(r.numpy(), want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("index", [0, 2, 13, 14])   # (2, 2); (4, 2) cropping; (2, 2) cropping; ToRGB (1, 1)
def test_filtered_lrelu_matches_the_zero_inserting_reference(index):
    spec = sg3.StyleGAN3Config().schedule()[index]
    fu, fd = sg3.StyleGAN3Config().filters(spec)
    g = torch.Generator().manual_seed(index)
    x = 40 * torch.randn((2, 3, 31, 29), generator=g)       # some values past the clamp
    b = torch.randn((3,), generator=g)
    gain, slope = (1.0, 1.0) if spec.is_torgb else (2 ** 0.5, 0.2)
    before = (flr.calls, flr.least_bytes)
    got = flr.FilteredLReLU(fu, fd, spec.up, spec.down, spec.padding, gain, slope, 256.0, 3)(x, b)
    want = ref.filtered_lrelu(x, None if fu is None else torch.tensor(fu, dtype=torch.float32),
                              None if fd is None else torch.tensor(fd, dtype=torch.float32), b, spec.up, spec.down,
                              spec.padding, gain, slope, 256.0)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert (flr.calls, flr.least_bytes) == (before[0] + 1, before[1] + 4 * (x.numel() + got.numel()))


def test_filtered_lrelu_in_frame_groups_is_the_whole_batch(monkeypatch):
    """Where a batch's upsampled grid passes the depthwise convolution's
    32-bit indexing, the frames go in groups; the result is the same."""
    config = sg3.StyleGAN3Config()
    spec = config.schedule()[2]
    op = flr.FilteredLReLU(*config.filters(spec), spec.up, spec.down, spec.padding, 2 ** 0.5, 0.2, 256.0, 3)
    x = torch.randn((5, 3, 20, 20), generator=torch.Generator().manual_seed(0))
    b = torch.randn((3,), generator=torch.Generator().manual_seed(1))
    whole = op(x, b)
    monkeypatch.setattr(flr, "INDEX_LIMIT", 2 * 3 * 42 * 42)   # two frames a group: 42 x 42 upsampled a channel
    before = flr.calls
    assert torch.equal(op(x, b), whole) and flr.calls == before + 1


def test_up_matrix_holds_one_phase_a_row():
    """Row m of the upsampling matrix holds the taps of phase m mod up of the
    flipped filter (gain up) and nothing else; the down matrix computes the
    kept samples alone."""
    f = np.arange(1.0, 25.0)
    m = flr.up_matrix(f, 4, -6, 30, 30 * 4 - 15 - 24 + 1)
    h = 4 * f[::-1]
    for row in range(m.shape[0]):
        taps = m[row][m[row] != 0]
        phase = (row - (-6)) % 4
        assert len(taps) <= 6 and set(taps) <= set(h[(-phase) % 4::4])
    d = flr.down_matrix(np.arange(1.0, 13.0), 2, 40)
    assert d.shape == (15, 40) and (d != 0).sum(1).tolist() == [12] * 15
    # the blocks of a matrix hold every tap of it
    for mat in (m, d):
        whole = np.zeros_like(mat)
        for r0, r1, a, b, t in flr.band_tiles(mat, 8):
            whole[r0:r1, a:b] = t
        np.testing.assert_array_equal(whole, mat)


def test_synthesis_matches_the_reference_at_64px():
    p = _params(SMALL)
    g = torch.Generator().manual_seed(1)
    ws = torch.randn((3, SMALL.n_latent, SMALL.w_dim), generator=g)
    got = sg3.synthesis(p, ws, SMALL, sg3.prepare_synthesis(p, SMALL, half=None))
    want = ref.synthesis(p, ws, dataclasses.asdict(SMALL))
    assert got.shape == want.shape == (3, 3, 64, 64) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    # a frame does not depend on the rest of its batch
    one = sg3.synthesis(p, ws[1:2], SMALL, sg3.prepare_synthesis(p, SMALL, half=None))
    assert float((one[0] - got[1]).abs().max()) <= 1e-5 * float(got.abs().max())


def test_filter_counters_match_the_benchmarks_bytes():
    p = _params(SMALL, seed=2)
    prep = sg3.prepare_synthesis(p, SMALL, half=None)
    flr.reset_counters()
    sg3.synthesis(p, torch.zeros((2, SMALL.n_latent, SMALL.w_dim)), SMALL, prep)
    assert flr.calls == SMALL.num_layers + 1
    assert flr.least_bytes == 2 * sum(sg3_counts.filter_least_bytes(dataclasses.asdict(SMALL), half_bytes=4))
    assert sg3_counts.synthesis_flops(dataclasses.asdict(sg3.StyleGAN3Config())) > 0.56e12


def test_mapping_matches_the_reference():
    p = _params(SMALL, seed=3)
    p["w_avg"] = torch.randn(SMALL.w_dim, generator=torch.Generator().manual_seed(4))
    z = torch.randn((2, SMALL.z_dim), generator=torch.Generator().manual_seed(5))
    for psi in (1.0, 0.7):
        got = sg3.mapping(p, z, SMALL, psi)
        want = ref.mapping(p, z, SMALL.n_latent, SMALL.lr_mlp, psi)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_stylegan3_synthesizer_takes_no_noise_bends_or_checkpoint():
    synth = StyleGAN3Synthesizer(config=SMALL, device="cpu", params=_params(SMALL), output_size=(48, 32))
    assert synth.n_noises_used == 0 and synth.dtype == torch.float32
    assert synth(torch.zeros((1, SMALL.n_latent, 512))).shape == (1, 32, 48, 3)
    with pytest.raises(ValueError, match="noise"):
        synth(torch.zeros((1, SMALL.n_latent, 512)), noises=[torch.zeros(1, 4, 4, 1)])
    with pytest.raises(ValueError, match="bends"):
        synth.set_bends({0: lambda x: x})
    with pytest.raises(NotImplementedError, match="checkpoints"):
        StyleGAN3Synthesizer("model.pkl", config=SMALL, device="cpu")


def _reactor(n_ws, split, n_noise, hidden=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    palette = torch.randn((split * hidden, n_ws, 512), generator=g)
    return LatentNoiseReactor(torch.zeros(59), torch.ones(59), palette, backbone="gru", hidden_size=hidden,
                              num_layers=2, decoder="fixed", n_latent_split=split, n_noise=n_noise).eval()


def test_audio2video_renders_stylegan3_through_render_reaction(monkeypatch):
    """audio2video with a StyleGAN3 configuration and a reactor without
    noise: the synthesizer is built for the family, the render loop gets no
    noise, and the frames are the synthesis of the reactor's latents."""
    torch.manual_seed(0)
    model = _reactor(SMALL.n_latent, 4, 0)
    p = _params(SMALL, seed=6)
    built = {}
    real = StyleGAN3Synthesizer

    def synth(*a, **kw):
        kw["params"] = p
        built["synth"] = real(*a, **kw)
        return built["synth"]

    monkeypatch.setattr("ssar_tpu_torch.gan.wrapper.StyleGAN3Synthesizer", synth)
    fps, sr = 24, 24576
    audio = np.random.default_rng(0).standard_normal(sr, dtype=np.float32) * 0.1
    sink = a2v.audio2video(model, None, audio=audio, sr=sr, fps=fps, batch_size=8, seed=3, output_size=(64, 64),
                           gan_config=SMALL, device="cpu", writer=_Sink())
    assert len(sink.frames) == 24 and sink.frames[0].shape == (96, 64)
    assert isinstance(built["synth"], real)
    feats = a2v.audio2features(audio, sr, fps, device="cpu")
    latents, noise = a2v.react(model, feats, torch.Generator().manual_seed(3))
    assert noise == [] and latents.shape == (24, SMALL.n_latent, 512)
    want = render_latents_to_video(built["synth"], latents, None, batch_size=8, progress=False, writer=_Sink())
    assert all(np.array_equal(a, b) for a, b in zip(sink.frames, want.frames))


def test_fixed_decoder_raises_where_the_split_does_not_divide_the_rows():
    with pytest.raises(ValueError, match="16 W\\+ rows do not split into 3"):
        FixedLatentNoiseDecoder(torch.zeros(12, 16, 512), hidden_size=4, n_latent_split=3)
    dec = FixedLatentNoiseDecoder(torch.randn(12, 18, 512), hidden_size=4, n_latent_split=3)
    env = torch.rand(1, 5, 12 + 8) + 0.1
    latents, noise = dec(env, generator=torch.Generator().manual_seed(0))
    # 18 rows in 3 splits: each split's 6 rows mix its own 4 palette rows
    want = torch.einsum("bth,hwl->btwl", env[..., 4:8] / env[..., 4:8].sum(-1, keepdim=True),
                        dec.latents[4:8, 6:12])
    assert latents.shape == (1, 5, 18, 512) and len(noise) == 4
    assert torch.allclose(latents[:, :, 6:12], want)


@pytest.mark.parametrize("noise", [[], None])
def test_render_reaction_renders_an_empty_noise_without_noise(noise):
    cfg = sg2.StyleGAN2Config(resolution=16, max_channels=8)
    synth = StyleGAN2Synthesizer(config=cfg, device="cpu", dtype=torch.float32)
    latents = torch.randn((5, cfg.n_latent, 512), generator=torch.Generator().manual_seed(0))
    got = a2v.render_reaction(latents, noise, output_size=(16, 16), batch_size=2, gan_config=cfg,
                              synthesizer=synth, writer=_Sink())
    want = render_latents_to_video(synth, latents, None, output_size=(16, 16), batch_size=2, progress=False,
                                   writer=_Sink())
    assert len(got.frames) == 5 and all(np.array_equal(a, b) for a, b in zip(got.frames, want.frames))


def test_render_reaction_keeps_stylegan2_noise_as_it_was():
    """A StyleGAN2 reactor's noise pyramid still reaches the render loop
    duplicated (noise0, then each level twice) and cut to the layers used."""
    cfg = sg2.StyleGAN2Config(resolution=16, max_channels=8)
    synth = StyleGAN2Synthesizer(config=cfg, device="cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(1)
    latents = torch.randn((5, cfg.n_latent, 512), generator=g)
    noise = [torch.randn((5, 1, s, s), generator=g) for s in (4, 8, 16, 32)]
    got = a2v.render_reaction(latents, noise, output_size=(16, 16), batch_size=2, gan_config=cfg,
                              synthesizer=synth, writer=_Sink(), offset=1 / 24, fps=24)
    dup = [noise[0], noise[1], noise[1], noise[2], noise[2]]
    want = render_latents_to_video(synth, latents[1:], [n[1:] for n in dup], output_size=(16, 16), batch_size=2,
                                   progress=False, writer=_Sink())
    assert len(got.frames) == 4 and all(np.array_equal(a, b) for a, b in zip(got.frames, want.frames))


def test_benchmark_cell_runs_small_on_the_cpu():
    """The benchmark's StyleGAN3 cell through its own harness at 64 px on the
    CPU: the system serves tracks through audio2video, the check holds them
    to the plain reference, and the traced run reads ``filter_bound_share``
    from the window's filter calls alone (the counters reset after set-up)."""
    import copy

    from port_bench import harness as H
    from port_bench import run
    from port_bench.layer_metrics import filter_bound_share
    from port_bench.traffic import load_mix

    cell, _, config = H.find_cell("tracks60.sg3t1024-gru32x4", H.load_json(run.ROOT / "BENCHMARK.json"))
    config = copy.deepcopy(config)
    config["generator"].update(resolution=64, channel_base=512, channel_max=16)
    mix = load_mix(cell["traffic"])
    mix.update(seconds=1, entry_batch_size=8, prepared_tracks=1, frames_checked=2)
    limits = {"features_gap": 1e-4, "latents_gap": 5e-3, "frames_gap": 1.0}
    flr.reset_counters()
    assert filter_bound_share.read(H.Run(seconds=1.0, loop_s=1.0, peaks={"hbm_bytes_per_s": 3.35e12})) is None
    result = run.run_cell("tracks60.sg3t1024-gru32x4", 4200000001, 1.0, True, device="cpu", config=config, mix=mix,
                          limits=limits)
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["checks"]) == set(limits)
    assert result["metrics"]["filter_bound_share"]["value"] > 0
    assert flr.calls % (SMALL.num_layers + 1) == 0
