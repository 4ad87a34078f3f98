"""The port's spans (``utils.profiling.span``), on the CPU.

Without a profiler a span opens no profiler range and never synchronises;
under ``torch.profiler`` it is the range ``span:<name>``, nested as the code
nests.  The random-patch entry (``generate``), the render loop
(``render_latents_to_video``) and ``audio2video`` emit the spans the
benchmark's readers take, and ``generate``'s stage seconds are the seconds
of its spans.
"""
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ssar_tpu_torch.gan import stylegan2 as ts
from ssar_tpu_torch.gan.render import render_latents_to_video
from ssar_tpu_torch.gan.wrapper import StyleGAN2Synthesizer
from ssar_tpu_torch.generate import audio2video as t_a2v
from ssar_tpu_torch.generate import sample as t_sample
from ssar_tpu_torch.utils import profiling
from ssar_tpu_torch.utils.profiling import span

RENDER = ("render.noise", "render.synthesis", "render.transfer", "render.wait", "render.write")
GENERATE = {"sample.load", "sample.model_build", "sample.patch", "mir.features", "mir.beats", "mir.segmentation",
            "mir.rosa", "render.loop", *RENDER}
# the benchmark's own span names (port_bench/systems): a program span of one of them would be summed with it
BENCH_NAMES = {"window", "features", "reactor", "render", "music_information", "model_build", "patch"}


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


def _spans(prof) -> list[tuple[str, float, float]]:
    """(name, start, end) in µs of every ``span:`` range the profiler holds."""
    return [(e.name[len("span:"):], e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("span:")]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _raise(*a, **k):
    raise AssertionError("called")


def test_span_without_profiler_opens_no_range_and_never_synchronises(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    seconds = {}
    with span("a", seconds):
        time.sleep(0.01)
    with span("b", seconds, "a"):
        pass
    with span("c"):
        pass
    assert set(seconds) == {"a"} and seconds["a"] >= 0.01
    with pytest.raises(ValueError), span("d", seconds):   # a block that raises adds nothing
        raise ValueError
    assert set(seconds) == {"a"}


def test_span_under_the_profiler_nests_as_the_code(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    seconds = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer", seconds):
            with span("inner"):
                torch.ones(4).sum()
            with span("inner"):
                pass
        with span("after"):
            pass
    got = _spans(prof)
    assert sorted(n for n, _, _ in got) == ["after", "inner", "inner", "outer"]
    outer = next(s for s in got if s[0] == "outer")
    assert all(_inside(s, outer) for s in got if s[0] == "inner")
    assert not _inside(next(s for s in got if s[0] == "after"), outer)
    assert set(seconds) == {"outer"} and seconds["outer"] > 0


@pytest.fixture(scope="module")
def traced_generate(tmp_path_factory):
    """A 2 s track at 8 fps (16 frames) through ``generate`` at 32 px in
    chunks of 6, under the profiler, with the spans' clock replaced by a
    counter that steps by one a reading: each timed span then reads 1 s."""
    fps, sr = 8, 8192
    t = np.arange(2 * sr) / sr
    audio = (0.4 * np.sin(2 * np.pi * 220 * t) + 0.05 * np.random.RandomState(0).randn(len(t))).astype(np.float32)
    audio[:: sr // 2] += 1.0
    ticks = iter(range(10**6))
    stats, sink = {}, _Sink()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling, "time", types.SimpleNamespace(perf_counter=lambda: float(next(ticks))))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t_sample.generate(seed=3, fps=fps, downscale_factor=1, batch_size=6,
                              config=ts.StyleGAN2Config(resolution=32, max_channels=32), audio=audio, sr=sr,
                              out_dir=str(tmp_path_factory.mktemp("spans")), writer=sink, device="cpu", stats=stats)
    return _spans(prof), stats, sink


def test_generate_emits_every_span(traced_generate):
    spans, stats, sink = traced_generate
    names = [n for n, _, _ in spans]
    assert set(names) == GENERATE and not set(names) & BENCH_NAMES
    assert names.count("mir.features") == 2 and names.count("render.loop") == 1
    chunks = -(-stats["frames"] // 6)
    assert len(sink.frames) == stats["frames"] == 16 and chunks == 3
    assert all(names.count(n) == chunks for n in RENDER)


def test_generate_render_spans_lie_inside_the_loop(traced_generate):
    spans = traced_generate[0]
    loop = next(s for s in spans if s[0] == "render.loop")
    assert all(_inside(s, loop) for s in spans if s[0] in RENDER)
    assert not any(_inside(s, loop) for s in spans if s[0].startswith(("mir.", "sample.")))


def test_generate_stats_are_the_spans_seconds(traced_generate):
    """Each timed span reads 1 s on the counting clock: the stage seconds
    are sums of whole spans (three for the segmentation, two for the
    features), and the render's inner spans read no clock."""
    stats = traced_generate[1]
    assert stats["mir_segmentation_s"] == 3.0      # mir.beats + mir.segmentation + mir.rosa
    assert stats["mir_features_s"] == 2.0          # the two mir.features spans
    assert stats["load_s"] == stats["model_s"] == stats["patch_s"] == stats["render_s"] == 1.0
    assert stats["bank_bytes"] > 0


def test_render_latents_to_video_spans(rng):
    cfg = ts.StyleGAN2Config(resolution=16, max_channels=8)
    syn = StyleGAN2Synthesizer(config=cfg, seed=0, dtype=torch.float32, device="cpu")
    lat = torch.as_tensor(rng.randn(11, cfg.n_latent, 512).astype(np.float32))
    noise = [torch.as_tensor(rng.randn(11, 1, h, w).astype(np.float32)) for h, w in cfg.noise_shapes()]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sink = render_latents_to_video(syn, lat, noise, batch_size=4, writer=_Sink(), progress=False)
    assert len(sink.frames) == 11
    spans = _spans(prof)
    names = [n for n, _, _ in spans]
    assert names.count("render.loop") == 1 and all(names.count(n) == 3 for n in RENDER)
    loop = next(s for s in spans if s[0] == "render.loop")
    assert all(_inside(s, loop) for s in spans if s[0] != "render.loop")


def test_audio2video_spans_its_features_and_reactor(monkeypatch):
    """The two stages before the render, each a span around its call."""
    def stage(name, out):
        def fn(*a, **k):
            with torch.profiler.record_function(name):
                return out
        return fn

    monkeypatch.setattr(t_a2v, "audio2features", stage("stub.features", torch.zeros(4, 59)))
    monkeypatch.setattr(t_a2v, "react", stage("stub.react", (torch.zeros(4, 18, 512), [])))
    monkeypatch.setattr(t_a2v, "render_reaction", lambda *a, **k: "rendered")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert t_a2v.audio2video(None, None, audio=np.zeros(1024, np.float32), sr=1024, device="cpu") == "rendered"
    events = {e.name: (e.name, e.time_range.start, e.time_range.end) for e in prof.events()}
    assert _inside(events["stub.features"], events["span:audio2video.features"])
    assert _inside(events["stub.react"], events["span:audio2video.reactor"])
