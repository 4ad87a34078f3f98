"""The reactor system: ``ssar_tpu_torch.generate.audio2video.audio2video``,
audio -> ``audio2features`` -> ``LatentNoiseReactor`` (``react``) ->
StyleGAN2 synthesis in the render loop -> I420 frames to the host's writer.

Weights come from the seed, drawn on the device in one call each (the
synthesis, the reactor) and a third for the palette; the reactor's input
statistics from the set-up track's features.  The benchmark keeps its own
float32 copies for the reference.  The set-up runs one whole call on the
set-up track (the cell's feature, reactor and batch shapes), its render cut
after two batches.
"""
from __future__ import annotations

import copy
import math

import numpy as np

from . import generator_config
from ..capture import Capture
from ..compare import column_gap, frame_gap, rel_gap
from ..flops import gru_reactor_flops, synthesis_flops
from ..reference.precision import fp8, tf32


def draw_synthesis_params(gcfg, generator, device) -> dict:
    """StyleGAN2 synthesis weights from one draw: N(0, 1) convolution, style
    and ``const`` weights, 0.2 N(0, 1) ``to_rgb`` kernels, style biases
    1 + 0.1 N(0, 1), convolution and RGB biases and noise strengths
    0.1 N(0, 1) (assumed; the published network's trained values are not in
    the repository).  At N(0, 1) ``to_rgb`` kernels most pixels of a frame
    clip; at 0.2 most lie in range, as a trained generator's do."""
    import torch

    chans = gcfg.channels()
    shapes: list = []

    def conv(cin, cout, k):
        return {"weight": (cout, cin, k, k), "mod": {"weight": (cin, gcfg.style_dim), "bias": (cin,)},
                "noise_weight": (), "bias": (cout,)}

    def rgb(cin):
        return {"weight": (3, cin, 1, 1), "mod": {"weight": (cin, gcfg.style_dim), "bias": (cin,)}, "bias": (3,)}

    tree = {"const": (chans[4], 4, 4), "conv1": conv(chans[4], chans[4], 3), "to_rgb1": rgb(chans[4]),
            "convs": [], "to_rgbs": []}
    cin = chans[4]
    for i in range(3, gcfg.log_size + 1):
        cout = chans[2 ** i]
        tree["convs"] += [conv(cin, cout, 3), conv(cout, cout, 3)]
        tree["to_rgbs"].append(rgb(cout))
        cin = cout

    def collect(node, path):
        if isinstance(node, tuple):
            shapes.append((path, node))
        elif isinstance(node, dict):
            for k, v in node.items():
                collect(v, path + (k,))
        else:
            for i, v in enumerate(node):
                collect(v, path + (i,))

    collect(tree, ())
    flat = torch.randn(sum(math.prod(s) for _, s in shapes), generator=generator, device=device)
    out: dict = {"convs": [{} for _ in tree["convs"]], "to_rgbs": [{} for _ in tree["to_rgbs"]]}
    off = 0
    for path, shape in shapes:
        n = math.prod(shape)
        v = flat[off:off + n].reshape(shape).clone()
        off += n
        leaf = path[-1]
        if leaf == "weight" and path[0] in ("to_rgb1", "to_rgbs"):
            v = 0.2 * v
        elif leaf == "bias":
            v = (1.0 + 0.1 * v) if path[-2] == "mod" else 0.1 * v
        elif leaf == "noise_weight":
            v = 0.1 * v
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {}) if isinstance(key, str) else node[key]
        node[leaf] = v
    return out


def draw_reactor_state(model, hidden: int, n_split: int, generator, device) -> dict:
    """The reactor's parameters from one draw: N(0, 1 / fan_in) weights and
    0.1 N(0, 1) biases, the GRU's r and z hidden biases 0 (the flax cell has
    none), and an envelope head that mixes convexly: the latent envelopes are
    1 / hidden + 0.004 N(0, 1) h (each split's envelopes sum near 1, as the
    fixed decoder's palette mixes assume) and the noise envelopes mu 0 and
    sigma 1 + 0.1 N(0, 1) h (assumed; a trained reactor is not in the
    repository)."""
    import torch

    params = list(model.named_parameters())
    flat = torch.randn(sum(p.numel() for _, p in params), generator=generator, device=device)
    state, off = {}, 0
    n_lat = hidden * n_split
    for name, p in params:
        v = flat[off:off + p.numel()].reshape(p.shape).clone()
        off += p.numel()
        if name == "envelopes.out.weight":
            v[:n_lat] *= 0.004
            v[n_lat:] *= 0.1
        elif name == "envelopes.out.bias":
            v[:n_lat] = 1.0 / hidden
            v[n_lat:] = torch.tensor([0.0, 1.0], device=device).repeat((v.shape[0] - n_lat) // 2)
        elif p.ndim == 2:
            v = v / math.sqrt(p.shape[1])
        else:
            v = 0.1 * v
            if "bias_hh" in name:
                v[: 2 * (p.shape[0] // 3)] = 0.0
        state[name] = v
    return state


class System:
    def __init__(self, config: dict, mix: dict, seed: int, device, spans, tracks):
        import torch
        from ssar_tpu_torch.gan.wrapper import StyleGAN2Synthesizer
        from ssar_tpu_torch.generate import audio2video as a2v
        from ssar_tpu_torch.models.reactor import LatentNoiseReactor

        g, r = config["generator"], config["reactor"]
        self.gcfg = generator_config(g)
        self.r, self.mix, self.device, self.spans = r, mix, torch.device(device), spans
        self.fps, self.batch = mix["fps"], mix["entry_batch_size"]
        R = g["resolution"]
        self.frame_shape = (R * 3 // 2, R)
        self.flops_per_frame = synthesis_flops(R, g["style_dim"], g["channel_multiplier"], g["max_channels"]) + \
            gru_reactor_flops(r["n_features"], r["hidden_size"] * r["n_latent_split"] + 2 * r["n_noise"],
                              r["num_layers"])
        gen = torch.Generator(self.device).manual_seed(int(seed))
        self.params = draw_synthesis_params(self.gcfg, gen, self.device)
        self.palette = torch.randn((r["palette_rows"], self.gcfg.n_latent, g["style_dim"]), generator=gen,
                                   device=self.device)
        self.synth = StyleGAN2Synthesizer(output_size=(R, R), config=self.gcfg, dtype=getattr(torch, g["dtype"]),
                                          device=self.device,
                                          params=copy.deepcopy(self.params))
        self.a2v = a2v
        self.capture, self.current = Capture(), {}
        self._orig = {n: getattr(a2v, n) for n in ("audio2features", "react", "render_reaction")}
        a2v.audio2features, a2v.react, a2v.render_reaction = self._features, self._react, self._render

        setup = tracks.setup()
        with torch.no_grad():
            feats = self._orig["audio2features"](setup.audio, setup.sr, self.fps, device=self.device)
        model = LatentNoiseReactor(feats.mean(0), feats.std(0) + 1e-6, self.palette.clone(), backbone=r["backbone"],
                                   hidden_size=r["hidden_size"], num_layers=r["num_layers"], decoder="fixed",
                                   n_latent_split=r["n_latent_split"], n_noise=r["n_noise"],
                                   env_guard_eps=r["env_guard_eps"])
        self.state = draw_reactor_state(model, r["hidden_size"], r["n_latent_split"], gen, self.device)
        model.load_state_dict({k: v.clone() for k, v in self.state.items()}, strict=False)
        self.model = model.to(self.device).eval()
        self.setup_track = setup
        self.serve(setup, budget=2 * self.batch)
        self.capture.reserve(mix["prepared_tracks"])

    # -- the entry and its wrapped stages --------------------------------
    def _features(self, *a, **kw):
        with self.spans("features"):
            out = self._orig["audio2features"](*a, **kw)
        self.current["features"] = self.capture.put(out)
        return out

    def _react(self, *a, **kw):
        with self.spans("reactor"):
            latents, noise = self._orig["react"](*a, **kw)
        self.current["latents"] = self.capture.put(latents)
        self.current["noise"] = [self.capture.put(n) for n in noise]
        return latents, noise

    def _render(self, *a, **kw):
        with self.spans("render"):
            return self._orig["render_reaction"](*a, **kw)

    def serve(self, track, deadline: float = math.inf, budget: int | None = None):
        """One audio2video call on `track`; returns (the sink, the captured
        outputs, the seconds of each stage where the spans timed them)."""
        from ..harness import Sink, WindowClosed

        self.current = {}
        first = len(self.spans.records)
        sink = Sink(self.frame_shape, deadline, budget, keep=track.check)
        R = self.gcfg.resolution
        try:
            self.a2v.audio2video(self.model, None, audio=track.audio, sr=track.sr, fps=self.fps,
                                 batch_size=self.batch, seed=track.seed, output_size=(R, R), gan_config=self.gcfg,
                                 synthesizer=self.synth, writer=sink, device=self.device)
        except WindowClosed:
            pass
        stages: dict = {}
        for name, t0, t1 in self.spans.records[first:]:
            stages[name] = stages.get(name, 0.0) + t1 - t0
        return sink, self.current, stages

    def release(self):
        """Drop the port's state (its synthesizer, reactor and wrappers); the
        benchmark's inputs stay for the reference."""
        import torch

        for n, f in self._orig.items():
            setattr(self.a2v, n, f)
        del self.synth, self.model
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- the reference -----------------------------------------------------
    def reference(self, track, frames, control: bool = False) -> dict:
        """The plain reference's outputs for `track` (the control's, one
        precision step down, with `control`): features, latents and noise
        of the whole track, and the I420 frames numbered in `frames`."""
        import torch
        from ..reference import reactor as ref_reactor, synthesis as ref_synth
        from ..reference.frozen.audio.features import audio2features
        from ..reference.frozen.utils import device as frozen_device

        r, dev = self.r, self.device
        with tf32(False):
            if not hasattr(self, "_ref_stats"):
                f = audio2features(self.setup_track.audio, self.setup_track.sr, self.fps, device=dev)
                self._ref_stats = (f.mean(0).cpu(), (f.std(0) + 1e-6).cpu())
            frozen_device.ALLOW_TF32 = control
            try:
                feats = audio2features(track.audio, track.sr, self.fps, device=dev).float().cpu()
            finally:
                frozen_device.ALLOW_TF32 = False
            sd = {k: v.float().cpu() for k, v in self.state.items()}
            sd["envelopes.normalize.mean"], sd["envelopes.normalize.std"] = self._ref_stats
            latents, noise = ref_reactor.react(
                feats, sd, self.palette.float().cpu(), hidden=r["hidden_size"], n_split=r["n_latent_split"],
                n_noise=r["n_noise"], num_layers=r["num_layers"],
                generator=torch.Generator(dev).manual_seed(int(track.seed)),
                dtype=torch.bfloat16 if control else torch.float32)
            params = ref_synth.to_device(self.params, dev)
            pyramid = ref_reactor.duplicate_pyramid(noise, self.gcfg.num_layers)
            quant = fp8 if control else None
            out_frames = {}
            for k in frames:
                with torch.no_grad():
                    img = ref_synth.synthesis(params, latents[k:k + 1].to(dev),
                                              [None if n is None else n[k:k + 1].to(dev) for n in pyramid], quant)
                out_frames[k] = ref_synth.to_i420(img)[0].cpu().numpy()
        return {"features": feats.numpy(), "latents": latents.numpy(), "noise": [n.numpy() for n in noise],
                "frames": out_frames}

    def numbers(self, got: dict, want: dict) -> dict:
        """The compared gaps of one track; frames over those both sides have."""
        frames = [k for k in want["frames"] if k in got["frames"]]
        return {
            "features_gap": column_gap(got["features"], want["features"]),
            "latents_gap": rel_gap(got["latents"], want["latents"]),
            "noise_gap": max(rel_gap(np.asarray(a), b) for a, b in zip(got["noise"], want["noise"])),
            "frames_gap": max((frame_gap(got["frames"][k], want["frames"][k]) for k in frames), default=0.0),
        }

    @staticmethod
    def served(sink, captured) -> dict:
        """What the timed path produced for one track, as the check reads it."""
        return {"features": captured["features"].float().numpy(), "latents": captured["latents"].float().numpy(),
                "noise": [n.float().numpy() for n in captured["noise"]], "frames": dict(sink.kept)}

