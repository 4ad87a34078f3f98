"""The reactor system over StyleGAN3-T: ``audio2video`` with a
``StyleGAN3Config``, audio -> ``audio2features`` -> ``LatentNoiseReactor``
(no noise maps) -> StyleGAN3-T synthesis in the render loop -> I420 frames
to the host's writer.

As ``reactor.py`` (whose entry wrappers, ``serve``, ``release`` and ``served``
it keeps), with StyleGAN3's weights drawn from the seed on the device in one
call, a 128 x 16 x 512 palette, and each layer's ``magnitude_ema`` set at
set-up from the float32 reference: the mean of x² at the layer's input over
64 W+ latents drawn from the seed, as training's running average holds it.
The program and the reference get the same buffers.  The check compares the
features, the latents and the sampled frames (there is no noise).  The
filtered leaky ReLU's counters (``ssar_tpu_torch.ops.filtered_lrelu``) are
reset at the end of set-up, so that after the window they hold the window's
calls (``layer_metrics/filter_bound_share.py``).
"""
from __future__ import annotations

import copy
import dataclasses
import math

from . import reactor
from ..compare import column_gap, frame_gap, rel_gap
from ..flops import gru_reactor_flops
from ..reference.precision import fp8, tf32
from ..sg3_counts import synthesis_flops

MAGNITUDE_FRAMES = 64


def generator_config(g: dict):
    """The port's ``StyleGAN3Config`` of a configuration file's ``generator``."""
    from ssar_tpu_torch.gan.stylegan3 import StyleGAN3Config

    return StyleGAN3Config(**{f.name: g[f.name] for f in dataclasses.fields(StyleGAN3Config) if f.name in g})


def draw_synthesis_params(gcfg, init: dict, generator, device) -> dict:
    """StyleGAN3-T synthesis weights from one normal draw and one uniform:
    convolution, style and input mixing weights N(0, 1); the input's affine
    ``init["input_affine"]`` N(0, 1) with bias (1, 0, 0, 0) (a trained
    network turns and shifts its input with w; the source's zero start would
    not); style biases 1 + 0.1 N; convolution biases 0.1 N; ToRGB kernels
    ``init["to_rgb"]`` N(0, 1); Fourier frequencies drawn on the disc as the
    source draws them and phases U(-0.5, 0.5); ``magnitude_ema`` 1 until the
    set-up measures it (assumed; the published trained weights are not in
    the repository)."""
    import torch

    inp, layers = gcfg.input_spec(), gcfg.schedule()
    c, w_dim = inp["channels"], gcfg.w_dim
    shapes = [("weight", (c, c)), ("affine", (4, w_dim)), ("freqs", (c, 2))]
    for s in layers:
        shapes += [("affine", (s.in_channels, w_dim)), ("affine_bias", (s.in_channels,)),
                   ("weight", (s.out_channels, s.in_channels, s.conv_kernel, s.conv_kernel)),
                   ("bias", (s.out_channels,))]
    flat = torch.randn(sum(math.prod(s) for _, s in shapes), generator=generator, device=device)
    phases = torch.rand((c,), generator=generator, device=device) - 0.5
    parts, off = [], 0
    for _, shape in shapes:
        n = math.prod(shape)
        parts.append(flat[off:off + n].reshape(shape).clone())
        off += n
    freqs = parts[2]
    radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
    freqs = freqs / (radii * radii.square().exp().pow(0.25)) * inp["bandwidth"]
    out = {"input": {"weight": parts[0], "affine": {"weight": init["input_affine"] * parts[1],
                                                    "bias": torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)},
                     "freqs": freqs, "phases": phases},
           "layers": []}
    for i, s in enumerate(layers):
        a, ab, w, b = parts[3 + 4 * i:7 + 4 * i]
        out["layers"].append({"affine": {"weight": a, "bias": 1.0 + 0.1 * ab},
                              "weight": init["to_rgb"] * w if s.is_torgb else w, "bias": 0.1 * b,
                              "magnitude_ema": torch.ones((), device=device)})
    return out


class System(reactor.System):
    def __init__(self, config: dict, mix: dict, seed: int, device, spans, tracks):
        import torch
        from ssar_tpu_torch.gan.wrapper import StyleGAN3Synthesizer
        from ssar_tpu_torch.generate import audio2video as a2v
        from ssar_tpu_torch.models.reactor import LatentNoiseReactor
        from ssar_tpu_torch.ops import filtered_lrelu

        from ..capture import Capture
        from ..reference import stylegan3 as ref_sg3

        g, r = config["generator"], config["reactor"]
        self.g, self.gcfg = g, generator_config(g)
        self.r, self.mix, self.device, self.spans = r, mix, torch.device(device), spans
        self.fps, self.batch = mix["fps"], mix["entry_batch_size"]
        R = g["resolution"]
        self.frame_shape = (R * 3 // 2, R)
        self.flops_per_frame = synthesis_flops(g) + gru_reactor_flops(
            r["n_features"], r["hidden_size"] * r["n_latent_split"] + 2 * r["n_noise"], r["num_layers"])
        gen = torch.Generator(self.device).manual_seed(int(seed))
        self.params = draw_synthesis_params(self.gcfg, config["init"], gen, self.device)
        self.palette = torch.randn((r["palette_rows"], self.gcfg.n_latent, self.gcfg.w_dim), generator=gen,
                                   device=self.device)
        ws = torch.randn((MAGNITUDE_FRAMES, self.gcfg.n_latent, self.gcfg.w_dim), generator=gen, device=self.device)
        self.magnitudes = ref_sg3.magnitudes(self.params, ws, g, block=1)
        del ws
        half = getattr(torch, g["dtype"]) if self.device.type == "cuda" else torch.float32
        self.synth = StyleGAN3Synthesizer(output_size=(R, R), config=self.gcfg, dtype=half, device=self.device,
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
                                   env_guard_eps=r["env_guard_eps"], n_ws=self.gcfg.n_latent)
        self.state = reactor.draw_reactor_state(model, r["hidden_size"], r["n_latent_split"], gen, self.device)
        model.load_state_dict({k: v.clone() for k, v in self.state.items()}, strict=False)
        self.model = model.to(self.device).eval()
        self.setup_track = setup
        self.serve(setup, budget=2 * self.batch)
        self.capture.reserve(mix["prepared_tracks"])
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        filtered_lrelu.reset_counters()

    def reference(self, track, frames, control: bool = False) -> dict:
        """The plain reference's features, latents and the I420 frames
        numbered in `frames` (the control's, one precision step down, with
        `control`: TF32 features, a bfloat16 reactor, fp8 operands in the
        half-precision layers' convolutions and TF32 in the float32 ones)."""
        import torch
        from ..reference import reactor as ref_reactor, stylegan3 as ref_sg3, synthesis as ref_synth
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
            latents, _ = ref_reactor.react(
                feats, sd, self.palette.float().cpu(), hidden=r["hidden_size"], n_split=r["n_latent_split"],
                n_noise=r["n_noise"], num_layers=r["num_layers"],
                generator=torch.Generator(dev).manual_seed(int(track.seed)),
                dtype=torch.bfloat16 if control else torch.float32)
            params = ref_synth.to_device(self.params, dev)
            out_frames = {}
            for k in frames:
                with torch.no_grad():
                    img = ref_sg3.synthesis(params, latents[k:k + 1].to(dev), self.g, fp8 if control else None,
                                            control=control)
                out_frames[k] = ref_synth.to_i420(img)[0].cpu().numpy()
        return {"features": feats.numpy(), "latents": latents.numpy(), "noise": [], "frames": out_frames}

    def numbers(self, got: dict, want: dict) -> dict:
        """The compared gaps of one track; frames over those both sides have."""
        frames = [k for k in want["frames"] if k in got["frames"]]
        return {
            "features_gap": column_gap(got["features"], want["features"]),
            "latents_gap": rel_gap(got["latents"], want["latents"]),
            "frames_gap": max((frame_gap(got["frames"][k], want["frames"][k]) for k in frames), default=0.0),
        }
