"""The random-patch system: ``ssar_tpu_torch.generate.sample.generate``,
audio -> music information (8 features on the card; tempo, beats and the
segmentations on the host) -> the generator and its 180-latent palette
(built on every call) -> a ``Patch`` drawn from the track's seed (latent
sequences, lazy noise trees) -> the chunked render -> I420 frames to the
host's writer.

The entry draws its own weights from the patch seed (on the CPU, as every
call does), so the reference draws them again from that seed.  The set-up
runs one whole call on the set-up track, its render cut after two chunks.
"""
from __future__ import annotations

import math
import os
import shutil
import tempfile

import numpy as np

from . import generator_config
from ..capture import Capture
from ..compare import column_gap, frame_gap, rel_gap
from ..flops import mapping_flops, synthesis_flops
from ..reference.precision import fp8, tf32


def chunk_starts(T: int, bs: int) -> list[int]:
    """The entry's chunks of `bs` frames, the last one overlapping the one
    before it (the schedule ``generate`` renders by)."""
    starts = list(range(0, T - bs + 1, bs))
    if starts and starts[-1] != T - bs:
        starts.append(T - bs)
    return starts


def chunk_of(k: int, T: int, bs: int) -> int:
    """The start of the chunk frame `k` is written from: the first that holds it."""
    return next(s for s in chunk_starts(T, bs) if s <= k < s + bs)


class NoiseRecorder:
    """A patch's noise tree for one layer, keeping a copy of the rows of the
    checked frames from the call that renders them."""

    def __init__(self, tree, keep, store: dict, capture: Capture):
        self.tree, self.keep, self.store, self.capture = tree, keep, store, capture

    def __call__(self, i, b):
        out = self.tree(i, b)
        for k in self.keep:
            if i <= k < i + b and k not in self.store:
                self.store[k] = self.capture.put(out[k - i])
        return out

    def __getattr__(self, name):   # the entry reads the banks' sizes through the tree's attributes
        return getattr(self.tree, name)


class System:
    def __init__(self, config: dict, mix: dict, seed: int, device, spans, tracks):
        import torch
        from ssar_tpu_torch.generate import sample

        g = config["generator"]
        self.g, self.mix, self.device, self.spans = g, mix, torch.device(device), spans
        self.gcfg = generator_config(g)
        self.fps, self.batch, self.downscale = mix["fps"], mix["entry_batch_size"], mix["downscale_factor"]
        self.size = round(g["resolution"] / self.downscale)
        if self.size & (self.size - 1):
            raise ValueError(f"output size {self.size}: the check renders power-of-two sizes only")
        self.frame_shape = (self.size * 3 // 2, self.size)
        frames = int(mix["seconds"] * mix["fps"])
        self.flops_per_frame = synthesis_flops(self.size, g["style_dim"], g["channel_multiplier"],
                                               g["max_channels"]) + 180 * mapping_flops(g["style_dim"], g["n_mlp"]) / frames
        self.sample = sample
        self.out_dir = tempfile.mkdtemp(prefix="port_bench_", dir=os.environ.get("TMPDIR"))
        self.capture, self.current = Capture(), {}
        self._orig = {"retrieve_music_information": sample.retrieve_music_information, "Patch": sample.Patch,
                      "StyleGAN2": sample.StyleGAN2}
        sample.retrieve_music_information = self._mir
        sample.Patch = self._patch_class()
        sample.StyleGAN2 = self._model
        self.serve(tracks.setup(), budget=2 * self.batch)
        n_layers = self.gcfg.num_layers
        rows = [((s, s), torch.float32) for s in self._noise_sizes()[:n_layers]] * mix["frames_checked"]
        self.capture.reserve(mix["prepared_tracks"], [k for k in self.capture.shapes if k not in rows] + rows)

    def _noise_sizes(self) -> list[int]:
        return [4] + [2 ** i for i in range(3, int(math.log2(self.size)) + 1) for _ in range(2)]

    # -- the entry and its wrapped stages --------------------------------
    def _mir(self, *a, **kw):
        with self.spans("music_information"):
            features, segmentations, tempo = self._orig["retrieve_music_information"](*a, **kw)
        self.current["features"] = {k: self.capture.put(v) for k, v in features.items()}
        return features, segmentations, tempo

    def _model(self, *a, **kw):
        with self.spans("model_build"):
            return self._orig["StyleGAN2"](*a, **kw)

    def _patch_class(self):
        system = self

        class RecordingPatch(self._orig["Patch"]):
            def forward(self, *a, **kw):
                with system.spans("patch"):
                    latents, noise = super().forward(*a, **kw)
                system.current["latents"] = system.capture.put(latents)
                store = system.current.setdefault("noise", {})
                rows: dict = {}
                wrapped = []
                for layer, tree in enumerate(noise):
                    rows[layer] = {}
                    wrapped.append(NoiseRecorder(tree, system.current["check"], rows[layer], system.capture))
                store.update(rows)
                return latents, wrapped

        return RecordingPatch

    def serve(self, track, deadline: float = math.inf, budget: int | None = None):
        """One generate call on `track` with the track's seed as the patch
        seed; returns (the sink, the captured outputs, the seconds of each stage)."""
        from ..harness import Sink, WindowClosed

        self.current = {"check": track.check}
        stats: dict = {}
        sink = Sink(self.frame_shape, deadline, budget, keep=track.check)
        try:
            self.sample.generate(audio=track.audio, sr=track.sr, seed=track.seed, fps=self.fps, config=self.gcfg,
                                 downscale_factor=self.downscale, batch_size=self.batch, writer=sink,
                                 out_dir=self.out_dir, stats=stats, device=self.device)
        except WindowClosed:
            pass
        stages = {"features": stats.get("mir_features_s"), "segmentation": stats.get("mir_segmentation_s"),
                  "model_build": stats.get("model_s"), "patch": stats.get("patch_s")}
        if sink.t_enter is not None:
            stages["render"] = (sink.t_exit or sink.t_enter) - sink.t_enter
        return sink, self.current, {k: v for k, v in stages.items() if v is not None}

    def release(self):
        import torch

        for n, f in self._orig.items():
            setattr(self.sample, n, f)
        shutil.rmtree(self.out_dir, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- the reference -----------------------------------------------------
    def reference(self, track, frames, control: bool = False) -> dict:
        """The plain reference's outputs for `track` (the control's with
        `control`): the eight features, the latent sequence, the noise rows
        and the I420 frames of the frames numbered in `frames`."""
        import torch
        from ..reference import synthesis as ref_synth
        from ..reference.frozen.generate import keys
        from ..reference.frozen.generate.mir import retrieve_music_information
        from ..reference.frozen.generate.patch import Patch
        from ..reference.frozen.utils import device as frozen_device

        g, dev, T = self.g, self.device, track.frames
        with tf32(control):
            frozen_device.ALLOW_TF32 = control
            try:
                features, segmentations, tempo = retrieve_music_information(track.audio, track.sr, device=dev)
            finally:
                frozen_device.ALLOW_TF32 = False
            params = ref_synth.to_device(ref_synth.init_like_port(
                g["resolution"], track.seed, g["style_dim"], g["n_mlp"], g["lr_mlp"], g["channel_multiplier"],
                g["max_channels"]), dev)
            with torch.no_grad():
                w = ref_synth.mapping(params, keys.normal(keys.PRNGKey(track.seed), (180, g["style_dim"]), device=dev),
                                      g["lr_mlp"])
                palette = w[:, None, :].expand(-1, self.gcfg.n_latent, -1)
                patch = Patch(features=features, segmentations=segmentations, tempo=tempo, seed=track.seed,
                              fps=self.fps)
                latents, trees = patch.forward(palette, downscale_factor=self.downscale, aspect_ratio=1)
            n_used = int(math.log2(self.size)) * 2 - 3     # the layers the synthesis runs to the output size
            offset = 2 * int(round(math.log2(self.downscale)))   # banks aligned by scale, as the entry aligns them
            trees = trees[offset:offset + n_used]
            bs = min(self.batch, T)
            noise, out_frames = {}, {}
            for k in frames:
                s = chunk_of(k, T, bs)
                with torch.no_grad():
                    rows = [tree(s, bs)[k - s] for tree in trees]
                    quant = fp8 if control else None
                    img = ref_synth.synthesis(params, latents[k:k + 1], [r[None, None] for r in rows]
                                              + [None] * (self.gcfg.num_layers - n_used), quant, size=self.size)
                noise[k] = [r.cpu().numpy() for r in rows]
                out_frames[k] = ref_synth.to_i420(img)[0].cpu().numpy()
        return {"features": {k: v.cpu().numpy() for k, v in features.items()}, "latents": latents.cpu().numpy(),
                "noise": noise, "frames": out_frames}

    def numbers(self, got: dict, want: dict) -> dict:
        frames = [k for k in want["frames"] if k in got["frames"]]
        noise = [rel_gap(np.asarray(a), b) for k in frames for a, b in zip(got["noise"].get(k, []), want["noise"][k])]
        return {
            "features_gap": max(column_gap(np.asarray(got["features"][k]).reshape(len(v), -1),
                                           v.reshape(len(v), -1)) for k, v in want["features"].items()),
            "latents_gap": rel_gap(got["latents"], want["latents"]),
            "noise_gap": max(noise, default=0.0),
            "frames_gap": max((frame_gap(got["frames"][k], want["frames"][k]) for k in frames), default=0.0),
        }

    @staticmethod
    def served(sink, captured) -> dict:
        noise = {}
        for layer, rows in sorted(captured.get("noise", {}).items()):
            for k, row in rows.items():
                noise.setdefault(k, []).append(row.float().numpy())
        return {"features": {k: v.float().numpy() for k, v in captured["features"].items()},
                "latents": captured["latents"].float().numpy(), "noise": noise, "frames": dict(sink.kept)}
