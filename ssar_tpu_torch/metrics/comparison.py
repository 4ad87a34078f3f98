"""Evaluation harness comparing the generation paradigms.

Counterpart of ``ssar_tpu/metrics/comparison.py``: for each test clip, each
model (random patches, a trained reactor, test-time optimization, the
LucidSonicDreams-recipe baseline) predicts a latent + noise sequence, a
low-resolution video is rendered, 12 video-feature and 9 audio-feature
matrices are extracted, and the audio-reactivity correlation (1 -
orthogonal procrustes distance) is recorded, overall and for every audio x
video feature pair.  One JSON per (clip, model) under ``out_dir`` makes a
sweep resumable: an existing one is read, not recomputed.  A (clip, model)
that raises is reported and skipped so that a long sweep goes on; callers
that need every record check the count.

Everything runs on the generator's device (``G.mapper.device``).  Draws go
through ``generate/keys.py`` on the CPU and move to that device.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from ..audio import features as AF
from ..generate import keys
from ..ops.resize import resize
from ..train.losses import audio_reactive_loss
from ..video import features as VF

AFNS = [AF.chromagram, AF.tonnetz, AF.mfcc, AF.spectral_contrast, AF.rms, AF.drop_strength,
        AF.onsets, AF.spectral_flatness, AF.pulse]
VFNS = [VF.rgb_hist, VF.hsv_hist, VF.video_spectrogram,
        lambda v: VF.directogram(VF.optical_flow(v)),
        VF.low_freq_rms, VF.mid_freq_rms, VF.high_freq_rms, VF.adaptive_freq_rms,
        VF.absdiff, VF.visual_variance, VF.video_flow_onsets, VF.video_spectral_onsets]
VFN_NAMES = ["rgb_hist", "hsv_hist", "video_spectrogram", "directogram", "low_freq_rms",
             "mid_freq_rms", "high_freq_rms", "adaptive_freq_rms", "absdiff",
             "visual_variance", "video_flow_onsets", "video_spectral_onsets"]


def _audio(audio, device) -> torch.Tensor:
    a = audio if torch.is_tensor(audio) else torch.as_tensor(np.asarray(audio, np.float32))
    return a.to(device, torch.float32)


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


class RandomGenerator:
    """Random-patch predictor.  The music information retrieval is a pure
    function of the audio and dominates the cost, so it is memoised per clip
    (by a digest of the samples); its host seconds are kept in
    ``mir_seconds``.  The palette is ``G.mapper`` of 180 z's drawn from
    ``PRNGKey(seed)`` on the CPU."""

    def __init__(self, G, fps: int = 24, seed: int | None = None):
        self.G, self.fps, self.seed = G, fps, seed
        self._mir_cache: dict = {}
        self.mir_seconds: list = []

    def _mir(self, audio, sr):
        import hashlib

        a = np.ascontiguousarray(audio.cpu().numpy() if torch.is_tensor(audio) else np.asarray(audio))
        key = (a.shape, int(sr), hashlib.sha1(a.tobytes()).hexdigest())
        if key not in self._mir_cache:
            from ..generate.mir import retrieve_music_information

            t0 = time.time()
            self._mir_cache[key] = retrieve_music_information(a, sr, device=self.G.mapper.device)
            self.mir_seconds.append(round(time.time() - t0, 1))
        return self._mir_cache[key]

    def predict(self, audio, sr, palette=None, interp=None):
        from ..generate.patch import Patch

        features, segmentations, tempo = self._mir(audio, sr)
        seed = self.seed if self.seed is not None else int(np.random.randint(0, 2**31))
        patch = Patch(features=features, segmentations=segmentations, tempo=tempo, seed=seed, fps=self.fps)
        if palette is None:
            palette = self.G.mapper(keys.normal(keys.PRNGKey(seed), (180, 512)))
        return patch.forward(palette)


class SupervisedSequenceModel:
    """A trained reactor (``models.reactor.LatentNoiseReactor``, e.g. from
    ``train.evaluate.load_checkpoint``) as a predictor; its base noise is
    seeded 0.  With ``residual`` the latents are re-centred on ``interp`` or
    on ``G.mapper`` of the z of ``PRNGKey(1)``."""

    def __init__(self, model, fps: int = 24, residual: bool = False, G=None):
        self.model, self.fps, self.residual, self.G = model, fps, residual, G

    @torch.no_grad()
    def predict(self, audio, sr, palette=None, interp=None):
        from ..audio.features import audio2features

        device = next(self.model.parameters()).device
        feats = audio2features(_audio(audio, device), int(sr), self.fps, device=device)
        self.model.eval()
        latents, noise = self.model(feats[None], generator=torch.Generator(device).manual_seed(0))
        latents = latents[0]
        if self.residual:
            if interp is not None:
                latents = latents + torch.as_tensor(interp, device=device)[: latents.shape[0]]
            elif self.G is not None:
                latents = latents + self.G.mapper(keys.normal(keys.PRNGKey(1), (1, 512)))[0].to(device)
        return latents, [n[0] for n in noise]


class SelfSupervisedOptimization:
    """Per-track test-time optimization, the comparison's variant of the
    optimizer: 512 steps of the weighted per-feature orthogonal procrustes
    objective (the measure the study scores), no gradient normalisation, a
    3 x 3 x 3 latent split and 5 noise envelopes, on `device` (the CUDA
    device unless given).  ``lambda_amplitude`` (0 by default) adds the
    optimizer's motion-amplitude prior.  Each call's loss curve is kept in
    ``loss_curves``."""

    WEIGHT_BOOSTS = {"onsets": 3.0, "rms": 10.0, "rosa_segmentation": 2.0, "drop_strength": 10.0}

    def __init__(self, fps: int = 24, n_steps: int = 512, gan_config=None, model_file=None,
                 objective: str = "procrustes", lambda_amplitude: float = 0.0, target_latent_step: float = 0.048,
                 device: str | torch.device | None = None):
        self.fps, self.n_steps = fps, n_steps
        self.gan_config, self.model_file = gan_config, model_file
        self.objective = objective
        self.lambda_amplitude = lambda_amplitude
        self.target_latent_step = target_latent_step
        self.device = device
        self.log_steps = 16
        self.loss_curves: list = []

    def predict(self, audio, sr, palette=None, interp=None, n_params: int = 128,
                emphasize_feature: str | None = None, use_audio_segmentation_features: bool = True):
        from ..generate.optimize import optimize

        audio = audio.cpu().numpy() if torch.is_tensor(audio) else np.asarray(audio)
        _, latents, noise, losses = optimize(
            audio=audio, sr=int(sr), fps=self.fps, n_steps=self.n_steps, n_params=n_params,
            gan_config=self.gan_config, n_latent_split=3, n_latent_groups=3, n_latent_per_group=3, n_noise=5,
            objective=self.objective, norm_grads=False, model_file=self.model_file, render=False,
            palette=palette, interp=interp, emphasize_feature=emphasize_feature,
            use_audio_segmentation_features=use_audio_segmentation_features,
            feature_weight_boosts=self.WEIGHT_BOOSTS, log_steps=self.log_steps,
            lambda_amplitude=self.lambda_amplitude, target_latent_step=self.target_latent_step, device=self.device)
        self.loss_curves.append(losses)
        return latents, noise


def _is_lazy(noise) -> bool:
    return noise is not None and len(noise) > 0 and callable(noise[0]) and not torch.is_tensor(noise[0])


def _duplicated_pyramid(noise) -> list:
    """Arrays (T, s, s) or (T, 1, s, s) -> the per-layer (T, 1, s, s) noises
    (n0, n1, n1, n2, n2, ...)."""
    nchw = [n[:, None] if n.ndim == 3 else n for n in (torch.as_tensor(n) for n in noise)]
    return [nchw[0]] + [n for nn in nchw[1:] for n in (nn, nn)]


def _fit_rows(latents: torch.Tensor, n_latent: int) -> torch.Tensor:
    """W+ latents with at least the synthesis's `n_latent` rows: missing rows
    repeat the last one, as the JAX package's clamped indexing reads them (the
    optimizer's 3-way split of a 256 px model's 14 rows predicts 12)."""
    short = n_latent - latents.shape[1]
    return latents if short <= 0 else torch.cat([latents, latents[:, -1:].expand(-1, short, -1)], dim=1)


@torch.no_grad()
def _render_lowres(G, latents, noise, batch_size: int = 16, size: int = 128) -> torch.Tensor:
    """Render, clip to [0, 1] and resize (bilinear, antialiased) to
    (T, C, size, size) for feature extraction, on G's device."""
    device = G.mapper.device
    latents = _fit_rows(torch.as_tensor(latents).to(device), G.config.n_latent)
    T = latents.shape[0]
    lazy = _is_lazy(noise)
    pyramid = None if noise is None or lazy else [p.to(device) for p in _duplicated_pyramid(noise)]
    n_used = G.synthesizer.n_noises_used
    frames = []
    for i in range(0, T, batch_size):
        L = latents[i : i + batch_size]
        b = L.shape[0]
        kw = {}
        if lazy:
            kw = {f"noise{j}": nm.forward(i, b)[:, None] for j, nm in enumerate(noise[:n_used])}
        elif pyramid is not None:
            kw = {f"noise{j}": p[i : i + b] for j, p in enumerate(pyramid[:n_used])}
        f = torch.clamp((G.synthesizer(L, **kw) + 1) / 2, 0, 1)
        frames.append(resize(f, (b, size, size, 3), method="bilinear"))
    return torch.cat(frames).permute(0, 3, 1, 2)


def _materialized_noise(noise, T: int, max_size: int = 64) -> list:
    """Noise predictions as (T, ...) tensors for latent-space scoring; lazy
    patch noises are materialised up to ``max_size`` pixels wide (the width
    is read from the noise first, so wider ones are never computed)."""
    if noise is None:
        return []
    out = []
    for n in noise:
        if callable(n) and not torch.is_tensor(n):
            if n.size[-1] > max_size:
                continue
            n = n.forward(0, T)
        out.append(torch.as_tensor(n))
    return out


def _pair_records(afeats: dict, vfeats: dict) -> dict:
    """1 - procrustes distance of all features together and of every
    (audio, video) pair, read back in one copy."""
    names = ["correlation"] + [f"{an}|{vn}" for an in afeats for vn in vfeats]
    losses = [audio_reactive_loss(afeats, vfeats)[0]]
    losses += [audio_reactive_loss([af], [vf])[0] for af in afeats.values() for vf in vfeats.values()]
    return dict(zip(names, (1 - torch.stack(losses)).tolist()))


def evaluate_clip(G, model, audio, sr) -> dict:
    """One (model, clip) evaluation -> a correlation record.

    Besides the video-feature correlations, each record carries the same
    correlation computed on the predicted latent / noise sequences
    (``latent_correlation``) and the mean latent and pixel frame-to-frame
    steps (does a model's score follow how much its video moves at all?).
    The prediction runs in the caller's grad mode (test-time optimization
    needs gradients), the scoring without.
    """
    device = G.mapper.device
    latents, noise = model.predict(audio, sr)
    with torch.no_grad():
        video = _render_lowres(G, latents, noise)
        audio_t = _audio(audio, device)
        vfeats = {name: fn(video)[None] for name, fn in zip(VFN_NAMES, VFNS)}
        afeats = {fn.__name__: fn(audio_t, int(sr))[None] for fn in AFNS}
        record = _pair_records(afeats, vfeats)

        T = int(latents.shape[0])
        lat = torch.as_tensor(latents).to(device).reshape(T, -1)
        lfeats = {"latents": lat[None]}
        for j, n in enumerate(_materialized_noise(noise, T)):
            lfeats[f"noise{j}"] = n.to(device).reshape(T, -1)[None]
        extra = torch.stack([1 - audio_reactive_loss(afeats, lfeats)[0], lat.diff(dim=0).abs().mean(),
                             video.diff(dim=0).abs().mean()]).tolist()
    record.update(zip(("latent_correlation", "mean_latent_step", "mean_pixel_step"), extra))
    return record


def _write_csv(records: list, path: Path) -> None:
    try:
        import pandas as pd
    except ImportError:
        return
    pd.DataFrame(records).to_csv(path)


def compare_models(name: str, models: dict, clips: list, G, out_dir: str = "output", forward_only: bool = False):
    """models: {model_name: predictor}; clips: [(clip_name, audio, sr), ...].

    One JSON per (clip, model), read back where it exists; returns the
    records and writes ``<out_dir>/<name>.csv`` (with pandas).
    ``forward_only=True`` records only the model's forward wall time per
    clip (synchronised with the device), the inference-speed benchmark.
    """
    out = Path(out_dir) / name
    out.mkdir(parents=True, exist_ok=True)
    records = []
    for clip_name, audio, sr in clips:
        for model_name, model in models.items():
            item = out / f"{clip_name}_{model_name}.json"
            if item.exists():
                records.append(json.loads(item.read_text()))
                continue
            try:
                t0 = time.time()
                if forward_only:
                    latents, _ = model.predict(audio, sr)
                    _sync(latents)
                    rec = {"n": int(audio.shape[-1] // 1024), "time": time.time() - t0}
                else:
                    rec = evaluate_clip(G, model, audio, sr)
            except Exception as e:  # a failed pair is reported and skipped: long sweeps go on
                print(f"ERROR {clip_name}/{model_name}: {type(e).__name__}: {e}")
                continue
            rec.update({"clip": clip_name, "model_name": model_name, "wall_s": round(time.time() - t0, 1)})
            item.write_text(json.dumps(rec))
            records.append(rec)
            tag = (f"{rec['n'] / max(rec['time'], 1e-9):.1f} frames/s" if forward_only
                   else f"correlation {rec['correlation']:.4f}")
            print(f"{clip_name}/{model_name}: {tag}")
    _write_csv(records, out.with_suffix(".csv"))
    return records


class LucidSonicBaseline:
    """The LucidSonicDreams recipe as a predictor: palette keyframes
    interpolated at ``speed_fpm``, an onset-scaled pulse along a fixed
    direction, and a harmonic-energy-modulated random walk, all gaussian
    smoothed, then mapped by ``G.mapper`` (or repeated over 18 W+ rows when
    ``G`` is None)."""

    def __init__(self, G, fps: int = 24, speed_fpm: int = 12, pulse_react: float = 0.5, motion_react: float = 0.5,
                 seed: int = 0, device: str | torch.device | None = None):
        self.G, self.fps, self.speed_fpm = G, fps, speed_fpm
        self.pulse_react, self.motion_react, self.seed = pulse_react, motion_react, seed
        self.device = G.mapper.device if G is not None else device

    @torch.no_grad()
    def predict(self, audio, sr, palette=None, interp=None):
        from ..generate.latent import linspace
        from ..ops.gaussian import gaussian_filter
        from ..utils.device import resolve_device

        device = resolve_device(self.device)
        audio = _audio(audio, device)
        T = int(audio.shape[-1] // 1024)
        k_base, k_pulse, k_motion = keys.split(keys.PRNGKey(self.seed), 3)

        n_key = max(2, int(round(self.speed_fpm * T / (self.fps * 60))) + 1)
        zs = keys.normal(k_base, (n_key, 512)).to(device)
        pos = linspace(n_key - 1, T, device)   # XLA's float32 linspace, as jnp.linspace(0, n_key - 1, T)
        i0 = torch.clamp(torch.floor(pos).long(), 0, n_key - 2)
        frac = (pos - i0)[:, None]
        z = gaussian_filter(zs[i0] * (1 - frac) + zs[i0 + 1] * frac, self.fps / 4)

        onset = AF.onsets(audio, int(sr))[:T, 0]
        pulse_dir = keys.normal(k_pulse, (512,)).to(device)
        z = z + self.pulse_react * onset[:, None] * pulse_dir[None]

        harm_env = AF.rms(AF.harmonic(audio), int(sr))[:T, 0]
        steps = gaussian_filter(keys.normal(k_motion, (T, 512)).to(device), 4)
        z = z + self.motion_react * torch.cumsum(harm_env[:, None] * steps, dim=0) / np.sqrt(np.float32(T))

        latents = self.G.mapper(z) if self.G is not None else z[:, None, :].expand(T, 18, 512)
        return latents, None


def evaluate_trained_checkpoint_dirs(run_dirs, name: str, clips, G, n_ckpts: int = 1, out_dir: str = "output"):
    """Correlation sweep over training runs x checkpoint steps x clips.

    ``run_dirs`` are the port's trainer's run directories (``config.json``
    and ``ckpt/step_*.pt``); each model is rebuilt from its stored flags on
    G's device.  ``n_ckpts`` evenly spaced steps are evaluated per run
    (always including the last).  One JSON per job, read back where it
    exists; returns the records and writes ``<out_dir>/<name>.csv``.
    """
    from ..train.evaluate import checkpoint_steps, load_checkpoint

    out = Path(out_dir) / name
    out.mkdir(parents=True, exist_ok=True)
    records = []
    for run_dir in run_dirs:
        run_dir = Path(run_dir)
        cfg = json.loads((run_dir / "config.json").read_text())
        steps = checkpoint_steps(run_dir)
        if n_ckpts > 1:
            sel = np.linspace(0, len(steps) - 1, min(n_ckpts, len(steps))).round().astype(int)
            steps = [steps[i] for i in sorted(set(sel.tolist()))]
        else:
            steps = steps[-1:]
        for step in steps:
            model, _ = load_checkpoint(str(run_dir), step=step, device=G.mapper.device)
            predictor = SupervisedSequenceModel(model, residual=cfg.get("residual", False), G=G)
            for clip_name, audio, sr in clips:
                item = out / f"{run_dir.name}_step{step}_{clip_name}.json"
                if item.exists():
                    records.append(json.loads(item.read_text()))
                    continue
                try:
                    rec = evaluate_clip(G, predictor, audio, sr)
                except Exception as e:  # a failed job is reported and skipped: sweeps go on
                    print(f"ERROR {run_dir.name}/step{step}/{clip_name}: {type(e).__name__}: {e}")
                    continue
                rec.update({"run": run_dir.name, "clip": clip_name, "steps": int(step),
                            **{k: cfg[k] for k in ("backbone", "loss", "decoder", "residual", "n_latent_split",
                                                   "hidden_size", "num_layers", "dropout", "lr") if k in cfg}})
                item.write_text(json.dumps(rec))
                records.append(rec)
                print(f"{run_dir.name}/step{step}/{clip_name}: {rec['correlation']:.4f}")
    _write_csv(records, Path(out_dir) / f"{name}.csv")
    return records


@torch.no_grad()
def from_video_dir(videos, name: str, out_dir: str = "output", downsample: int = 4,
                   device: str | torch.device | None = None):
    """Audio-reactivity correlation of existing videos, on `device` (the CUDA
    device unless given).  ``videos``: [(clip_name, video, audio, sr)], video
    an .mp4 path (decoded by cv2) or a (T, C, H, W) array in [0, 1].  The
    video features are resampled linearly along time to the audio features'
    frame count.  One JSON per clip, read back where it exists, and a CSV."""
    from ..utils.device import resolve_device
    from .sectional import load_video

    device = resolve_device(device)
    out = Path(out_dir) / name
    out.mkdir(parents=True, exist_ok=True)
    records = []
    for clip_name, video, audio, sr in videos:
        item = out / f"{clip_name}.json"
        if item.exists():
            records.append(json.loads(item.read_text()))
            continue
        if isinstance(video, (str, Path)):
            video, _fps = load_video(str(video), downsample=downsample, device=device)
        video = torch.as_tensor(np.asarray(video) if not torch.is_tensor(video) else video,
                                dtype=torch.float32).to(device)
        vfeats = {n: fn(video)[None] for n, fn in zip(VFN_NAMES, VFNS)}
        audio_t = _audio(audio, device)
        afeats = {fn.__name__: fn(audio_t, int(sr))[None] for fn in AFNS}
        length = next(iter(afeats.values())).shape[1]
        vfeats = {k: resize(v, (1, length, v.shape[2]), method="linear") for k, v in vfeats.items()}
        rec = {"clip": clip_name, **_pair_records(afeats, vfeats)}
        item.write_text(json.dumps(rec))
        records.append(rec)
        print(f"{clip_name}: correlation {rec['correlation']:.4f}")
    _write_csv(records, Path(out_dir) / f"{name}.csv")
    return records


def supplementary_material(G, clips, models: dict | None = None, out_dir: str = "output/suppmat",
                           duration: float | None = 90.0, fps: int = 24, size: int = 256, batch_size: int = 16):
    """Render showcase videos for every model on every clip: all models share
    a seeded 30-latent palette and a gaussian-smoothed random W walk
    ``interp`` per clip, rendered at ``size`` px.  Existing files are
    skipped.  Returns the paths."""
    from ..gan.render import render_latents_to_video
    from ..ops.gaussian import gaussian_filter

    device = G.mapper.device
    if models is None:
        models = {"Randomizer": RandomGenerator(G, fps=fps, seed=42),
                  "HiPPO": SelfSupervisedOptimization(fps=fps, device=device),
                  "LucidSonicDreams": LucidSonicBaseline(G, fps=fps)}
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    outputs = []
    for f, (clip_name, audio, sr) in enumerate(clips):
        audio = audio.cpu().numpy() if torch.is_tensor(audio) else np.asarray(audio)
        if duration is not None:
            audio = audio[: int(duration * sr)]
        T = int(audio.shape[-1] // 1024)
        for i, (model_name, model) in enumerate(models.items()):
            outfile = out / f"{model_name}_{clip_name}_{i}.mp4"
            if outfile.exists():
                outputs.append(str(outfile))
                continue
            k1, k2 = keys.split(keys.PRNGKey(42 + f * len(models) + i))
            palette = G.mapper(keys.normal(k1, (30, 512)))
            interp = G.mapper(gaussian_filter(keys.normal(k2, (T, 512)).to(device), 40))
            latents, noise = model.predict(audio, sr, palette=palette, interp=interp)
            if _is_lazy(noise):
                noise = [nm.forward(0, latents.shape[0])[:, None] for nm in noise]
            elif noise is not None and len(noise):
                noise = _duplicated_pyramid(noise)
            render_latents_to_video(G.synthesizer, _fit_rows(torch.as_tensor(latents).to(device), G.config.n_latent),
                                    noise[: G.synthesizer.n_noises_used] if noise else None,
                                    str(outfile), fps=fps, batch_size=batch_size, output_size=(size, size),
                                    progress=False)
            outputs.append(str(outfile))
            print(f"wrote {outfile}")
    return outputs
