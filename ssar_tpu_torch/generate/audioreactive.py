"""Audioreactive patch-authoring API and the randomized patch pipeline.

Counterpart of ``ssar_tpu/generate/audioreactive.py``:

- signal shaping: ``compress`` / ``expand``, ``percentile_clip``,
  ``gaussian_filter`` (re-exported; ``causal=`` is taken and not used);
- frame-rate envelopes with authoring knobs: ``onsets``, ``volume``,
  ``rms``, ``chroma``, ``tonnetz``, ``pitch_track``, ``tempo``,
  ``laplacian_segmentation``;
- latent loops: ``slerp_loops`` / ``spline_loops`` / ``gaussian_loops`` /
  ``constant_loops``, synced to the tempo by ``TempoLoopLatents``;
- reactive primitives: ``ModulatedLatents``, ``ModulatedNoise``,
  ``PitchTrackLatents``, ``TempoLoopLatents``, ``TempoLoopNoise``,
  ``TonalLatents``, ``TonalNoise``, ``chroma_weight_latents``,
  ``perlin_noise``, ``circular_mask``;
- ``RandomPatch``: a seeded audio source -> band filter -> feature ->
  postprocess -> latent or noise target;
- network bends: ``AddNoise``, ``replication_pad``, ``sequential``, on the
  NCHW activations the port's synthesis hands its bends;
- the patch-file contract: a module defining ``initialize(args)`` /
  ``get_latents(selection, args)`` and optionally ``get_noise(height,
  width, scale, num_scales, args)``, ``get_bends(args)`` and
  ``get_truncation(args)``, run (and rendered) by ``render_patch``.

Envelopes are computed on the device of the audio they are given.  Random
draws go through ``keys`` (``RandomPatch``'s structure draws are numpy's
``RandomState``, as in the JAX package, so its choices are the same).
"""
from __future__ import annotations

import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..audio import features as AF
from ..audio.beat import onset_strength
from ..audio.beat_host import estimate_tempo
from ..audio.processing import normalize
from ..metrics.rhythmic import percentile_clip
from ..ops.gaussian import gaussian_filter
from ..ops.iir import high_pass, low_pass, mid_pass
from ..ops.resize import resize
from ..utils.device import full_precision, resolve_device
from . import keys
from .latent import linspace, spline_loop_latents

__all__ = [
    "compress", "expand", "normalize", "percentile_clip", "gaussian_filter",
    "onsets", "volume", "rms", "chroma", "tonnetz", "pitch_track", "tempo",
    "laplacian_segmentation",
    "load_audio", "load_latents", "generate_latents", "wrapping_slice",
    "perlin_noise", "circular_mask", "plot_signals", "plot_spectra",
    "slerp_loops", "spline_loops", "gaussian_loops", "constant_loops",
    "ModulatedLatents", "ModulatedNoise", "PitchTrackLatents",
    "TempoLoopLatents", "TempoLoopNoise", "TonalLatents", "TonalNoise",
    "chroma_weight_latents",
    "RandomPatch", "render_patch", "load_patch_module",
    "AddNoise", "replication_pad", "sequential",
]


def _f32(x, device=None) -> torch.Tensor:
    """`x` as a float32 tensor (on `device` when given, else where it is)."""
    x = torch.as_tensor(np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x, dtype=torch.float32)
    return x if device is None else x.to(device)


# ---------------------------------------------------------------- loading --
def load_audio(audio_file: str, offset: float = 0.0, duration: float | None = None, device=None):
    """Mono waveform slice -> (audio, sr, duration in seconds): the reference
    patches' ``audio, sr, dur = ar.load_audio(path, offset, duration)``.  The
    waveform is a float32 tensor on the CUDA device unless `device` says
    otherwise."""
    from ..train.data import load_audio as _load

    audio, sr = _load(audio_file)
    audio = audio[int(offset * sr):]
    if duration is not None:
        audio = audio[: int(duration * sr)]
    return _f32(audio, resolve_device(device)), int(sr), audio.shape[-1] / sr


def load_latents(path: str, device=None) -> torch.Tensor:
    """(K, n_ws, 512) W+ keyframes from a .npy / .npz file (the first array
    of an .npz), on `device` (the CPU when None)."""
    arr = np.load(path, allow_pickle=False)
    if hasattr(arr, "files"):
        arr = arr[arr.files[0]]
    return _f32(arr, device)


def generate_latents(n_latents: int, model_file: str | None = None, seed: int = 0,
                     gan_config=None, device=None) -> torch.Tensor:
    """n fresh W+ keyframes through the mapper, on the CUDA device unless
    `device` says otherwise."""
    from ..gan.wrapper import StyleGAN2Mapper

    mapper = StyleGAN2Mapper(model_file=model_file, config=gan_config, device=device)
    return mapper(keys.normal(keys.PRNGKey(seed), (n_latents, 512), device=mapper.device))


def wrapping_slice(tensor, start: int, length: int, dim: int = 0) -> torch.Tensor:
    """Length-`length` slice from `start` along `dim` that wraps around the end."""
    tensor = torch.as_tensor(tensor)
    idx = torch.remainder(torch.arange(start, start + length, device=tensor.device), tensor.shape[dim])
    return tensor.index_select(dim, idx)


# ------------------------------------------------------------ signal ops --
def compress(x: torch.Tensor, threshold: float = 0.5, ratio: float = 0.5) -> torch.Tensor:
    """Downward compression of a [0, 1] envelope above `threshold`."""
    x = normalize(x)
    over = torch.clamp(x - threshold, min=0.0)
    return normalize(torch.where(x > threshold, threshold + over * ratio, x))


def expand(x: torch.Tensor, threshold: float = 0.5, ratio: float = 2.0) -> torch.Tensor:
    """Upward expansion of a [0, 1] envelope above `threshold`."""
    x = normalize(x)
    over = torch.clamp(x - threshold, min=0.0)
    return normalize(torch.where(x > threshold, threshold + over * ratio, x))


def _to_frames(env: torch.Tensor, n_frames: int) -> torch.Tensor:
    """A (T, ...) envelope resampled (linearly) to n_frames on the time axis."""
    env = _f32(env)
    if env.shape[0] == n_frames:
        return env
    return resize(env, (n_frames,) + tuple(env.shape[1:]), method="linear")


# --------------------------------------------------- feature envelopes --
def onsets(audio, sr: int, n_frames: int, fmin: float | None = None, fmax: float | None = None,
           clip: float | None = None, smooth: float = 1.0, power: float = 1.0) -> torch.Tensor:
    """Onset-strength envelope, (n_frames,) in [0, 1]: optional band
    (high-pass at `fmin`, low-pass at `fmax`), percentile clip, gaussian
    smoothing, exponent."""
    audio = _f32(audio)
    with torch.no_grad(), full_precision():
        if fmin is not None:
            audio = high_pass(audio, sr, fmin=fmin)
        if fmax is not None:
            audio = low_pass(audio, sr, fmax=fmax)
        env = _to_frames(AF.onsets(audio, int(sr))[:, 0], n_frames)
    if clip is not None:
        env = percentile_clip(env, clip)
    if smooth:
        env = gaussian_filter(env, smooth, causal=0.0)
    return normalize(env) ** power


def volume(audio, sr: int, n_frames: int, smooth: float = 1.0) -> torch.Tensor:
    env = _to_frames(AF.rms(_f32(audio), int(sr))[:, 0], n_frames)
    if smooth:
        env = gaussian_filter(env, smooth)
    return normalize(env)


def rms(audio, sr: int, n_frames: int, fmin: float | None = None, fmax: float | None = None,
        smooth: float = 1.0, clip: float | None = None, power: float = 1.0) -> torch.Tensor:
    """Normalised RMS loudness envelope, (n_frames,) in [0, 1], with an
    optional band, smoothing, percentile clip and exponent;
    ``ar.rms(audio, sr, n, smooth=100) ** 2`` is the reference's drop weight."""
    audio = _f32(audio)
    with torch.no_grad(), full_precision():
        if fmin is not None and fmax is not None:
            audio = mid_pass(audio, sr, fmin=fmin, fmax=fmax)
        elif fmin is not None:
            audio = high_pass(audio, sr, fmin=fmin)
        elif fmax is not None:
            audio = low_pass(audio, sr, fmax=fmax)
        env = _to_frames(AF.rms(audio, int(sr))[:, 0], n_frames)
    if clip is not None:
        env = percentile_clip(env, clip)
    if smooth:
        env = gaussian_filter(env, smooth)
    return normalize(env) ** power


def laplacian_segmentation(audio, sr: int, n_frames: int, ks=(2, 4, 6, 8, 16)) -> torch.Tensor:
    """(n_frames, len(ks)) int64 section labels, one column per k, from the
    CQT-driven segmentation (``audio/segment.py``), on the audio's device."""
    from ..audio.segment import laplacian_segmentation_rosa

    audio = _f32(audio)
    labels = laplacian_segmentation_rosa(audio, sr, n_frames, ks=ks)
    return torch.as_tensor(labels, device=audio.device)


def chroma(audio, sr: int, n_frames: int, type: str = "cens", nearest_neighbor: bool = False) -> torch.Tensor:
    """(n_frames, 12) chromagram; `nearest_neighbor` one-hot encodes each
    frame's largest class.  `type` is taken and not used: CENS is the one
    flavour, as in the JAX package."""
    with torch.no_grad(), full_precision():
        ch = _to_frames(AF.chromagram(_f32(audio), int(sr)), n_frames)
    if nearest_neighbor:
        ch = F.one_hot(ch.argmax(dim=1), ch.shape[1]).to(ch.dtype)
    return ch


def tonnetz(audio, sr: int, n_frames: int, **kw) -> torch.Tensor:
    with torch.no_grad(), full_precision():
        return _to_frames(AF.tonnetz(_f32(audio), int(sr)), n_frames)


def pitch_track(audio, sr: int, n_frames: int, smooth: float = 4.0) -> torch.Tensor:
    """(n_frames,) predominant pitch class in [0, 12) from piptrack."""
    from ..audio.pitch import piptrack

    with torch.no_grad(), full_precision():
        pitches, mags, pmask = piptrack(_f32(audio), int(sr))
    w = torch.where(pmask, mags, torch.zeros_like(mags))
    idx = w.argmax(dim=0)
    hz = torch.gather(pitches, 0, idx[None])[0].clamp(min=1e-3)
    pc = _to_frames(torch.remainder(12.0 * torch.log2(hz / 440.0) + 69.0, 12.0), n_frames)
    if smooth:
        pc = gaussian_filter(pc, smooth)
    return pc


def tempo(audio, sr: int, prior: str = "lognormal") -> float:
    """Global tempo in BPM (host, one number a track); ``prior="uniform"``
    flattens the log-normal prior."""
    with torch.no_grad(), full_precision():
        env = onset_strength(_f32(audio), int(sr)).cpu().numpy()
    prior_s = 1.0 if prior == "lognormal" else 1e6
    return float(estimate_tempo(env, sr=sr, hop_length=1024, prior_s=prior_s))


# ----------------------------------------------------------- latent loops --
def _slerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation of each frame's pair (a[i], b[i]) at t[i]; the
    angle is taken between whole (n_ws, 512) latents."""
    an = a / (torch.linalg.vector_norm(a, dim=(1, 2), keepdim=True) + 1e-12)
    bn = b / (torch.linalg.vector_norm(b, dim=(1, 2), keepdim=True) + 1e-12)
    omega = torch.arccos(torch.clamp((an * bn).sum(dim=(1, 2), keepdim=True), -1 + 1e-7, 1 - 1e-7))
    so = torch.sin(omega)
    t = t[:, None, None]
    return (torch.sin((1 - t) * omega) * a + torch.sin(t * omega) * b) / so


def slerp_loops(latent_selection, n_frames: int, n_loops: float = 1.0, smoothing: float = 1.0,
                loop: bool = True) -> torch.Tensor:
    """Spherically interpolated loop through W+ keyframes: (K, n_ws, 512) ->
    (n_frames, n_ws, 512)."""
    sel = _f32(latent_selection)
    if loop:
        sel = torch.cat([sel, sel[:1]], dim=0)
    K = sel.shape[0]
    pos = torch.remainder(linspace((K - 1) * n_loops, n_frames, sel.device), K - 1 + 1e-6)
    i0 = torch.clamp(torch.floor(pos).long(), 0, K - 2)
    frac = pos - i0
    out = _slerp(sel[i0], sel[i0 + 1], frac)
    if smoothing:
        out = gaussian_filter(out, smoothing)
    return out


def spline_loops(latent_selection, n_frames: int, n_loops: float = 1.0, smoothing: float = 0.0) -> torch.Tensor:
    out = spline_loop_latents(_f32(latent_selection), n_frames, n_loops)
    if smoothing:
        out = gaussian_filter(out, smoothing)
    return out


def gaussian_loops(latent_selection, n_frames: int, n_loops: float = 1.0, smoothing: float = 8.0) -> torch.Tensor:
    """Gaussian-smoothed nearest-keyframe loop."""
    sel = _f32(latent_selection)
    K = sel.shape[0]
    idx = torch.remainder(torch.floor(linspace(K * n_loops, n_frames, sel.device)), K).long()
    return gaussian_filter(sel[idx], smoothing, mode="circular")


def constant_loops(latent_selection, n_frames: int, n_loops: float = 1.0, smoothing: float = 0.0) -> torch.Tensor:
    sel = _f32(latent_selection)
    return sel[:1].repeat(n_frames, *([1] * (sel.ndim - 1)))


LOOP_TYPES = {"slerp": slerp_loops, "spline": spline_loops,
              "gaussian": gaussian_loops, "constant": constant_loops}


# ------------------------------------------------------------- primitives --
def ModulatedLatents(envelope: torch.Tensor, base: torch.Tensor, modulation) -> torch.Tensor:
    """(1 - env) * base + env * modulation: envelope (T,), base (T, n_ws,
    512), modulation (n_ws, 512) or (T, n_ws, 512)."""
    env = envelope[:, None, None]
    modulation = _f32(modulation, base.device)
    if modulation.ndim == 2:
        modulation = modulation[None]
    return (1 - env) * base + env * modulation


def ModulatedNoise(envelope: torch.Tensor, base: torch.Tensor, modulation: torch.Tensor) -> torch.Tensor:
    """(1 - env) * base + env * modulation, (T, H, W)."""
    env = envelope[:, None, None]
    return (1 - env) * base + env * modulation


def PitchTrackLatents(pitch_classes: torch.Tensor, palette: torch.Tensor, smoothing: float = 4.0) -> torch.Tensor:
    """Each frame's pitch class selects (interpolates) palette latents."""
    K = palette.shape[0]
    pos = pitch_classes / 12.0 * K
    i0 = torch.clamp(torch.floor(pos).long(), 0, K - 1)
    i1 = torch.remainder(i0 + 1, K)
    frac = (pos - i0)[:, None, None]
    out = palette[i0] * (1 - frac) + palette[i1] * frac
    return gaussian_filter(out, smoothing) if smoothing else out


def TempoLoopLatents(bpm: float, palette: torch.Tensor, n_frames: int, fps: float = 24, n_bars: int = 4,
                     type: str = "spline", smooth: float = 4.0) -> torch.Tensor:
    """A loop through the palette once every `n_bars` bars of 4/4 at `bpm`."""
    frames_per_loop = n_bars * 4 * 60.0 / bpm * fps
    n_loops = max(n_frames / max(frames_per_loop, 1e-6), 1e-3)
    return LOOP_TYPES[type](palette, n_frames, n_loops, smooth)


def TempoLoopNoise(key, bpm: float, size: tuple[int, int], n_frames: int, fps: float = 24, n_bars: int = 4,
                   smooth: float = 4.0, device=None) -> torch.Tensor:
    """Noise loop synced to the tempo: a spline loop through 4 noise
    keyframes drawn on `device` (the CPU when None), (n_frames, H, W)."""
    frames_per_loop = n_bars * 4 * 60.0 / bpm * fps
    n_loops = max(n_frames / max(frames_per_loop, 1e-6), 1e-3)
    keyframes = keys.normal(key, (4,) + tuple(size), device=device)
    out = spline_loop_latents(keyframes.reshape(4, -1), n_frames, n_loops).reshape((n_frames,) + tuple(size))
    return gaussian_filter(out, smooth) if smooth else out


def TonalLatents(chromagram: torch.Tensor, palette: torch.Tensor) -> torch.Tensor:
    """Chroma-weighted palette mix, einsum("TC,CNL->TNL")."""
    ch = chromagram / (chromagram.sum(dim=1, keepdim=True) + 1e-8)
    C = ch.shape[1]
    return torch.einsum("TC,CNL->TNL", ch, palette[:C])


def chroma_weight_latents(chroma: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
    """Chroma-weighted average of 12 latent keyframes -> (T, n_ws, 512)."""
    return TonalLatents(_f32(chroma), _f32(latents, _f32(chroma).device))


def perlin_noise(key, shape: tuple[int, int, int], res: tuple[int, int, int], octaves: int = 1,
                 persistence: float = 0.5, device=None) -> torch.Tensor:
    """Smooth fractal (T, H, W) noise on `device` (the CPU when None): a
    normal lattice of `res` cells an axis resized by the Keys cubic; each
    further octave doubles the lattice at `persistence` times the amplitude."""
    key = keys.PRNGKey(key) if isinstance(key, int) else key
    out = torch.zeros(shape, dtype=torch.float32, device=device)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        key, sub = keys.split(key)
        lattice = keys.normal(sub, (min(res[0] * 2**o + 1, shape[0]), min(res[1] * 2**o + 1, shape[1]),
                                    min(res[2] * 2**o + 1, shape[2])), device=device)
        out = out + amp * resize(lattice, shape, method="cubic")
        total += amp
        amp *= persistence
    out = out / total
    return out / (out.std(correction=0) + 1e-8)


def circular_mask(h: int, w: int, center: tuple[int, int] | None = None, radius: float | None = None,
                  soft: float = 0.0, device=None) -> torch.Tensor:
    """(h, w) disc mask in [0, 1]; `soft` > 0 blurs its edge by a gaussian."""
    if center is None:
        center = (w / 2, h / 2)
    if radius is None:
        radius = min(center[0], center[1], w - center[0], h - center[1])
    Y, X = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device), indexing="ij")
    mask = (torch.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2) <= radius).to(torch.float32)
    if soft > 0:
        mask = gaussian_filter(mask, soft, mode="replicate")
        mask = gaussian_filter(mask.T, soft, mode="replicate").T
    return mask


def TonalNoise(key, chromagram: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Chroma-weighted mix of C noise keyframes drawn on the chromagram's
    device, (T, H, W)."""
    C = chromagram.shape[1]
    ch = chromagram / (chromagram.sum(dim=1, keepdim=True) + 1e-8)
    bank = keys.normal(key, (C,) + tuple(size), device=chromagram.device)
    return torch.einsum("TC,Chw->Thw", ch, bank)


# ----------------------------------------------------------- RandomPatch --
_SOURCES = {"full": lambda a, sr: a,
            "harmonic": lambda a, sr: AF.harmonic(a),
            "percussive": lambda a, sr: AF.percussive(a)}
_FILTERS = {"none": lambda a, sr: a,
            "low": lambda a, sr: low_pass(a, sr, fmax=100),
            "low-mid": lambda a, sr: mid_pass(a, sr, fmin=100, fmax=400),
            "mid": lambda a, sr: mid_pass(a, sr, fmin=400, fmax=2000),
            "high-mid": lambda a, sr: mid_pass(a, sr, fmin=2000, fmax=5000),
            "high": lambda a, sr: high_pass(a, sr, fmin=5000)}
_POSTPROCESS = {"none": lambda e, kg: e,
                "smooth": lambda e, kg: gaussian_filter(e, kg.choice([1, 3, 5, 7, 15]),
                                                        causal=kg.choice([1, 0.75, 0.5, 0.25, 0.1, 0])),
                "clip": lambda e, kg: percentile_clip(e, 100 * kg.choice([0.5, 0.75, 0.9, 0.95, 0.975, 0.99])),
                "compress": lambda e, kg: compress(e, kg.choice([0.1, 0.25, 0.5, 0.75, 0.9]),
                                                   kg.choice([0.9, 0.75, 0.666, 0.5])),
                "expand": lambda e, kg: expand(e, kg.choice([0.1, 0.25, 0.5, 0.75, 0.9]),
                                               kg.choice([1.5, 2, 3, 4, 8]))}
_LAYER_BANDS = {"full": (0, 18), "low": (0, 6), "mid": (6, 12), "high": (12, 18)}


class _Rand:
    """Seeded choice helper."""

    def __init__(self, seed: int):
        self.rs = np.random.RandomState(seed)

    def choice(self, opts):
        return opts[int(self.rs.randint(len(opts)))]


class RandomPatch:
    """One randomized audioreactive mapping: audio source -> band filter ->
    feature envelope -> postprocess -> latent or noise target over a band of
    W+ layers."""

    def __init__(self, seed: int = 0, fps: float = 24):
        kg = _Rand(seed)
        self.fps = fps
        self.seed = seed
        self.which_audio = kg.choice(["full", "harmonic", "percussive"])
        self.which_filtering = kg.choice(["none", "low", "low-mid", "mid", "high-mid", "high"])
        self.which_input = kg.choice(["latent", "noise"])
        feats = (["volume", "onsets", "tempo"] if self.which_audio == "percussive"
                 else ["volume", "onsets", "pitch_track", "tempo", "chroma", "tonnetz"])
        if self.which_input == "noise" and "pitch_track" in feats:
            feats.remove("pitch_track")
        self.which_feature = kg.choice(feats)
        self.which_postprocess = ("none" if self.which_feature in ("tempo", "pitch_track")
                                  else kg.choice(list(_POSTPROCESS)))
        self.which_layers = kg.choice(list(_LAYER_BANDS))
        self._kg = kg

    def __repr__(self):
        return (f"RandomPatch(seed={self.seed}, audio={self.which_audio}, "
                f"filter={self.which_filtering}, input={self.which_input}, "
                f"feature={self.which_feature}, post={self.which_postprocess}, "
                f"layers={self.which_layers})")

    def forward(self, audio, sr: int, palette: torch.Tensor, base_latents: torch.Tensor,
                noise_size: tuple[int, int] = (32, 32)):
        """-> ("latent", (T, n_ws, 512)) or ("noise", (T, H, W)), on the
        base latents' device."""
        device = base_latents.device
        n_frames = base_latents.shape[0]
        with torch.no_grad(), full_precision():
            a = _SOURCES[self.which_audio](_f32(audio, device), sr)
            a = _FILTERS[self.which_filtering](a, sr)
        key = keys.PRNGKey(self.seed)

        if self.which_feature == "tempo":
            bpm = tempo(a, sr)
            n_bars = self._kg.choice([1, 2, 4, 8, 16, 32])
            if self.which_input == "latent":
                out = TempoLoopLatents(bpm, palette, n_frames, self.fps, n_bars,
                                       type=self._kg.choice(list(LOOP_TYPES)),
                                       smooth=self._kg.choice([1, 2, 4, 8, 16, 32]))
            else:
                out = TempoLoopNoise(key, bpm, noise_size, n_frames, self.fps, n_bars, device=device)
            return self.which_input, self._band_blend(out, base_latents)

        if self.which_feature == "pitch_track":
            pc = pitch_track(a, sr, n_frames)
            return "latent", self._band_blend(PitchTrackLatents(pc, palette), base_latents)

        if self.which_feature in ("chroma", "tonnetz"):
            ch = chroma(a, sr, n_frames) if self.which_feature == "chroma" else normalize(tonnetz(a, sr, n_frames))
            if self.which_input == "latent":
                return "latent", self._band_blend(TonalLatents(ch, palette), base_latents)
            return "noise", TonalNoise(key, ch, noise_size)

        env = onsets(a, sr, n_frames) if self.which_feature == "onsets" else volume(a, sr, n_frames)
        env = _POSTPROCESS[self.which_postprocess](env, self._kg)
        if self.which_input == "latent":
            mod = palette[self.seed % palette.shape[0]]
            return "latent", self._band_blend(ModulatedLatents(env, base_latents, mod), base_latents)
        base_n = gaussian_filter(keys.normal(key, (n_frames,) + tuple(noise_size), device=device), 8)
        mod_n = keys.normal(keys.split(key)[1], (n_frames,) + tuple(noise_size), device=device)
        return "noise", ModulatedNoise(env, base_n, mod_n)

    __call__ = forward

    def _band_blend(self, new: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
        if new.ndim != 3 or base.ndim != 3:  # noise targets pass through
            return new
        lo, hi = _LAYER_BANDS[self.which_layers]
        lo, hi = min(lo, base.shape[1]), min(hi, base.shape[1])
        out = base.clone()
        out[:, lo:hi] = new[:, lo:hi]
        return out


# ------------------------------------------------------------- plotting --
def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float32) if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def plot_signals(signals, out_file: str | None = None):
    """Stacked line plots of envelopes, saved to `out_file` (default
    ``output/signals.pdf``); returns the path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    signals = [_host(s).reshape(len(s), -1) for s in signals]
    fig, axes = plt.subplots(len(signals), 1, figsize=(12, 2 * len(signals)), squeeze=False)
    for ax, sig in zip(axes[:, 0], signals):
        ax.plot(sig)
        ax.set_xlim(0, len(sig))
    fig.tight_layout()
    out_file = out_file or "output/signals.pdf"
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file)
    plt.close(fig)
    return out_file


def plot_spectra(spectra, out_file: str | None = None):
    """Stacked (T, C) heatmaps, saved to `out_file` (default
    ``output/spectra.pdf``); returns the path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    spectra = [_host(s) for s in spectra]
    fig, axes = plt.subplots(len(spectra), 1, figsize=(12, 2 * len(spectra)), squeeze=False)
    for ax, spec in zip(axes[:, 0], spectra):
        ax.imshow(spec.T, aspect="auto", origin="lower", interpolation="nearest")
    fig.tight_layout()
    out_file = out_file or "output/spectra.pdf"
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file)
    plt.close(fig)
    return out_file


# ------------------------------------------------------- network bending --
class AddNoise:
    """Bend transform adding a fixed noise field to a level's NCHW
    activations.  Takes the reference patches' NCHW (1, 1, H, W) noise; an
    NHWC (1, H, W, 1) field, as the JAX package's patches write it, is
    turned to NCHW."""

    def __init__(self, noise):
        noise = _f32(noise)
        if noise.ndim == 4 and noise.shape[-1] == 1 and noise.shape[1] != 1:
            noise = noise.permute(0, 3, 1, 2)
        self.noise = noise

    def __call__(self, x):
        return x + self.noise.to(x.device, x.dtype)


def replication_pad(left: int, right: int, top: int = 0, bottom: int = 0):
    """Edge-replicating pad of the last two axes (``ReplicationPad2d((l, r,
    t, b))``): pads the 4 x 4 constant block to 4 x 8 so every later level
    renders 2:1."""

    def pad(x):
        return F.pad(x, (left, right, top, bottom), mode="replicate")

    return pad


def sequential(*fns):
    """Bend transforms composed left to right."""

    def run(x):
        for f in fns:
            x = f(x)
        return x

    return run


# --------------------------------------------------- patch-file contract --
def load_patch_module(path: str) -> types.ModuleType:
    """Import a patch file (initialize / get_latents / get_noise ...) by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(Path(path).stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def render_patch(patch_module, audio, sr: int, fps: float = 24, palette=None, synthesizer=None,
                 out_file: str | None = None, audio_file: str | None = None, gan_config=None,
                 batch_size: int = 8, device=None, writer=None):
    """Run a patch file's hooks and, with a synthesizer and an `out_file` (or
    a `writer`), render the result.  Returns (latents, noises).

    ``args`` carries audio (on the device), sr, fps, audio_file and n_frames,
    plus whatever ``initialize`` attaches; ``get_latents`` maps the palette
    to (T, n_ws, 512); ``get_truncation`` (optional) gives a per-frame psi
    pulling the latents toward the mean latent (the mapper's, or the given
    palette's mean row); ``get_noise`` (optional) is called per noise layer
    and returns (T, H, W), a lazy ``Noise`` module or None (the
    synthesizer's own noise at that layer); ``get_bends`` (optional)
    installs bends, which are cleared otherwise.  Runs on the synthesizer's
    device, else on the CUDA device unless `device` says otherwise."""
    device = synthesizer.device if synthesizer is not None else resolve_device(device)
    audio = _f32(audio, device)
    args = types.SimpleNamespace(audio=audio, sr=int(sr), fps=fps, audio_file=audio_file,
                                 n_frames=int(audio.shape[-1] // 1024))
    if hasattr(patch_module, "initialize"):
        args = patch_module.initialize(args)

    if palette is None:
        from ..gan.wrapper import StyleGAN2Mapper

        mapper = StyleGAN2Mapper(config=gan_config, device=device)
        palette = mapper(keys.normal(keys.PRNGKey(42), (12, 512), device=device))
    else:
        mapper = None
    palette = _f32(palette, device)
    latents = patch_module.get_latents(palette, args)

    if hasattr(patch_module, "get_truncation"):
        trunc = _f32(patch_module.get_truncation(args), device).reshape(-1)
        T = latents.shape[0]
        trunc = trunc[:T]
        if trunc.shape[0] < T:
            trunc = torch.cat([trunc, trunc[-1:].expand(T - trunc.shape[0])])
        w_avg = mapper.mean_latent() if mapper is not None else palette.mean(dim=0, keepdim=True)
        latents = w_avg + trunc[:, None, None] * (latents - w_avg)

    noises = None
    if hasattr(patch_module, "get_noise") and synthesizer is not None:
        noises = []
        n_used = synthesizer.n_noises_used
        for i, (h, w) in enumerate(synthesizer.config.noise_shapes()[:n_used]):
            n = patch_module.get_noise(h, w, scale=i, num_scales=n_used, args=args)
            if n is None or (callable(n) and not isinstance(n, (np.ndarray, torch.Tensor))):
                noises.append(n)   # None: the synthesizer's own noise; a callable: lazy, per chunk
            else:
                n = _f32(n, device)
                noises.append(n[:, None] if n.ndim == 3 else n)

    if synthesizer is not None:
        # a synthesizer reused across calls must not keep the previous patch's bends
        synthesizer.set_bends(patch_module.get_bends(args) if hasattr(patch_module, "get_bends") else {})

    if synthesizer is not None and (out_file is not None or writer is not None):
        from ..gan.render import render_latents_to_video

        render_latents_to_video(synthesizer, latents, noises, out_file, fps=fps, audio_file=audio_file,
                                batch_size=batch_size, progress=False, writer=writer)
    return latents, noises
