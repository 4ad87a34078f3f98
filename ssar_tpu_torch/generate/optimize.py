"""Test-time optimization: HiPPO envelopes maximising audio-reactivity.

Counterpart of ``ssar_tpu/generate/optimize.py``, the third generation
paradigm: a HiPPO-parameterized envelope timeseries drives a
winner-takes-all ``FixedLatentNoiseDecoderOpt``; Adam with a cosine learning
rate maximises the RV2 correlation between every prediction (envelopes,
latents, noise) and every audio feature, with per-prediction gradient
normalisation, or minimises the weighted orthogonal-procrustes distance the
comparison study scores.

``optimize`` runs on the CUDA device unless ``device="cpu"`` is passed, in
float32 with TF32 off.  The features and the decoder palette are constants of
the loss; each optimizer step is plain eager PyTorch.  Losses stay on the
device and reach the host once per ``log_steps`` steps.  With
``lambda_lap > 0`` every step differentiates two sliding-median filters per
prediction (``audio/segment.py``), forward and backward through the kernels
of ``ops/median.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..audio import features as FT
from ..models.hippo import HiPPOTimeseries
from ..ops.gaussian import gaussian_filter
from ..train.losses import normalize_gradients
from ..train.train import ClippedAdam
from ..utils.device import full_precision, resolve_device

AFNS = [FT.chromagram, FT.tonnetz, FT.mfcc, FT.spectral_contrast, FT.rms, FT.drop_strength, FT.onsets]


def autocorrelation(A: torch.Tensor) -> torch.Tensor:
    """Standardised time-domain Gram matrix (population deviation)."""
    A = A - A.mean(dim=0)
    A = A / (A.std(dim=0, unbiased=False) + 1e-8)
    A = A.reshape(A.shape[0], -1)
    return A @ A.T


def _zero_diagonal(M: torch.Tensor) -> torch.Tensor:
    return M - torch.diag(torch.diag(M))


def _rv2_of_grams(XX: torch.Tensor, YY: torch.Tensor) -> torch.Tensor:
    """RV2 of two zero-diagonal symmetric Grams; tr(X'Y) is taken as sum(X * Y)."""
    return (XX * YY).sum() / torch.sqrt((XX * XX).sum() * (YY * YY).sum() + 1e-12)


def rv2(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """RV2 on standardised autocorrelations."""
    return _rv2_of_grams(_zero_diagonal(autocorrelation(X)), _zero_diagonal(autocorrelation(Y)))


def abscos(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Absolute cosine between autocorrelations."""
    XX = autocorrelation(X)
    XX = XX / (torch.linalg.matrix_norm(XX) + 1e-12)
    YY = autocorrelation(Y)
    YY = YY / (torch.linalg.matrix_norm(YY) + 1e-12)
    return (XX * YY).sum().abs()


def lap_loss_host(target: np.ndarray, prediction: np.ndarray) -> float:
    """Segmentation-matching MSE after the optimal label assignment (the
    Hungarian solver on the host: a k x k problem)."""
    from scipy.optimize import linear_sum_assignment

    cost = target.T @ prediction  # (k, k)
    _, cols = linear_sum_assignment(-cost)
    return float(np.mean((prediction[:, cols] - target) ** 2))


def sinkhorn_assignment(cost: torch.Tensor, n_iters: int = 30, temp: float = 0.05) -> torch.Tensor:
    """Doubly-stochastic soft assignment maximising the total cost, (..., k, k):
    a fixed number of row / column log-normalisations."""
    logit = cost / temp
    for _ in range(n_iters):
        logit = logit - torch.logsumexp(logit, dim=-1, keepdim=True)
        logit = logit - torch.logsumexp(logit, dim=-2, keepdim=True)
    return torch.exp(logit)


def lap_loss(target: torch.Tensor, prediction: torch.Tensor) -> torch.Tensor:
    """Differentiable segmentation-matching loss.

    target (..., T, k) and prediction (T, k) are soft one-hot segmentations
    (leading axes of `target` are a batch of targets for one prediction).
    The label permutation is a Sinkhorn assignment without gradient, then
    an MSE between the permuted prediction and the target, so gradients flow
    through the segmentation values.  Returns (...) losses.
    """
    with torch.no_grad():
        P = sinkhorn_assignment(target.transpose(-1, -2) @ prediction)  # (..., k, k) overlap
    return ((prediction @ P.transpose(-1, -2) - target) ** 2).mean(dim=(-2, -1))


def initial_envelopes(n_frames: int, n_envelopes: int, generator: torch.Generator, device) -> torch.Tensor:
    """The uniform [0, 1) envelopes the HiPPO coefficients start from."""
    return torch.rand(n_frames, n_envelopes, generator=generator, device=device)


def noise_base_draw(T: int, size: int, generator: torch.Generator, device) -> torch.Tensor:
    """The standard-normal (T, size, size) maps a noise base is smoothed from."""
    return torch.randn(T, size, size, generator=generator, device=device)


class FixedLatentNoiseDecoderOpt:
    """Winner-takes-all grouped decoder.

    Envelopes (T, S*G*H + 2*n_noise): each latent split softmaxes over its
    (G, H) group structure before mixing palette latents; noise (mu, sigma)
    pairs scale time-smoothed normal maps at 4x4 .. 2^(n_noise+1).
    """

    def __init__(self, latents: torch.Tensor, n_latent_split=1, n_latent_groups=1,
                 n_latent_per_group=6, n_noise=6, generator: torch.Generator | None = None):
        self.S, self.G, self.H = n_latent_split, n_latent_groups, n_latent_per_group
        if latents.shape[0] != self.S * self.G * self.H:
            raise ValueError(f"the palette holds {latents.shape[0]} latents, expected "
                             f"{self.S} x {self.G} x {self.H} = {self.S * self.G * self.H}")
        self.latents = latents.detach()
        self.W = latents.shape[1] // self.S
        self.n_noise = n_noise
        self.generator = generator or torch.Generator(latents.device).manual_seed(0)

    def noise_bases(self, T: int):
        return [gaussian_filter(noise_base_draw(T, 2 ** (i + 2), self.generator, self.latents.device), 2)
                for i in range(self.n_noise)]

    def __call__(self, x: torch.Tensor, noise_bases):
        S, G, H, W = self.S, self.G, self.H, self.W
        latents = []
        for i in range(S):
            env = x[:, i * (G * H) : (i + 1) * (G * H)].reshape(-1, G, H)
            env = torch.softmax(env, dim=2)
            env = env / (env.sum(dim=(1, 2), keepdim=True) + 1e-8)
            lat = self.latents[i * (G * H) : (i + 1) * (G * H), i * W : (i + 1) * W]
            latents.append(torch.einsum("tgh,ghwl->twl", env, lat.reshape(G, H, W, lat.shape[-1])))
        latents = torch.cat(latents, dim=1)

        noise_envs = x[:, S * G * H :]
        noise = [noise_envs[:, 2 * i, None, None] + noise_envs[:, 2 * i + 1, None, None] * noise_bases[i]
                 for i in range(self.n_noise)]
        return latents, noise


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0):
    """``optax.cosine_decay_schedule``: the value of update `count` (from 0)."""
    def schedule(count: int) -> float:
        cosine = 0.5 * (1 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


@dataclasses.dataclass
class Problem:
    """What ``prepare`` builds once per track: the HiPPO module (its parameter
    ``c`` is what the optimizer tunes), the decoder with its noise bases, the
    features, the beats of the segmentation loss, and ``loss_fn()`` -> the scalar loss of the
    module's current coefficients.  ``seconds`` holds the wall time of the
    feature stage and of the HiPPO initialisation (the card synchronised at
    both ends)."""
    hippo: HiPPOTimeseries
    decoder: "FixedLatentNoiseDecoderOpt"
    noise_bases: list
    features: dict
    loss_fn: object
    beats: list | None
    seconds: dict


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def prepare(audio: np.ndarray, sr: int, fps: int = 24, n_params: int = 512,
            n_latent_split: int = 1, n_latent_groups: int = 1, n_latent_per_group: int = 6,
            n_noise: int = 6, lambda_rv2: float = 1.0, prediction_similarity_penalty: float = 0.0,
            objective: str = "rv2", norm_grads: bool = True, seed: int = 42,
            model_file: str | None = None, gan_config=None, max_seconds: float = 40.0, palette=None,
            emphasize_feature: str | None = None, feature_weight_boosts: dict | None = None,
            use_audio_segmentation_features: bool = False, lambda_lap: float = 0.0,
            ks=(2, 4, 6, 8, 12, 16), lambda_amplitude: float = 0.0, target_latent_step: float = 0.048,
            device: str | torch.device | None = None) -> Problem:
    """Everything ``optimize`` does before its first step (same arguments):
    features and their weights, the HiPPO encoding of the initial envelopes,
    the decoder and its noise bases, the targets of the segmentation loss,
    and the loss as a function of the HiPPO coefficients."""
    from ..gan.wrapper import StyleGAN2Mapper

    device = resolve_device(device)
    audio = np.asarray(audio)[: int(max_seconds * sr)]
    target_sr = 1024 * fps
    n_palette = n_latent_split * n_latent_groups * n_latent_per_group

    t_start = _clock(device)
    with torch.no_grad(), full_precision():
        audio_t = torch.as_tensor(audio, dtype=torch.float32).to(device)
        if sr != target_sr:
            from ..ops.resample import resample

            audio_t = resample(audio_t, int(sr), target_sr, lowpass_filter_width=6)
            sr = target_sr
        features = {fn.__name__: fn(audio_t, sr) for fn in AFNS}
        n_frames = int(features["rms"].shape[0])

        feature_weights = {}
        for name, f in features.items():
            ac = autocorrelation(f)
            ac = ac - ac.min()
            span = float(ac.max())
            if span < 1e-6:  # constant feature (degenerate audio): carries no signal
                feature_weights[name] = 0.0
                continue
            w = float(1.0 / ((ac / span).mean() + 1e-8))
            feature_weights[name] = w if np.isfinite(w) else 1.0

        if use_audio_segmentation_features:
            from ..audio.segment import laplacian_segmentation_rosa

            labels = laplacian_segmentation_rosa(audio_t, sr, n_frames, ks=ks)
            features["rosa_segmentation"] = torch.as_tensor(labels, dtype=torch.float32, device=device)
            feature_weights["rosa_segmentation"] = max(feature_weights.values())
        if emphasize_feature is not None:
            feature_weights[emphasize_feature] *= 10.0
        for name, boost in (feature_weight_boosts or {}).items():
            if name in feature_weights:
                feature_weights[name] *= boost

        t_features = _clock(device)
        n_envelopes = n_palette + 2 * n_noise
        hippo = HiPPOTimeseries(n_frames, n_envelopes, N=n_params, device=device)
        hippo.init_params(initial_envelopes(n_frames, n_envelopes, torch.Generator(device).manual_seed(seed), device))
        t_hippo = _clock(device)

        if palette is None:
            mapper = StyleGAN2Mapper(model_file=model_file, config=gan_config, seed=seed, device=device)
            palette = mapper(np.random.RandomState(42).randn(n_palette, 512).astype(np.float32))
        else:
            palette = torch.as_tensor(palette, dtype=torch.float32).to(device)[:n_palette]
        decoder = FixedLatentNoiseDecoderOpt(palette, n_latent_split, n_latent_groups, n_latent_per_group, n_noise,
                                             generator=torch.Generator(device).manual_seed(seed))
        noise_bases = decoder.noise_bases(n_frames)

        beats, feature_segmentations = None, None
        if lambda_lap:
            from ..audio.beat import onset_strength
            from ..audio.beat_host import beat_track
            from ..audio.segment import laplacian_segmentation

            _, beats = beat_track(onset_strength(audio_t, sr).cpu().numpy(), sr=sr, hop_length=1024)
            beats = [int(b) for b in beats if 0 < b < n_frames]
            per_feature = []
            for name, f in features.items():
                if "segmentation" in name:  # hard labels -> per-k one-hots
                    per_feature.append([F.one_hot(f[:, i].long(), k).to(torch.float32) for i, k in enumerate(ks)])
                else:
                    per_feature.append(laplacian_segmentation(f.reshape(n_frames, -1), beats, ks=ks))
            # per k, every feature's target segmentation stacked: (n_features, T, k)
            feature_segmentations = [torch.stack(per_k) for per_k in zip(*per_feature)]

        # each feature's zero-diagonal standardised Gram and weight, prepared once
        feat_grams = [(feature_weights[name], _zero_diagonal(autocorrelation(f))) for name, f in features.items()]

        # Feature bank for the procrustes objective, prepared once: each feature
        # centred over time, unit-frobenius, and zero-padded to a common width.
        # Zero columns change neither the centring, the norm, nor the nuclear
        # norm of the cross-covariance, so the padded bank scores identically
        # and one batched product and one batched eigvalsh per prediction
        # replace |features| separate procrustes distances.
        if objective == "procrustes":
            if lambda_lap or prediction_similarity_penalty or lambda_rv2 != 1.0:
                warnings.warn("objective='procrustes' ignores lambda_lap, prediction_similarity_penalty and "
                              "lambda_rv2: these only apply to the rv2 objective", stacklevel=2)
            f_width = max(int(np.prod(f.shape[1:])) for f in features.values())
            f_bank = []
            for f in features.values():
                y = f.reshape(n_frames, -1).to(torch.float32)
                y = y - y.mean(dim=0, keepdim=True)
                y = y / (torch.linalg.matrix_norm(y) + 1e-12)
                f_bank.append(F.pad(y, (0, f_width - y.shape[1])))
            f_bank = torch.stack(f_bank)  # (F, T, f_width)
            f_w = torch.tensor([feature_weights[name] for name in features], dtype=torch.float32, device=device)

    def procrustes_bank_loss(pred):
        """sum_f w_f (1 - ||x'y_f||_*) for one prediction against the bank."""
        x = pred - pred.mean(dim=0, keepdim=True)
        x = x / (torch.linalg.matrix_norm(x) + 1e-12)
        a = torch.einsum("td,fte->fde", x, f_bank)  # (F, Dp, f_width)
        ev = torch.linalg.eigvalsh(a.transpose(1, 2) @ a)  # small-side Gram (F, fw, fw)
        nuc = torch.sqrt(torch.clamp(ev, min=0.0) + 1e-24).sum(dim=-1)
        return (f_w * (1.0 - nuc)).sum()

    def amplitude_penalty(latents):
        """Squared relative error of mean |delta latent| against the target step."""
        step = torch.diff(latents.reshape(n_frames, -1), dim=0).abs().mean()
        return ((step - target_latent_step) / target_latent_step) ** 2

    def loss_fn():
        envs = hippo.decode()
        latents, noise = decoder(envs, noise_bases)
        amp = lambda_amplitude * amplitude_penalty(latents) if lambda_amplitude else 0.0
        if objective == "procrustes":
            preds = [envs.reshape(n_frames, -1), latents.reshape(n_frames, -1)] + [n.reshape(n_frames, -1) for n in noise]
            if norm_grads:
                preds = ([normalize_gradients(preds[0], 1.0), normalize_gradients(preds[1], 1.0)]
                         + [normalize_gradients(n, 1.0 / len(noise)) for n in preds[2:]])
            return sum(procrustes_bank_loss(pred) for pred in preds) + amp
        predictions = ([normalize_gradients(envs, 1.0), normalize_gradients(latents, 10.0)]
                       + [normalize_gradients(n, 0.25) for n in noise])
        loss = 0.0
        for pred in predictions:
            XX = _zero_diagonal(autocorrelation(pred))
            for w, YY in feat_grams:
                loss = loss + lambda_rv2 * w * (1.0 - _rv2_of_grams(XX, YY))
            if lambda_lap:
                from ..audio.segment import laplacian_segmentation

                pred_segs = laplacian_segmentation(pred.reshape(n_frames, -1), beats, ks=ks)
                for tgt, ps in zip(feature_segmentations, pred_segs):
                    loss = loss + lambda_lap * lap_loss(tgt, ps).sum() / len(ks)
        if prediction_similarity_penalty:
            for i in range(len(predictions)):
                for j in range(i + 1, len(predictions)):
                    loss = loss + prediction_similarity_penalty * abscos(predictions[i], predictions[j])
        return loss + amp

    return Problem(hippo, decoder, noise_bases, features, loss_fn, beats,
                   {"features": t_features - t_start, "hippo": t_hippo - t_features})


def optimize(audio_file: str | None = None, fps: int = 24, n_steps: int = 512, n_params: int = 512,
             n_latent_split: int = 1, n_latent_groups: int = 1, n_latent_per_group: int = 6,
             n_noise: int = 6, lr: float = 1e-3, log_steps: int = 16, eval_steps: int = 128,
             lambda_rv2: float = 1.0, prediction_similarity_penalty: float = 0.0,
             objective: str = "rv2", norm_grads: bool = True,
             out_dir: str = "output/optimization", seed: int = 42,
             audio: np.ndarray | None = None, sr: int | None = None,
             model_file: str | None = None, render: bool = False,
             gan_config=None, max_seconds: float = 40.0,
             palette=None, interp=None,
             emphasize_feature: str | None = None,
             feature_weight_boosts: dict | None = None,
             use_audio_segmentation_features: bool = False,
             lambda_lap: float = 0.0, ks=(2, 4, 6, 8, 12, 16),
             lambda_amplitude: float = 0.0, target_latent_step: float = 0.048,
             device: str | torch.device | None = None):
    """Returns (envelopes (T, E), latents (T, n_ws, 512), noise list, losses);
    the tensors lie on `device` (the CUDA device unless told otherwise), the
    losses are host floats, one per ``log_steps`` chunk (the loss at the
    chunk's first step).

    Options beyond the plain RV2 optimizer:

    - ``palette``: pre-mapped W+ palette for the decoder instead of mapping
      RandomState(42) z's.
    - ``interp``: residual base walk; the final latents are re-centred around
      it (latents - mean + interp).
    - ``emphasize_feature``: multiply that feature's weight by 10.
    - ``feature_weight_boosts``: extra per-feature weight multipliers.
    - ``use_audio_segmentation_features``: add the hard CQT-based laplacian
      segmentation as an extra feature with the largest weight.
    - ``lambda_lap``: segmentation-matching loss between on-device laplacian
      segmentations of each prediction and the audio features' segmentations
      (Sinkhorn assignment).
    - ``objective``: ``"rv2"`` is the standalone optimizer's loss;
      ``"procrustes"`` is the comparison study's variant, which minimises the
      weighted per-feature orthogonal procrustes distance over the raw
      (un-grad-normalised when ``norm_grads=False``) predictions.
    - ``lambda_amplitude`` (default 0): both objectives are scale-invariant;
      this term adds a squared relative error between the mean frame-to-frame
      latent step and ``target_latent_step``, pinning the solution to a
      visible motion amplitude without touching its correlation structure.
    """
    if audio is None:
        from ..train.data import load_audio

        audio, sr = load_audio(audio_file)
    device = resolve_device(device)
    problem = prepare(audio, sr, fps=fps, n_params=n_params, n_latent_split=n_latent_split,
                      n_latent_groups=n_latent_groups, n_latent_per_group=n_latent_per_group, n_noise=n_noise,
                      lambda_rv2=lambda_rv2, prediction_similarity_penalty=prediction_similarity_penalty,
                      objective=objective, norm_grads=norm_grads, seed=seed, model_file=model_file,
                      gan_config=gan_config, max_seconds=max_seconds, palette=palette,
                      emphasize_feature=emphasize_feature, feature_weight_boosts=feature_weight_boosts,
                      use_audio_segmentation_features=use_audio_segmentation_features, lambda_lap=lambda_lap, ks=ks,
                      lambda_amplitude=lambda_amplitude, target_latent_step=target_latent_step, device=device)
    hippo, decoder, noise_bases, loss_fn = problem.hippo, problem.decoder, problem.noise_bases, problem.loss_fn

    schedule = cosine_decay_schedule(lr, n_steps, alpha=0.01)
    optimizer = ClippedAdam([hippo.c], lr)

    losses = []
    out_base = Path(out_dir) / f"hippo_{Path(audio_file).stem if audio_file else 'synthetic'}_{seed}"
    out_base.parent.mkdir(parents=True, exist_ok=True)
    it = 0
    with full_precision():
        while it < n_steps:
            k = min(log_steps, n_steps - it)
            if render:  # never run past an eval boundary: eval_steps need not be a multiple of log_steps
                k = min(k, eval_steps - it % eval_steps)
            chunk_losses = []
            for step in range(it, it + k):
                loss = loss_fn()
                optimizer.lr = schedule(step)
                optimizer.step(torch.autograd.grad(loss, [hippo.c]))
                chunk_losses.append(loss.detach())
            host_losses = torch.stack(chunk_losses).cpu().numpy()  # the chunk's one host sync
            losses.append(float(host_losses[0]))  # loss at step `it`
            print(f"step {it}: loss {losses[-1]:.4f}")
            it += k
            if render and it % eval_steps == 0:
                with torch.no_grad():
                    latents, noise = decoder(hippo.decode(), noise_bases)
                _render_eval(audio_file, latents, noise, f"{out_base}_{it}.mp4", model_file, fps, gan_config,
                             device=device)

        with torch.no_grad():
            envs = hippo.decode()
            latents, noise = decoder(envs, noise_bases)
            if interp is not None:  # re-centre around a provided base walk
                interp = torch.as_tensor(interp, dtype=torch.float32).to(device)
                if interp.ndim == 2:  # (T, 512) w walk -> broadcast over the W+ axis
                    interp = interp[:, None, :]
                # the split decoder emits S * (n_latent // S) W+ rows, fewer than a
                # mapper-produced walk's where n_latent is no multiple of S:
                # align on the shared rows
                interp = interp[:, : latents.shape[1]]
                latents = latents - latents.mean(dim=0) + interp
    return envs, latents, noise, losses


def _render_eval(audio_file, latents, noise, out_file, model_file, fps, gan_config, device=None, writer=None):
    """Render an optimizer state through StyleGAN2: the noise pyramid is
    duplicated into per-layer noises (n0, n1, n1, n2, n2, ...)."""
    from ..gan.render import render_latents_to_video
    from ..gan.wrapper import StyleGAN2Synthesizer

    syn = StyleGAN2Synthesizer(model_file=model_file, config=gan_config, device=device)
    noise_nchw = [n[:, None] for n in noise]
    dup = [noise_nchw[0]] + [n for nn in noise_nchw[1:] for n in (nn, nn)]
    return render_latents_to_video(syn, latents, dup[: syn.n_noises_used], out_file, fps=fps,
                                   audio_file=audio_file, writer=writer)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--audio_file", type=str, default=None)
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--n_steps", type=int, default=512)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    p.add_argument("--config", type=str, default=None,
                   help="JSON config file; explicit CLI flags override it")
    args = p.parse_args(argv)
    if args.config:
        from ..utils.config import apply_config_file

        args = apply_config_file(p, args, args.config, argv)

    if args.smoke:
        from ..gan.stylegan2 import StyleGAN2Config

        sr = 1024 * 12
        t = np.arange(sr * 4) / sr
        audio = (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
        audio[:: sr // 2] += 1.0
        envs, latents, noise, losses = optimize(audio=audio, sr=sr, fps=12, n_steps=32, n_params=128, log_steps=8,
                                                gan_config=StyleGAN2Config(resolution=64), device=args.device)
        print("losses:", [f"{l:.3f}" for l in losses])
        print("shapes:", tuple(envs.shape), tuple(latents.shape), [tuple(n.shape) for n in noise])
        assert losses[-1] < losses[0]
        return
    optimize(audio_file=args.audio_file, fps=args.fps, n_steps=args.n_steps, lr=args.lr, device=args.device)


if __name__ == "__main__":
    main()
