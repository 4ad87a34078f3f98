"""Train a LatentNoiseReactor on one CUDA card — three loss modes.

Counterpart of ``ssar_tpu/train/train.py``:
- losses: "supervised" (MSE on latents + noise pyramid), "selfsupervised"
  (procrustes between predictions and input features), "ssabsdiff"
  (procrustes on the predictions' absdiff envelopes, through the hand-written
  absdiff kernel, ``ops/absdiff.py``);
- Adam behind an optional global-norm clip, both as optax computes them;
- the data lives on the card when it fits (under 4e9 bytes) and each step
  sends one int32 index vector; the loss stays on the card until the eval
  window;
- checkpoints (``torch.save``) hold the parameters, the Adam state, the random
  generators' states and the next example index, so ``--resume`` continues
  where a run left off;
- metrics as CSV, and TensorBoard scalars when tensorboardX is importable;
- the Frechet Context Distance at each eval window (``--fcd``, on by default
  as in the JAX trainer): a causal-CNN context encoder fitted once on the
  validation latents (``metrics/context_fid.py``), logged as ``Eval/FCD``;
- at each eval window, ``diagnostics_<it>.png``: the time-autocorrelation of
  the first validation window's inputs, predicted latents and targets
  (``utils/plot.py``; skipped with a message where matplotlib is missing);
- ``--cache_dir`` takes either cache layout: windowed shards live on the card
  when they fit, the raw streaming cache is gathered from its memory maps on
  the host each step.

Runs on the CUDA device unless ``--device cpu`` (or ``device="cpu"``) is given.
The JAX trainer's K-step ``train_step_scan`` (its fusion of steps against its
runtime's dispatch latency) has no counterpart: the port steps one at a time.

    python -m ssar_tpu_torch.train.train --smoke --decoder fixed --backbone sashimi --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..models.reactor import LatentNoiseReactor
from ..ops.absdiff import batch_absdiff
from ..utils.device import resolve_device
from .data import compute_stats, load_cached, prefetch, synthetic_dataset
from .losses import audio_reactive_loss, supervised_loss, supervised_loss_per_example


def make_model(args, mean, std, palette) -> LatentNoiseReactor:
    """The reactor the flags describe, on the CPU."""
    return LatentNoiseReactor(
        input_mean=np.asarray(mean), input_std=np.asarray(std),
        latents=None if args.decoder == "learned" else np.asarray(palette),
        residual=args.residual, num_layers=args.num_layers, backbone=args.backbone,
        hidden_size=args.hidden_size, decoder=args.decoder,
        n_latent_split=args.n_latent_split, n_noise=4, dropout=args.dropout,
        env_guard_eps=args.env_guard_eps,
    )


class ClippedAdam:
    """optax ``chain(clip_by_global_norm(clip), adam(lr))`` on a list of tensors.

    Clip: ``g / ||g|| * clip`` when the global norm ``||g||`` is not below
    ``clip`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and
    differs).  Adam: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``,
    bias-corrected, ``p += -lr * mu_hat / (sqrt(nu_hat) + eps)``.  Everything
    stays on the parameters' device: a step makes no host sync.
    """

    def __init__(self, params, lr: float, grad_clip: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.grad_clip, self.b1, self.b2, self.eps = lr, grad_clip, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.int32, device=self.params[0].device)

    @torch.no_grad()
    def clip(self, grads: list) -> list:
        if self.grad_clip <= 0:
            return grads
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        clipped = torch._foreach_mul(torch._foreach_div(grads, norm), self.grad_clip)
        keep = norm < self.grad_clip
        return [torch.where(keep, g, c) for g, c in zip(grads, clipped)]

    @torch.no_grad()
    def step(self, grads) -> None:
        """Apply one update from `grads` (one per parameter, in order)."""
        grads = self.clip(list(grads))
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
        self.count += 1
        one = torch.ones((), device=self.count.device)
        mu_hat = torch._foreach_div(self.mu, one - torch.pow(one * b1, self.count))
        nu_hat = torch._foreach_div(self.nu, one - torch.pow(one * b2, self.count))
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        updates = torch._foreach_mul(torch._foreach_div(mu_hat, denom), -self.lr)
        torch._foreach_add_(self.params, updates)

    def state_dict(self) -> dict:
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for mine, theirs in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            if len(mine) != len(theirs):
                raise ValueError(f"optimizer state for {len(theirs)} tensors, this model has {len(mine)}")
            torch._foreach_copy_(mine, [t.to(m.device) for m, t in zip(mine, theirs)])
        self.count.copy_(state["count"])


def _loss(model, loss_mode: str, batch, generator=None, dropout_generator=None, per_example: bool = False):
    inputs, latents, n4, n8, n16, n32 = batch
    preds_lat, preds_noise = model(inputs, generator=generator, dropout_generator=dropout_generator)
    if loss_mode == "supervised":
        fn = supervised_loss_per_example if per_example else supervised_loss
        loss = fn(preds_lat, preds_noise, latents, [n4, n8, n16, n32])
    elif loss_mode == "selfsupervised":
        loss = audio_reactive_loss([preds_lat] + list(preds_noise), [inputs])
    elif loss_mode == "ssabsdiff":
        loss = audio_reactive_loss([batch_absdiff(p)[..., None] for p in [preds_lat] + list(preds_noise)],
                                   [inputs])
    else:
        raise ValueError(loss_mode)
    if loss_mode != "supervised" and not per_example:
        loss = loss.mean()
    return loss, preds_lat, preds_noise


def make_train_step(model: LatentNoiseReactor, optimizer: ClippedAdam, loss_mode: str,
                    device: str | torch.device | None = None):
    """(train_step, train_step_gather, eval_step) for `model` on `device` (the
    CUDA device unless given; the model and optimizer must live there).

    - ``train_step(batch, generators) -> loss``: one optimizer step on a batch
      of six tensors (features, latents, n4, n8, n16, n32); ``generators`` is
      (noise, dropout), the two random streams the JAX step splits its key
      into.  The loss is returned on the device.
    - ``train_step_gather(data, sel, generators)``: the same on the rows `sel`
      (int tensor on the device) of the device-resident arrays `data`.
    - ``eval_step(batch, generator) -> (mode_loss (B,), mse, latent sample,
      flattened latent sequences)``, without dropout and gradients.
    """
    device = resolve_device(device)
    if loss_mode not in ("supervised", "selfsupervised", "ssabsdiff"):
        raise ValueError(f"unknown loss mode {loss_mode!r}")
    params = [p for p in model.parameters() if p.requires_grad]
    if [id(p) for p in optimizer.params] != [id(p) for p in params]:
        raise ValueError("the optimizer must hold the model's trainable parameters, in order")
    for p in params:
        if p.device.type != device.type:
            raise ValueError(f"model parameters on {p.device}, expected {device}: move the model first")

    def train_step(batch, generators):
        model.train()
        loss, _, _ = _loss(model, loss_mode, batch, *generators)
        grads = torch.autograd.grad(loss, params)
        optimizer.step(grads)
        return loss.detach()

    def train_step_gather(data, sel, generators):
        return train_step(tuple(a.index_select(0, sel) for a in data), generators)

    @torch.no_grad()
    def eval_step(batch, generator):
        model.eval()
        inputs, latents, n4, n8, n16, n32 = batch
        mode_loss, preds_lat, preds_noise = _loss(model, loss_mode, batch, generator, per_example=True)
        mse = supervised_loss(preds_lat, preds_noise, latents, [n4, n8, n16, n32])
        flat = preds_lat.reshape(-1)
        stride = max(1, flat.shape[0] // 8192)
        lat_sample = flat[::stride][:8192]
        fcd_seq = preds_lat.reshape(preds_lat.shape[0], preds_lat.shape[1], -1)
        return mode_loss, mse, lat_sample, fcd_seq

    return train_step, train_step_gather, eval_step


def _laplace_b(sample: np.ndarray) -> float:
    """Laplace scale MLE of a flat sample (loc = median, b = mean |x - loc|)."""
    sample = np.asarray(sample, np.float64)
    return float(np.mean(np.abs(sample - np.median(sample))))


def _synthetic_test_audio(duration: float, fps: int, seed: int = 0):
    """Deterministic chirp + beat test clip for the checkpoint render when no
    --test_audio is given."""
    sr = 1024 * fps
    t = np.arange(int(duration * sr)) / sr
    beat = (np.sin(2 * np.pi * 2.0 * t) > 0.95).astype(np.float32)
    tone = np.sin(2 * np.pi * (220 + 110 * np.sin(2 * np.pi * 0.25 * t)) * t)
    noise = np.random.RandomState(seed).randn(len(t)) * 0.05
    return (0.6 * tone + 0.3 * beat + noise).astype(np.float32), sr


def render_checkpoint_sample(model, args, out_file: str, gan_config=None,
                             device: str | torch.device | None = None) -> str:
    """Render the checkpoint's audio2video sample and return its path.  An
    ``.mp4`` through cv2 where cv2 is importable, else the same frames as an
    uncompressed ``.y4m`` (numpy only)."""
    from ..gan.video_io import Y4MWriter
    from ..generate.audio2video import audio2video

    audio, sr, audio_file = None, None, args.test_audio
    if not audio_file:
        audio, sr = _synthetic_test_audio(min(args.duration, 4), args.fps, args.seed)
    size = (args.render_size, args.render_size)
    writer = None
    try:
        import cv2  # noqa: F401
    except ImportError:
        out_file = str(Path(out_file).with_suffix(".y4m"))
        writer = Y4MWriter(out_file, size, fps=args.fps)
    was_training = model.training
    model.eval()
    try:
        audio2video(model, audio_file, out_file, model_file=args.stylegan, output_size=size, fps=args.fps,
                    batch_size=8, seed=args.seed, residual=args.residual, gan_config=gan_config, audio=audio,
                    sr=sr, device=device, writer=writer)
    finally:
        model.train(was_training)
    return out_file


class MetricsWriter:
    def __init__(self, log_dir: Path):
        log_dir.mkdir(parents=True, exist_ok=True)
        self.csv = open(log_dir / "metrics.csv", "a")
        try:
            from tensorboardX import SummaryWriter

            self.tb = SummaryWriter(str(log_dir))
        except ImportError:
            self.tb = None

    def scalar(self, tag: str, value: float, step: int):
        self.csv.write(f"{step},{tag},{value}\n")
        self.csv.flush()
        if self.tb is not None:
            self.tb.add_scalar(tag, value, step)

    def close(self):
        self.csv.close()
        if self.tb is not None:
            self.tb.close()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--decoder", type=str, default="learned", choices=["learned", "fixed"])
    parser.add_argument("--backbone", type=str, default="gru",
                        choices=["sashimi", "gru", "lstm", "transformer", "conv", "mlp"])
    parser.add_argument("--n_latent_split", type=int, default=3, choices=[1, 2, 3, 6, 9, 18])
    parser.add_argument("--hidden_size", type=int, default=16)
    parser.add_argument("--num_layers", type=int, default=4)
    parser.add_argument("--dropout", type=float, default=0.0)
    parser.add_argument("--duration", type=int, default=8)
    parser.add_argument("--fps", type=int, default=24)
    parser.add_argument("--loss", type=str, default="supervised",
                        choices=["supervised", "selfsupervised", "ssabsdiff"])
    parser.add_argument("--residual", action="store_true")
    parser.add_argument("--n_examples", type=int, default=128_000)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--grad_clip", type=float, default=1.0,
                        help="global-norm gradient clip; 0 disables (bare Adam)")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--env_guard_eps", type=float, default=0.0,
                        help="opt-in fixed-decoder env/env.sum stability guard (0 = reference-exact)")
    parser.add_argument("--eval_every", type=int, default=10_240)
    parser.add_argument("--ckpt_every", type=int, default=10_240)
    parser.add_argument("--cache_dir", type=str, default=None, help="preprocessed dataset dir")
    parser.add_argument("--out_dir", type=str, default="runs")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--resume", type=str, default=None,
                        help="run dir to resume from (restores params, optimizer, generators and step)")
    parser.add_argument("--test_audio", type=str, default=None,
                        help="audio file for the render-at-checkpoint sample")
    parser.add_argument("--stylegan", type=str, default=None,
                        help="StyleGAN2 checkpoint for checkpoint renders (.npz)")
    parser.add_argument("--render_size", type=int, default=256)
    parser.add_argument("--render_at_ckpt", action=argparse.BooleanOptionalAction, default=True,
                        help="render an audio2video sample at every checkpoint")
    parser.add_argument("--fcd", action=argparse.BooleanOptionalAction, default=True,
                        help="Frechet Context Distance at each eval window (Eval/FCD)")
    parser.add_argument("--config", type=str, default=None,
                        help="JSON config file; CLI flags explicitly given override it")
    parser.add_argument("--device", type=str, default=None, help="torch device (default: the CUDA device)")
    parser.add_argument("--smoke", action="store_true", help="tiny synthetic run")
    return parser


def _latest_checkpoint(run_dir) -> Path:
    ckpts = sorted((Path(run_dir) / "ckpt").glob("step_*.pt"))
    if not ckpts:
        raise FileNotFoundError(f"no checkpoint under {run_dir}/ckpt")
    return ckpts[-1]


def main(argv=None):
    """Train from the command-line flags in `argv`; returns (log_dir, val_loss).
    ``--device`` picks the device; the CUDA device by default."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.config:
        from ..utils.config import apply_config_file

        args = apply_config_file(parser, args, args.config, argv)
    device = resolve_device(args.device)

    if args.smoke:  # shrink only values the user didn't set explicitly
        for name, value in (("n_examples", 64 * 4), ("batch_size", 8), ("eval_every", 128),
                            ("ckpt_every", 128), ("render_size", 64)):
            if getattr(args, name) == parser.get_default(name):
                setattr(args, name, value)

    n_frames = args.duration * args.fps
    if args.cache_dir:
        train_ds = load_cached(args.cache_dir, "train")
        val_ds = load_cached(args.cache_dir, "val")
        mean = np.load(Path(args.cache_dir) / "train_mean.npy")
        std = np.load(Path(args.cache_dir) / "train_std.npy")
    else:
        train_ds = synthetic_dataset(n_windows=64, n_frames=n_frames)
        val_ds = synthetic_dataset(n_windows=16, n_frames=n_frames, seed=7)
        mean, std = compute_stats(train_ds.features)

    # frozen W+ palette from the mapper on RandomState(42) z's
    from ..gan.wrapper import StyleGAN2Mapper

    mapper = StyleGAN2Mapper(seed=0, device=device)
    z = np.random.RandomState(42).randn(args.n_latent_split * args.hidden_size, 512).astype(np.float32)
    palette = mapper(z).cpu().contiguous()
    del mapper

    torch.manual_seed(args.seed)  # the parameters' initialisation
    model = make_model(args, mean, std, palette).to(device)
    n_params = sum(p.numel() for p in model.parameters())
    optimizer = ClippedAdam([p for p in model.parameters() if p.requires_grad], args.lr, args.grad_clip)
    train_step, train_step_gather, eval_step = make_train_step(model, optimizer, args.loss, device)
    gens = (torch.Generator(device).manual_seed(args.seed), torch.Generator(device).manual_seed(args.seed + 1))

    name = "_".join([args.backbone, args.loss, args.decoder, f"split{args.n_latent_split}",
                     f"hid{args.hidden_size}", f"layers{args.num_layers}", f"lr{args.lr}"])
    log_dir = Path(args.out_dir) / f"{name}_{int(time.time())}"
    writer = MetricsWriter(log_dir)
    (log_dir / "config.json").write_text(json.dumps(vars(args)))
    np.save(log_dir / "input_mean.npy", np.asarray(mean))
    np.save(log_dir / "input_std.npy", np.asarray(std))
    print(f"model: {n_params/1e3:.1f}K params on {device} -> {log_dir}")
    (log_dir / "ckpt").mkdir(exist_ok=True)

    def save_checkpoint(next_it: int):
        # full training state; "step" is the next example index to train
        torch.save({"params": model.state_dict(), "opt_state": optimizer.state_dict(),
                    "generators": [g.get_state() for g in gens], "step": next_it},
                   log_dir / "ckpt" / f"step_{next_it:09d}.pt")

    start_it = 0
    if args.resume:
        ckpt = torch.load(_latest_checkpoint(args.resume), map_location=device, weights_only=True)
        model.load_state_dict(ckpt["params"])
        optimizer.load_state_dict(ckpt["opt_state"])
        for g, state in zip(gens, ckpt["generators"]):
            g.set_state(state.cpu())
        start_it = int(ckpt["step"])
        print(f"resumed from {args.resume} at example {start_it}")

    # windowed shards go to the card when they fit; the raw streaming cache stays memory-mapped on the host
    data_bytes = sum(a.nbytes for a in train_ds.arrays) if hasattr(train_ds, "arrays") else None
    n_skip = start_it // args.batch_size  # replay the index stream to the resumed position
    idx_stream = train_ds.index_batches(args.batch_size, seed=args.seed)
    for _ in range(n_skip):
        next(idx_stream)
    device_data = train_ds.to_device(device) if data_bytes is not None and data_bytes < 4e9 else None
    if device_data is None:
        batches = prefetch(train_ds.batches_from(idx_stream))
    size = f"{data_bytes/1e6:.0f} MB" if data_bytes is not None else f"raw cache, {len(train_ds)} windows"
    print(f"training: {args.n_examples} examples, batch {args.batch_size}, {n_frames} frames/window, data "
          f"{f'resident on {device}' if device_data is not None else 'host-streamed'} ({size})", flush=True)

    # the FCD context encoder, fitted once on real validation latent sequences
    fcd_encode = fcd_real = None
    if args.fcd:
        try:
            from ..metrics.context_fid import context_fid, train_encoder

            n_fit = min(len(val_ds), 64)
            fcd_real = np.asarray(next(val_ds.batches(n_fit, shuffle=False))[1])
            fcd_real = fcd_real.reshape(n_fit, n_frames, -1).astype(np.float32)
            fcd_encode = train_encoder(fcd_real, n_steps=40, features=16, embed_dim=32, device=device)
        except Exception as e:  # the FCD never stops training
            print(f"FCD encoder unavailable: {e}")

    render_gan_config = None
    if args.stylegan is None:
        from ..gan.stylegan2 import StyleGAN2Config

        render_gan_config = StyleGAN2Config(resolution=1 << int(np.ceil(np.log2(max(32, args.render_size)))))

    def to_device(batch):
        return tuple(torch.as_tensor(np.asarray(b), dtype=torch.float32).to(device) for b in batch)

    pending: list = []  # (iter, device loss) — fetched once per eval window
    flush_window = max(args.batch_size * 256, args.eval_every)

    def flush_pending():
        if not pending:
            return []
        losses = torch.stack([v for _, v in pending]).cpu().tolist()  # one sync per window
        for (step_i, _), x in zip(pending, losses):
            writer.scalar(f"Loss/{args.loss}", x, step_i)
        pending.clear()
        return losses

    def render(it_tag: int, what: str):
        try:  # the render never stops training (as in the JAX trainer)
            out = render_checkpoint_sample(model, args, str(log_dir / f"sample_{it_tag:08d}.mp4"),
                                           gan_config=render_gan_config, device=device)
            print(f"{what}: {out}")
        except Exception as e:
            print(f"{what} skipped: {type(e).__name__}: {e}")

    def diagnostics(it_tag: int):
        """Autocorrelation grids of the first validation window: one forward
        of a full validation batch (noise seeded 0), then the plot; a plot
        that fails is reported and never stops training."""
        vb = next(val_ds.batches(args.batch_size, shuffle=False))
        model.eval()
        with torch.no_grad():
            feats = torch.as_tensor(np.asarray(vb[0]), dtype=torch.float32).to(device)
            lat, _ = model(feats, generator=torch.Generator(device).manual_seed(0))
        lat = lat[0].reshape(lat.shape[1], -1).cpu().numpy()
        try:
            from ..utils.plot import autocorrelation_grid

            autocorrelation_grid({"inputs": np.asarray(vb[0][0]), "latents": lat,
                                  "targets": np.asarray(vb[1][0]).reshape(vb[1].shape[1], -1)},
                                 str(log_dir / f"diagnostics_{it_tag:08d}.png"))
        except Exception as e:  # matplotlib missing or a plot error: diagnostics never stop training
            print(f"diagnostics skipped: {type(e).__name__}: {e}")

    t0 = time.time()
    val_loss = val_loss_median = float("nan")
    it = start_it
    while it < args.n_examples:
        if device_data is not None:
            sel = torch.as_tensor(next(idx_stream), dtype=torch.int32).to(device)
            loss = train_step_gather(device_data, sel, gens)
        else:
            loss = train_step(to_device(next(batches)), gens)
        pending.append((it, loss))

        if it % args.eval_every == 0:
            losses = flush_pending()
            eval_gen = torch.Generator(device)
            eval_gen.set_state(gens[0].get_state())  # the current noise state, not advanced
            vmse, n, vbatch_losses, lat_samples, fake_seqs = 0.0, 0, [], [], []
            for vbatch in val_ds.batches(args.batch_size, shuffle=False, loop=False):
                mode_l, mse_l, lsamp, fseq = eval_step(to_device(vbatch), eval_gen)
                vbatch_losses.extend(mode_l.cpu().ravel().tolist())
                vmse += float(mse_l)
                lat_samples.append(lsamp.cpu().numpy())
                if fcd_encode is not None and n * args.batch_size < 64:
                    fake_seqs.append(fseq)
                n += 1
                if n * args.batch_size >= len(val_ds):
                    break
            val_loss = float(np.mean(vbatch_losses)) if vbatch_losses else float("nan")
            val_loss_median = float(np.median(vbatch_losses)) if vbatch_losses else float("nan")
            writer.scalar("Loss/val", val_loss, it)
            writer.scalar("Loss/val_median", val_loss_median, it)
            writer.scalar("Loss/val_mse", vmse / max(n, 1), it)
            writer.scalar("Eval/laplace_b", _laplace_b(np.concatenate(lat_samples)), it)
            if fcd_encode is not None and fake_seqs:
                try:
                    fake = torch.cat(fake_seqs)
                    writer.scalar("Eval/FCD", context_fid(fcd_encode, fcd_real[: len(fake)], fake), it)
                except Exception as e:
                    print(f"FCD skipped: {e}")
            diagnostics(it)
            rate = (it + args.batch_size - start_it) / (time.time() - t0)
            train_loss = float(np.mean(losses)) if losses else float("nan")
            print(f"iter {it}  train {train_loss:.4f}  val {val_loss:.4f}  {rate:.1f} ex/s", flush=True)
        elif len(pending) * args.batch_size >= flush_window:
            flush_pending()

        if it % args.ckpt_every == 0:
            save_checkpoint(it + args.batch_size)
            if args.render_at_ckpt:
                render(it, "checkpoint render")

        it += args.batch_size

    flush_pending()
    save_checkpoint(it)
    if args.render_at_ckpt:
        render(args.n_examples, "final checkpoint render")
    writer.close()
    (log_dir / "final_metrics.json").write_text(json.dumps(
        {"val_loss": val_loss, "val_loss_median": val_loss_median}))
    print(f"done: val_loss {val_loss:.4f} (median {val_loss_median:.4f}), checkpoints in {log_dir}/ckpt")
    return log_dir, val_loss


if __name__ == "__main__":
    main()
