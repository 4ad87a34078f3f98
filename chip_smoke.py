"""Drive the PyTorch port's serve, train, test-time-optimization, random-patch and evaluation paths, the other
model families and their trainers, checkpoint evaluation, the paper's comparison and the extractors and pSp, once
on one CUDA card and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA source of the port, compiled with nvcc in parallel;
  3. kernel check: the sliding-median kernel against its plain PyTorch
     version (torch.equal) at the serve path's, the long-form chunks' and
     tuning estimate's and a 3-minute track's shapes, the directogram's k = 3
     filters at (1440, 8) and (192, 8), the optimize path's, batched and awkward
     shapes, lines no longer than k // 2 and inputs holding NaNs (NaNs in the
     same places), and its time and device time beside the plain version's
     and its bound; the generic kernels (odd k > 31, forward and backward) at
     k = 33 and 63 the same way;
  3b. kernel check: absdiff (B2) and the S4D Vandermonde forward and backward
     (B3) against their plain versions at the train path's shapes, the
     Sashimi U-Net's (32, 32, 192), (64, 32, 48) and (128, 32, 12), a 3-minute
     track's (N = 32 and 64) and ragged ones, two launches bit-identical, with
     their times, plain times and bounds, and B3's error against float64;
     B2 also at the evaluation's video shapes, (1440, 3 x 256 x 256) and
     (192, 3 x 1024 x 1024), at split plans (a ragged and an odd E), each
     row's share of its bound, and at float16 and bfloat16 inputs read as
     they are (one kernel a call on the profiler's trace, no cast);
  3c. kernel check: the sliding median's backward (B1 bwd) against its plain
     version (torch.equal) at the HPSS and long-form chunk shapes on both
     axes, the optimize path's (2n, n) k = 7 and (n, n) k = 9, batched and
     ragged shapes, inputs with ties and a constant row; two launches
     bit-identical; its times, the plain version's and its bound;
  4. serve path: a synthetic 8 s track at 44.1 kHz -> audio2features (192, 59)
     -> GRU LatentNoiseReactor (hidden 32, 4 layers, random (96, 18, 512)
     palette) -> 1024 px StyleGAN2 (random weights from the seed, bf16) ->
     192 I420 frames into an in-memory sink; the sliding-median launch count
     is read around this run only;
  4b. long-form serve path, the JAX package's long-form bench's configuration
     (bench.py:bench_longform): a synthetic 180 s track at 24576 Hz ->
     parallel.features_sp.audio2features_long (4320, 59) -> the same GRU
     reactor over the whole track -> all 4320 frames at 1024 px, bf16, batch
     64, into the in-memory sink, after a warm-up on 120 s (the same chunk
     shapes) and one rendered batch; stage seconds, fps, x realtime and peak
     memory; the sliding-median launch count read around the feature call
     and checked exactly (4 per chunk + 2 for the tuning estimate);
  5. reference checks: the card's features and synthesis against the same
     code on the CPU (plain median) at a small size: the whole-track and the
     long-form stacks (the long form also within 1 % of the whole-track
     stack on the card), a synthesis with a static and an animated bend, a
     non-square output size, and a rosinality .pt written from the random
     weights and loaded back (the same frames);
  6. train path: ``ssar_tpu_torch.train.train.main`` at the grid of record's
     width (sashimi backbone, fixed decoder, ssabsdiff loss, hidden 32, 4
     layers, batch 32, 8 s windows at 24 fps) on 64 synthetic windows, 40
     steps with evals (and their Frechet Context Distance, on by default as
     in the JAX trainer), checkpoints and 256 px renders under build/; the
     absdiff and Vandermonde launch counts are read around this run only.
     Then 4 steps each of the other loss modes and of the learned decoder,
     a warm timed loop of ``train_step_gather`` per mode, and the trained
     sashimi reactor on phase 4's features;
  7. reference check: one ssabsdiff train step at a small width on the card
     and on the CPU, with the same weights, batch and base noise;
  8. optimize path, comparison configuration: ``generate.optimize.optimize``
     on a synthetic 40 s track at 44.1 kHz (960 frames), procrustes
     objective, 3x3x3 latents + 5 noise maps, N = 128, 512 steps; then
     ``_render_eval`` of 192 of its frames at 1024 px into an in-memory sink;
  9. optimize path, standalone configuration with the segmentation loss
     (rv2 objective, N = 512, 6 latents + 6 noise maps, lambda_lap = 1,
     prediction_similarity_penalty = 0.1), 8 steps; the sliding median's
     forward and backward launch counts are read around this run only and
     checked exactly;
  10. reference check: loss and gradient of both configurations at a small
     size on the card and on the CPU from the same initial envelopes, noise
     draws and palette;
  11. random-patch path: ``generate.sample.generate`` at the CLI's defaults
     (1024 px StyleGAN2 with random weights from the seed, bf16,
     downscale_factor 4 -> 256 x 256, batch 16, 24 fps, seed 42) on a
     synthetic 60 s track at 44.1 kHz read from a 16-bit wav (load and
     resample, music information, Patch.forward, the chunked render with
     lazy noise trees, 1440 I420 frames into the in-memory sink), after an
     untimed warm-up (one retrieve_music_information on the same track, the
     noise trees of every chunk timed alone, one rendered chunk); then the
     same call at downscale_factor 1 (1024 x 1024, all 17 noise layers) on
     the first 20 s (480 frames); stage seconds, fps, x realtime, the noise
     banks' bytes and peak memory; the sliding-median launch count read
     around each call and checked exactly (8: four HPSS);
  12. reference check at a small size in fp32 (64 px model, 4 s track):
     retrieve_music_information on the card and on the CPU (features within
     the docs/PARITY.md budgets, the same tempo, the same labels from the
     CPU's features, the same CQT labels), and one seed's Patch on both
     devices with the banks drawn on the CPU, Patch.forward and its noise
     trees under no_grad only, as sample.generate runs them (the same JSON,
     latents, noise windows and frames); fault C4: gaussian_filter with TF32
     allowed within 1e-6 of float64, beside its convolution without the
     filter's own full-float32 scope;
  13. evaluation path: phase 11's 60 s track through the serve path
     (audio2features, phase 4's GRU reactor, the 1024 px StyleGAN2 in bf16,
     batch 16) into 1440 uint8 RGB frames, prepared on the card as
     evaluate_file prepares a decoded file (box mean / 4, / 255: (1440, 3,
     256, 256) float32), then evaluate_reactivity, every VIDEO_FEATURES entry
     and visual_beats after one untimed run at the same shapes; stage
     seconds, x realtime and peak memory; the sliding-median and absdiff
     launch counts read around each and checked exactly; then
     evaluate_reactivity and VIDEO_FEATURES on phase 4's 8 s clip at 1024
     px as it is (192 frames, 2.4 GB), and the reference's constructed clips
     (flashes on a click track's onsets score above a static clip);
  14. reference check at a small size in fp32 (4 s track, 96 frames at 64
     px): the same frames prepared on both devices, both scores, every
     VIDEO_FEATURES output, farneback_flow on a textured clip and
     visual_beats' tempo, card against CPU;
  15. reactor backbones on the train path: ``train.main`` at phase 6's width
     with the lstm, conv, mlp and transformer backbones (ssabsdiff, fixed
     decoder, 4 steps each with an eval and its FCD; B2's launches read
     around each run and checked exactly, no B3), the experiments.py smoke
     grid's cell (mlp, learned decoder, supervised), a warm timed loop of
     each; then a learned-decoder reactor with noise_mode="conv3d" through
     react and a gradient step;
  16. the Sashimi U-Net (features 32, 2 tiers of 2 blocks, pool 4, expand 2,
     state 64) at batch 32 x 192 frames: forward and the backward of a
     mean-square loss, timed, B3's forward and backward launches read around
     them and checked exactly (10 and 10); 192 SashimiStreamer steps against
     the forward within 1e-4;
  17. the other trainers at the JAX package's defaults: train_audio2latent
     (20 steps, the loss falls; then eval_fcd), train_psagan,
     train_stylevideogan, train_sslstm (also with the video-patch loss through
     a 64 px G), 10 steps each, and train_calibration_g at
     scripts/train_calibration_g.py's defaults cut to 25 steps (the mapping
     unchanged); ms a step and peak memory;
  18. reference check at a small size in fp32: every new backbone, the Sashimi
     forward and backward, the Discriminator, PSPEncoder and conv3d noise
     pyramid, and one step of each trainer (losses and gradients), card
     against CPU with the same weights and draws;
  19. a trained run loaded back: phase 6's run through
     train.evaluate.load_checkpoint (its forward on phase 4's features equal
     to the trained model's, torch.equal), generate_longform on phase 11's
     60 s track at 1024 px (bf16, batch 16), generate_by_data_split of 2
     windows at 256 px, feature_sensitivity on 192 frames x 59 features x 4
     perturbations; then three synthetic tracks as a raw streaming cache and
     as windowed shards (the first batch equal) and train.main for 4 steps at
     phase 6's width on the raw cache (MmapWindowDataset, the native loader
     built by g++), with its diagnostics PNGs; B1 / B2 / B3 launches checked
     exactly on each path;
  20. the paper's comparison at scripts/run_study.py's configuration: a
     256 px StyleGAN2 (max_channels 512, random weights, bf16), two 16 s
     synthetic clips at 24576 Hz (cut from 6), the random patch, phase 6's
     reactor, the comparison's test-time optimization (N = 128, 512 steps)
     and the LucidSonicDreams recipe through compare_models, then its
     forward-only pass; the scorer's calibration on the four recipes
     (rendered at 256 px, resized to 128 px); av_feature_study and its report
     over the recipe clips; ood.video_vs_generator through a discriminator's
     features over 256 samples; preliminary_study on the study's features;
     every (clip, model) record present and finite, seconds a record, the
     music information's seconds, peak memory and launches (exact);
  21. reference check at a small size in fp32 (64 px model, 4 s clip), card
     against CPU with the same weights and draws: evaluate_clip of each
     predictor, feature_sensitivity, ood.compute with the default extractor,
     one calibration recipe's frames;
  22. the extractors and the small leftovers at full width: the 2-D median
     helpers on phase 11's |STFT| (1025, 1441), k = 31 (B1 2, bit-equal to
     the plain version), video_absdiff on phase 13's (1440, 3, 256, 256)
     frames (B2 1), hpcp / raw_hpcp / tempogram_ratio on phase 11's track,
     the parity CLI at 8 s (no FAIL, rms and mel within 1e-2 of the numpy
     oracles; B1 28 and B1 bwd 4), a ResNet-50 through swav_extractor into
     ood.compute, an IR-SE50 GradualStyleEncoder through invert_frames (192
     frames at 256 px, traced once), psp_apply through phase 4's 1024 px
     decoder with and without a latent_mask and autotune over the
     inversion's batch size, SlowFast R50 over the clip, synchro_saliency;
     stage seconds (utils.profiling.StageTimer), peak memory, images/s and
     frames/s, launches exact at each stage; the new call sites' B1 and B2
     times beside their bounds;
  23. reference check at a small size in fp32, card against CPU with the same
     weights: ResNet-50, SlowFast R50 TINY, a small IR-SE encoder through
     psp_apply and a 64 px decoder, VGGish, SlowFastVideo, hpcp, raw_hpcp and
     tempogram_ratio (REF_RTOL, REF_FLIP_SHARE).
It prints one JSON line describing the kernels, then the nvidia-smi line,
then {"ok": true, "device": {...}} as the last line.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import json
import math
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

SEED = 0
FPS = 24
ROOT = Path(__file__).resolve().parent
# H100 SXM published peaks (data sheet; boost clock 1.98 GHz, 132 SMs)
FP32_PEAK_OPS = 67e12   # fp32 FLOP/s outside the tensor cores (an FMA counts 2)
HBM_BYTES_PER_S = 3.35e12
SM_CLOCK_HZ, N_SMS = 1.98e9, 132
SFU_OPS_PER_S = 16 * N_SMS * SM_CLOCK_HZ    # transcendentals: 16 per clock per SM on sm_90
FP32_INSTR_PER_S = 128 * N_SMS * SM_CLOCK_HZ  # fp32 FMA-class instructions: 128 per clock per SM

# the train path's cell: the reference's grid of record (experiments.py "paper")
TRAIN_FLAGS = ["--backbone", "sashimi", "--decoder", "fixed", "--loss", "ssabsdiff", "--hidden_size", "32",
               "--num_layers", "4", "--n_latent_split", "3", "--batch_size", "32", "--lr", "1e-4",
               "--duration", "8", "--fps", "24"]
TRAIN_STEPS = 40
# the long-form bench's track (bench.py:bench_longform): 180 s at 1024 * FPS, cut by the default
# 1440-frame chunks (3 chunks with halos of 64: STFTs of 1440 + 2 * 64 + 1 frames)
LONG_SECONDS = 180
LONG_CHUNK_FRAMES = 1569
# the tuning estimate's HPSS of the track's first 4 s: 4 * FPS + 1 STFT frames
LONG_TUNING_FRAMES = 97
LONG_WARM_SECONDS = 120   # two chunks of 1440 frames: the timed run's chunk shapes
LONG_BATCH = 64
# the random-patch path: a 60 s track at 1024 * FPS, whose centred STFT has 60 * FPS + 1 frames
PATCH_SECONDS = 60
PATCH_FRAMES = PATCH_SECONDS * FPS + 1
PATCH_B1 = 8   # four HPSS a retrieve_music_information, two median filters each
# the evaluation path: phase 11's 60 s track rendered at 1024 px and downsampled 4x to 256 px for the metrics,
# and phase 4's 8 s clip at 1024 px as it is
EVAL_SIDE, EVAL_DOWNSAMPLE = 1024, 4
EVAL_VIDEO_E = 3 * (EVAL_SIDE // EVAL_DOWNSAMPLE) ** 2     # B2's row width on the 60 s clip: 3 * 256 * 256
CLIP_VIDEO_E = 3 * EVAL_SIDE**2                            # and on the 8 s clip
# B1 and B2 launches, derived from the code: evaluate_reactivity separates harmonic from percussive twice (the
# rhythmic and the chromatic metric, two filters an HPSS) and takes one absdiff; among VIDEO_FEATURES,
# video_flow_onsets and directogram each filter a directogram twice (k = 3, both axes) and absdiff takes one
# absdiff; visual_beats filters one directogram
EVAL_B1 = {"evaluate_reactivity": 4, "VIDEO_FEATURES": 4, "visual_beats": 2}
EVAL_B2 = {"evaluate_reactivity": 1, "VIDEO_FEATURES": 1, "visual_beats": 0}


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, runs: int = 25) -> float:
    """Median over `runs` synchronised runs of one call, in ms (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def device_ms(prof) -> float:
    """Summed device time of a profile's kernels and copies (device-side
    events only)."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation) / 1e3


def device_ms_per_call(fn, calls: int = 20) -> float:
    """Device time of one call, from torch.profiler over `calls` calls: the
    kernels' own time, without the host's launch and wrapper overhead that
    ``cuda_ms`` also sees at small shapes.  Every call launches at least one
    kernel, so a trace with fewer device events than calls, or no device
    time, has lost some (the profiler now and then hands back none): it is
    traced again, up to five times, and then the run fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
        ms = sum(e.self_device_time_total for e in events) / 1e3 / calls
        if sum(e.count for e in events) >= calls and ms > 0:
            return ms
        time.sleep(0.1)
    fail(f"torch.profiler lost the device events of {calls} calls in five traces in a row")


def median_design_ops(k: int) -> float:
    """fp32 min/max operations an output of csrc/sliding_median.cu's design: a
    thread sorts the k - P + 1 values its P windows share with Batcher's
    odd-even merge sort, of which only what the P middle ranks depend on is
    live (counted here by walking the network backwards), then per output
    sorts P - 1 extras and selects with P - 1 max and P - 1 min."""
    P = 4 if k >= 7 else (2 if k >= 3 else 1)

    def batcher(n):
        net, p = [], 1
        while p < n:
            q = p
            while q >= 1:
                for j in range(q % p, n - q, 2 * q):
                    for i in range(min(q, n - j - q)):
                        if (i + j) // (2 * p) == (i + j + q) // (2 * p):
                            net.append((i + j, i + j + q))
                q //= 2
            p *= 2
        return net

    C, H = k - P + 1, k // 2
    live, ops = set(range(H - P + 1, H + 1)), 0
    for a, b in reversed(batcher(C)):
        used = (a in live) + (b in live)   # a min for wire a, a max for wire b
        if used:
            ops += used
            live |= {a, b}
    return ops / P + 2 * len(batcher(P - 1)) + 2 * (P - 1)


def median_bound_ms(numel: int, k: int) -> tuple[float, str, float]:
    """Least time for one sliding median: the function moves each input and
    each output once (8 B an fp32 element at 3.35 TB/s), whatever the
    algorithm.  Also returns the operations time of the design that is used:
    its min/max an output at 128 a clock an SM (min/max are not FMAs: the
    67 TFLOP/s peak counts two operations an instruction)."""
    return 2 * 4 * numel / HBM_BYTES_PER_S * 1e3, "bytes", numel * median_design_ops(k) / FP32_INSTR_PER_S * 1e3


def median_bwd_bound_ms(numel: int, k: int) -> tuple[float, str, float]:
    """Least time for one sliding-median backward: x, out and g read once and
    gx written once (16 B an element at 3.35 TB/s), against k compares and k
    selects for the first-equal-tap search and k compares and k adds for the
    gather (4k fp32 instructions an element at 128 a clock an SM).  Also
    returns the operations time."""
    t_bytes = 4 * 4 * numel / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * k * numel / FP32_INSTR_PER_S * 1e3
    return (t_ops, "operations", t_ops) if t_ops >= t_bytes else (t_bytes, "bytes", t_ops)


def absdiff_bound_ms(B: int, T: int, E: int, itemsize: int = 4) -> tuple[float, str]:
    """Least time for one batched absdiff: x (B, T, E) read once and y (B, T)
    written once (`itemsize` bytes an element) at 3.35 TB/s, against a
    subtract, an absolute value and an add (3 fp32 operations) per element at
    67 TFLOP/s."""
    t_bytes = itemsize * B * T * (E + 1) / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * B * (T - 1) * E / FP32_PEAK_OPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def vandermonde_bound_ms(H: int, N: int, L: int, backward: bool) -> tuple[float, str]:
    """Least time for the S4D Vandermonde at (H, N, L).  Operations: each of
    the H*N*L terms takes 3 transcendentals (exp, sin, cos) at the SFU rate
    (16 per clock per SM) and ~8 fp32 FMA-class instructions forward (~12
    backward) at 128 per clock per SM; the two units run side by side, so the
    slower one bounds.  Bytes: four (H, N) inputs read and K (H, L) written
    once forward; the four inputs and g (H, L) read and four (H, N)
    gradients written once backward."""
    terms = H * N * L
    t_ops = max(3 * terms / SFU_OPS_PER_S, (12 if backward else 8) * terms / FP32_INSTR_PER_S) * 1e3
    t_bytes = 4 * ((8 if backward else 4) * H * N + H * L) / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def within(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> tuple[bool, float]:
    """(|got - want| <= atol + rtol |want| everywhere, max |got - want|)."""
    err = (got - want).abs()
    return bool((err <= atol + rtol * want.abs()).all()), float(err.max())


def synthetic_track(sr: int, seconds: float, section_seconds: float | None = None) -> np.ndarray:
    """Chirp-modulated tone + noise + clicks every half second.  With
    `section_seconds` the tone steps through a four-chord cycle, one chord
    (root, third, fifth) per section, and every other section is louder: a
    track with structure for the segmentation to find."""
    t = np.arange(int(sr * seconds)) / sr
    rng = np.random.RandomState(SEED)
    wobble = 1 + 0.05 * np.sin(2 * np.pi * t / 7)
    if section_seconds is None:
        tone = 0.4 * np.sin(2 * np.pi * 220 * t * wobble)
    else:
        section = (t // section_seconds).astype(int)
        root = 220.0 * 2 ** (np.array([0, 5, 7, 3])[section % 4] / 12)
        gain = np.where(section % 2 == 0, 0.25, 0.4)
        phase = 2 * np.pi * np.cumsum(root * wobble) / sr
        tone = gain * (np.sin(phase) + 0.5 * np.sin(phase * 2 ** (4 / 12)) + 0.5 * np.sin(phase * 2 ** (7 / 12))) / 2
    audio = (tone + 0.1 * rng.randn(len(t))).astype(np.float32)
    audio[:: sr // 2] += 1.0
    return audio


class FrameSink:
    """In-memory frame writer: counts frames and keeps each frame's CRC32."""

    def __init__(self, shape):
        self.shape, self.crcs = tuple(shape), []
        self.y_range = [255, 0]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def write_i420(self, frame):
        if frame.shape != self.shape or frame.dtype != np.uint8:
            raise ValueError(f"frame {frame.shape} {frame.dtype}, expected {self.shape} uint8")
        y = frame[: self.shape[1]]
        self.y_range = [min(self.y_range[0], int(y.min())), max(self.y_range[1], int(y.max()))]
        self.crcs.append(zlib.crc32(np.ascontiguousarray(frame).tobytes()))

    def write(self, frame):
        raise ValueError("expected I420 frames at 1024 x 1024")


class RGBSink:
    """In-memory frame writer that keeps every (H, W, 3) uint8 RGB frame in
    pinned host memory, as a decoder hands a file's frames over."""

    def __init__(self, n: int, side: int):
        self.frames = torch.empty((n, side, side, 3), dtype=torch.uint8, pin_memory=True)
        self.n = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def write(self, frame):
        self.frames[self.n].copy_(torch.from_numpy(frame))
        self.n += 1

    def write_i420(self, frame):
        raise ValueError("expected RGB frames")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    from ssar_tpu_torch.audio.features import PARITY_BUDGETS, audio2features
    from ssar_tpu_torch.audio.pitch import estimate_tuning_device
    from ssar_tpu_torch.gan.render import rgb_to_i420
    from ssar_tpu_torch.gan.stylegan2 import StyleGAN2Config
    from ssar_tpu_torch.gan.wrapper import StyleGAN2Synthesizer
    from ssar_tpu_torch.generate.audio2video import react, render_reaction
    from ssar_tpu_torch.models.reactor import LatentNoiseReactor
    from ssar_tpu_torch.ops import _build, median_cuda
    from ssar_tpu_torch.utils.device import full_precision

    dev = torch.device("cuda")
    # ---------------------------------------------------------------- 1 --
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    # ---------------------------------------------------------------- 2 --
    t0 = time.perf_counter()
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    log(f"[build] {sources} in {time.perf_counter() - t0:.2f} s")
    for name, info in _build.build_log.items():
        lines = [ln.strip() for ln in info["ptxas"].splitlines() if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: nvcc {info['seconds']:.2f} s; ptxas: {lines[:2]}")

    # ----------------------------------------------------------- 3, 3c --
    track40 = synthetic_track(44100, 40.0, section_seconds=8.0)
    n_sync = beat_sync_frames(track40, 44100, dev)
    rows, max_err = check_median(dev, n_sync)
    bwd_rows, bwd_err = check_median_bwd(dev, n_sync)
    generic_rows, generic_err = check_median_generic(dev)

    # --------------------------------------------------------------- 3b --
    absdiff_rows, absdiff_err = check_absdiff(dev)
    vdm_rows, vdm_err, vdm_bwd_err = check_vandermonde(dev)

    # ---------------------------------------------------------------- 4 --
    sr_in = 44100
    audio = synthetic_track(sr_in, 8.0)
    config = StyleGAN2Config()  # 1024 px, channel_multiplier 2, max_channels 512
    synthesizer = StyleGAN2Synthesizer(model_file=None, output_size=(1024, 1024), config=config, seed=SEED,
                                       dtype=torch.bfloat16, device=dev)
    palette = torch.randn(96, config.n_latent, 512, generator=torch.Generator().manual_seed(SEED))
    batch_size = 16

    def main_path(track, sink):
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        feats = audio2features(track, sr_in, FPS, device=dev)
        torch.cuda.synchronize()
        t_b = time.perf_counter()
        model = LatentNoiseReactor(feats.mean(0), feats.std(0) + 1e-6, palette, backbone="gru",
                                   hidden_size=32, num_layers=4)
        model = model.to(dev).eval()
        latents, noise = react(model, feats, torch.Generator(dev).manual_seed(SEED + 1))
        torch.cuda.synchronize()
        t_c = time.perf_counter()
        render_reaction(latents, noise, output_size=(1024, 1024), batch_size=batch_size, gan_config=config,
                        synthesizer=synthesizer, writer=sink)
        torch.cuda.synchronize()
        t_d = time.perf_counter()
        return feats, latents, noise, {"features_s": t_b - t_a, "reactor_s": t_c - t_b, "render_s": t_d - t_c}

    # warm-up on 1 s (cuFFT plans, cuDNN heuristics, host filter-bank caches)
    main_path(audio[: sr_in], FrameSink((1536, 1024)))

    median_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    sink = FrameSink((1536, 1024))
    feats, latents, noise, stages = main_path(audio, sink)
    launches = median_cuda.launches
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    T = feats.shape[0]
    if tuple(feats.shape) != (192, 59) or not bool(torch.isfinite(feats).all()):
        fail(f"features {tuple(feats.shape)}, finite={bool(torch.isfinite(feats).all())}")
    if tuple(latents.shape) != (T, 18, 512) or not bool(torch.isfinite(latents).all()):
        fail(f"latents {tuple(latents.shape)}")
    want_noise = [(T, 1, s, s) for s in (4, 8, 16, 32)]
    if [tuple(n.shape) for n in noise] != want_noise or not all(bool(torch.isfinite(n).all()) for n in noise):
        fail(f"noise maps {[tuple(n.shape) for n in noise]}")
    if len(sink.crcs) != T:
        fail(f"{len(sink.crcs)} frames written, expected {T}")
    if len(set(sink.crcs)) < T // 2 or not (16 <= sink.y_range[0] <= sink.y_range[1] <= 235):
        fail(f"frames: {len(set(sink.crcs))} distinct checksums, luma range {sink.y_range}")
    if launches == 0:
        fail("the main path launched no sliding-median kernel")
    total = sum(stages.values())
    log(f"[main] 8 s @ 44.1 kHz -> features {tuple(feats.shape)} -> latents {tuple(latents.shape)} + "
        f"{len(noise)} noise maps -> {len(sink.crcs)} I420 frames 1024x1024, batch {batch_size}, bf16")
    log("[main] " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; end-to-end {total:.3f} s = {T / total:.2f} fps; render {T / stages['render_s']:.2f} fps; "
        f"peak memory {peak_gb:.2f} GiB; sliding_median launches {launches}; frame crc[0] {sink.crcs[0]:08x}")

    # --------------------------------------------------------------- 4b --
    long_counts = longform_path(dev, synthesizer, config, palette)

    # ---------------------------------------------------------------- 5 --
    small = synthetic_track(sr_in, 2.0)
    tun_card = float(estimate_tuning_device(torch.as_tensor(small, device=dev), sr_in))
    tun_cpu = float(estimate_tuning_device(torch.as_tensor(small), sr_in))
    if tun_card != tun_cpu:
        fail(f"tuning estimate on the card {tun_card} != CPU {tun_cpu}")
    f_card = audio2features(small, sr_in, FPS, tuning=0.0, device=dev).cpu()
    f_cpu = audio2features(small, sr_in, FPS, tuning=0.0, device="cpu")
    for group, (cols, budget) in PARITY_BUDGETS.items():
        err = float((f_card[:, cols] - f_cpu[:, cols]).abs().max())
        if err > budget:
            fail(f"features card vs CPU: {group} deviates by {err:.3g} > {budget}")
    log(f"[reference] features card vs CPU within the docs/PARITY.md budgets; "
        f"max {float((f_card - f_cpu).abs().max()):.3g}")

    cfg_s = StyleGAN2Config(resolution=128, max_channels=64)
    syn_cpu = StyleGAN2Synthesizer(config=cfg_s, seed=SEED, dtype=torch.float32, device="cpu")
    syn_card = StyleGAN2Synthesizer(config=cfg_s, dtype=torch.float32, device=dev,
                                    params=_to(syn_cpu.params, dev))
    lat = torch.randn(4, cfg_s.n_latent, 512, generator=torch.Generator().manual_seed(SEED))
    with full_precision():
        img_card = syn_card(lat).cpu()
    img_cpu = syn_cpu(lat)
    err = float((img_card - img_cpu).abs().max())
    if err > 1e-3:
        fail(f"synthesis card vs CPU (fp32, 128 px) deviates by {err:.3g}")
    frames = ((img_cpu + 1) / 2)
    yuv_err = int((rgb_to_i420(frames.to(dev)).cpu().int() - rgb_to_i420(frames).int()).abs().max())
    if yuv_err > 1:
        fail(f"rgb_to_i420 card vs CPU differs by {yuv_err} levels")
    log(f"[reference] synthesis card vs CPU fp32 max {err:.3g}; I420 card vs CPU max {yuv_err} level(s)")
    reference_longform(dev)
    reference_wrapper(dev, syn_cpu)

    # ---------------------------------------------------------------- 6 --
    train_counts, train_log_dir = train_path(dev, feats)

    # ---------------------------------------------------------------- 7 --
    reference_step(dev)

    # ----------------------------------------------------------- 8, 9, 10 --
    optimize_comparison(dev, track40, config)
    opt_counts = optimize_standalone(dev, track40, n_sync)
    reference_optimize(dev)

    # ---------------------------------------------------------- 11, 12 --
    patch_counts = patch_path(dev)
    reference_patch(dev)
    check_c4(dev)

    # ---------------------------------------------------------- 13, 14 --
    t0 = time.perf_counter()
    eval_counts, eval_frames = evaluate_path(dev, synthesizer, config, palette, audio, latents, noise)
    t1 = time.perf_counter()
    reference_evaluate(dev)
    log(f"[evaluate] phase 13 took {t1 - t0:.1f} s, phase 14 {time.perf_counter() - t1:.1f} s")

    # ------------------------------------------------------------ 15-18 --
    t0 = time.perf_counter()
    backbone_counts = backbones_path(dev)
    sashimi_counts = sashimi_path(dev)
    trainers_path(dev)
    reference_families(dev)
    log(f"[families] phases 15-18 took {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------------ 19-21 --
    t0 = time.perf_counter()
    checkpoint_counts = checkpoint_path(dev, train_log_dir, feats)
    t1 = time.perf_counter()
    study_counts = study_path(dev, train_log_dir)
    t2 = time.perf_counter()
    reference_study(dev)
    log(f"[study] phase 19 took {t1 - t0:.1f} s, phase 20 {t2 - t1:.1f} s, phase 21 {time.perf_counter() - t2:.1f} s")

    # ------------------------------------------------------------ 22-23 --
    t0 = time.perf_counter()
    extractor_counts, extractor_rows = extractors_path(dev, eval_frames, audio, synthesizer, config)
    del eval_frames
    t1 = time.perf_counter()
    reference_extractors(dev)
    log(f"[extractors] phase 22 took {t1 - t0:.1f} s, phase 23 {time.perf_counter() - t1:.1f} s")

    main_row = [r for r in rows if r["shape"] == [1025, 193]]  # both axes: one HPSS
    # absdiff: the five launches of one ssabsdiff loss (latents and the four noise maps, batch 32)
    ad_path = [r for r in absdiff_rows if r["path"]]
    # Vandermonde: one launch at the train path's shape, (104, 32, 192) (hidden 32, fixed decoder)
    vdm_path = next(r for r in vdm_rows if r["shape"] == [104, 32, 192])

    def sums(rows_, prefix=""):
        return {"ms": sum(r[prefix + "ms"] for r in rows_), "plain_ms": sum(r[prefix + "plain_ms"] for r in rows_),
                "bound_ms": sum(r[prefix + "bound_ms"] for r in rows_), "bound_by": rows_[0][prefix + "bound_by"]}

    kernels = [{
        "name": "sliding_median", "route": "cuda", "source": "ssar_tpu_torch/csrc/sliding_median.cu",
        "replaces": "ssar_tpu/ops/median_pallas.py:29", "launches": launches, "max_abs_err": max_err,
        # one HPSS at the main path's shape: the time-axis and the frequency-axis filter of (1025, 193)
        **sums(main_row), "library_ms": None, "launches_optimize": opt_counts["sliding_median"],
        "launches_longform": long_counts["sliding_median"], "launches_patch": patch_counts["sliding_median"],
        "launches_evaluate": eval_counts["sliding_median"], "launches_checkpoint": checkpoint_counts["sliding_median"],
        "launches_study": study_counts["sliding_median"], "launches_extractors": extractor_counts["sliding_median"],
    }, {
        "name": "sliding_median_generic", "route": "cuda", "source": "ssar_tpu_torch/csrc/sliding_median.cu",
        "replaces": "ssar_tpu/ops/median_pallas.py:29", "launches": long_counts["sliding_median_generic"],
        "max_abs_err": generic_err,
        # no path runs k > 31: both axes of (1025, 193) at k = 33
        **sums([r for r in generic_rows if r["k"] == 33]), "library_ms": None,
    }, {
        "name": "sliding_median_generic_bwd", "route": "cuda", "source": "ssar_tpu_torch/csrc/sliding_median_bwd.cu",
        "replaces": "ssar_tpu/ops/median_pallas.py:110", "launches": long_counts["sliding_median_generic_bwd"],
        "max_abs_err": generic_err, **sums([r for r in generic_rows if r["k"] == 33], "bwd_"), "library_ms": None,
    }, {
        "name": "sliding_median_bwd", "route": "cuda", "source": "ssar_tpu_torch/csrc/sliding_median_bwd.cu",
        "replaces": "ssar_tpu/ops/median_pallas.py:110", "launches": opt_counts["sliding_median_bwd"],
        "max_abs_err": bwd_err,
        # one prediction's pair on the optimize path: (2n, n) k = 7 and (n, n) k = 9
        **sums([r for r in bwd_rows if r["path"]]), "library_ms": None,
        "launches_study": study_counts["sliding_median_bwd"],
        "launches_extractors": extractor_counts["sliding_median_bwd"],
    }, {
        "name": "absdiff", "route": "cuda", "source": "ssar_tpu_torch/csrc/absdiff.cu",
        "replaces": "ssar_tpu/ops/absdiff.py:38", "launches": train_counts["absdiff"],
        "max_abs_err": absdiff_err, **sums(ad_path), "library_ms": None,
        "launches_evaluate": eval_counts["absdiff"], "launches_backbones": backbone_counts["absdiff"],
        "launches_checkpoint": checkpoint_counts["absdiff"], "launches_study": study_counts["absdiff"],
        "launches_extractors": extractor_counts["absdiff"],
    }, {
        "name": "s4d_vandermonde", "route": "cuda", "source": "ssar_tpu_torch/csrc/s4d_vandermonde.cu",
        "replaces": "ssar_tpu/ops/vandermonde.py:32", "launches": train_counts["s4d_vandermonde"],
        "max_abs_err": vdm_err, **sums([vdm_path]), "library_ms": None,
        "launches_sashimi": sashimi_counts["s4d_vandermonde"], "launches_checkpoint": checkpoint_counts["s4d_vandermonde"],
        "launches_study": study_counts["s4d_vandermonde"],
    }, {
        "name": "s4d_vandermonde_bwd", "route": "cuda", "source": "ssar_tpu_torch/csrc/s4d_vandermonde.cu",
        "replaces": "ssar_tpu/ops/vandermonde.py:92", "launches": train_counts["s4d_vandermonde_bwd"],
        "max_abs_err": vdm_bwd_err, **sums([vdm_path], "bwd_"), "library_ms": None,
        "launches_sashimi": sashimi_counts["s4d_vandermonde_bwd"],
        "launches_checkpoint": checkpoint_counts["s4d_vandermonde_bwd"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}), flush=True)


def longform_path(dev, synthesizer, config, palette) -> dict:
    """Phase 4b: the long-form bench's configuration end to end on the card,
    after a warm-up at the same chunk shapes and batch (cuFFT plans, host
    filter-bank caches, cuDNN heuristics); returns the sliding-median launch
    counts of the timed run's feature call."""
    from ssar_tpu_torch.generate.audio2video import react, render_reaction
    from ssar_tpu_torch.models.reactor import LatentNoiseReactor
    from ssar_tpu_torch.ops import median_cuda
    from ssar_tpu_torch.parallel.features_sp import _chunk_plan, audio2features_long

    sr = 1024 * FPS
    T = LONG_SECONDS * FPS
    n_chunks = math.ceil(T / 1440)
    for seconds in (LONG_SECONDS, LONG_WARM_SECONDS):
        cf = _chunk_plan(seconds * FPS, math.ceil(seconds * FPS / 1440))[2]
        if cf + 1 != LONG_CHUNK_FRAMES:
            fail(f"long-form chunks of {cf} frames at {seconds} s, phase 3 timed {LONG_CHUNK_FRAMES - 1}")
    if 4 * sr // 1024 + 1 != LONG_TUNING_FRAMES:
        fail(f"the tuning HPSS has {4 * sr // 1024 + 1} frames, phase 3 timed {LONG_TUNING_FRAMES}")
    want_b1 = 4 * n_chunks + 2  # two HPSS a chunk (the chromagram separates again), one for the tuning

    def run(track, n_frames):
        """Features, reactor and the render of the first `n_frames` frames,
        with the B1 counts of the feature call and the stage boundaries."""
        torch.cuda.synchronize()
        median_cuda.launches = median_cuda.generic_launches = median_cuda.generic_bwd_launches = 0
        t_a = time.perf_counter()
        feats = audio2features_long(track, sr, FPS, device=dev)
        torch.cuda.synchronize()
        t_b = time.perf_counter()
        counts = {"sliding_median": median_cuda.launches, "sliding_median_generic": median_cuda.generic_launches,
                  "sliding_median_generic_bwd": median_cuda.generic_bwd_launches}
        model = LatentNoiseReactor(feats.mean(0), feats.std(0) + 1e-6, palette, backbone="gru", hidden_size=32,
                                   num_layers=4).to(dev).eval()
        latents, noise = react(model, feats, torch.Generator(dev).manual_seed(SEED + 1))
        torch.cuda.synchronize()
        t_c = time.perf_counter()
        sink = FrameSink((1536, 1024))
        render_reaction(latents[:n_frames], [n[:n_frames] for n in noise], output_size=(1024, 1024),
                        batch_size=LONG_BATCH, gan_config=config, synthesizer=synthesizer, writer=sink)
        torch.cuda.synchronize()
        return feats, latents, sink, counts, (t_a, t_b, t_c, time.perf_counter())

    run(synthetic_track(sr, LONG_WARM_SECONDS), LONG_BATCH)
    track = synthetic_track(sr, LONG_SECONDS)   # bench_longform's track: the same tone, noise and clicks
    torch.cuda.reset_peak_memory_stats()
    feats, latents, sink, counts, (t_a, t_b, t_c, t_d) = run(track, T)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    if tuple(feats.shape) != (T, 59) or not bool(torch.isfinite(feats).all()):
        fail(f"long-form features {tuple(feats.shape)}, finite={bool(torch.isfinite(feats).all())}")
    if tuple(latents.shape) != (T, 18, 512) or not bool(torch.isfinite(latents).all()):
        fail(f"long-form latents {tuple(latents.shape)}")
    if len(sink.crcs) != T or len(set(sink.crcs)) < T // 2 or not (16 <= sink.y_range[0] <= sink.y_range[1] <= 235):
        fail(f"long-form frames: {len(sink.crcs)} written, {len(set(sink.crcs))} distinct, luma {sink.y_range}")
    if counts != {"sliding_median": want_b1, "sliding_median_generic": 0, "sliding_median_generic_bwd": 0}:
        fail(f"long-form features launched the median kernels {counts}, expected {want_b1} and no generic one")
    total = t_d - t_a
    log(f"[longform] {LONG_SECONDS} s @ {sr} Hz -> audio2features_long {tuple(feats.shape)} in {n_chunks} chunks -> "
        f"latents {tuple(latents.shape)} -> {len(sink.crcs)} I420 frames 1024x1024, batch {LONG_BATCH}, bf16 "
        f"(warmed up on {LONG_WARM_SECONDS} s and one batch)")
    log(f"[longform] features_s {t_b - t_a:.3f}, reactor_s {t_c - t_b:.3f}, render_s {t_d - t_c:.3f}; end-to-end "
        f"{total:.3f} s = {T / total:.2f} fps = {LONG_SECONDS / total:.2f}x realtime; render {T / (t_d - t_c):.2f} fps; "
        f"peak memory {peak_gb:.2f} GiB; sliding_median launches {counts['sliding_median']} (expected {want_b1}); "
        f"frame crc[0] {sink.crcs[0]:08x}")
    return counts


def reference_longform(dev):
    """Phase 5, long form: 30 s in chunks of 240 frames (3 chunks) on the
    card and on the CPU within the docs/PARITY.md budgets, with a fixed
    tuning and with the host estimate (the same on both); on the card within
    1 % of the largest feature of the whole-track stack (the bound
    tests/test_parallel.py sets)."""
    from ssar_tpu_torch.audio.features import PARITY_BUDGETS, audio2features, harmonic
    from ssar_tpu_torch.audio.pitch import estimate_tuning
    from ssar_tpu_torch.parallel.features_sp import audio2features_long

    sr = 1024 * FPS
    track = synthetic_track(sr, 30.0)
    # the tuning audio2features_long estimates when given none: the harmonic part of the first 4 s
    tunings = [estimate_tuning(harmonic(torch.as_tensor(track[: 4 * sr], device=d)), sr, bins_per_octave=36)
               for d in (dev, "cpu")]
    if tunings[0] != tunings[1]:
        fail(f"long-form tuning estimate on the card {tunings[0]} != CPU {tunings[1]}")
    cards = {}
    for tuning in (0.0, None):
        card = cards[tuning] = audio2features_long(track, sr, FPS, chunk_frames=240, tuning=tuning, device=dev).cpu()
        cpu = audio2features_long(track, sr, FPS, chunk_frames=240, tuning=tuning, device="cpu")
        for group, (cols, budget) in PARITY_BUDGETS.items():
            err = float((card[:, cols] - cpu[:, cols]).abs().max())
            if err > budget:
                fail(f"long-form features (tuning={tuning}) card vs CPU: {group} deviates by {err:.3g} > {budget}")
        log(f"[reference] long-form features (30 s, 3 chunks, tuning={tuning}) card vs CPU within the budgets, "
            f"max {float((card - cpu).abs().max()):.3g}")
    card = cards[0.0]
    whole = audio2features(track, sr, FPS, tuning=0.0, device=dev).cpu()
    dev_whole = float((card - whole).abs().max())
    if tuple(card.shape) != (720, 59) or not dev_whole < 0.01 * float(whole.abs().max()):
        fail(f"long-form features {tuple(card.shape)} deviate from the whole-track stack by {dev_whole:.3g}")
    log(f"[reference] long-form tuning estimate {tunings[0]} on both; long-form features (tuning=0.0) against the "
        f"whole-track stack on the card {dev_whole:.3g} (largest feature {float(whole.abs().max()):.3g})")


def _rosinality_sd(params: dict) -> dict:
    """The port's parameters as a rosinality Generator state dict."""
    sd = {"input.input": params["const"][None], "latent_avg": params["w_avg"]}
    for i, lin in enumerate(params["mapping"]):
        sd[f"style.{i + 1}.weight"], sd[f"style.{i + 1}.bias"] = lin["weight"], lin["bias"]

    def put(prefix, p):
        sd[f"{prefix}.conv.weight"] = p["weight"][None]
        sd[f"{prefix}.conv.modulation.weight"], sd[f"{prefix}.conv.modulation.bias"] = p["mod"]["weight"], p["mod"]["bias"]
        if "noise_weight" in p:
            sd[f"{prefix}.noise.weight"], sd[f"{prefix}.activate.bias"] = p["noise_weight"].reshape(1), p["bias"]
        else:
            sd[f"{prefix}.bias"] = p["bias"].reshape(1, 3, 1, 1)

    put("conv1", params["conv1"])
    put("to_rgb1", params["to_rgb1"])
    for i, p in enumerate(params["convs"]):
        put(f"convs.{i}", p)
    for i, p in enumerate(params["to_rgbs"]):
        put(f"to_rgbs.{i}", p)
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


def reference_wrapper(dev, syn_cpu):
    """Phase 5, the wrapper at 128 px (64 channels), fp32: a static and an
    animated bend and a non-square output size (96, 64) at 64 px native, card
    against CPU within 1e-3; a rosinality .pt written from the random weights
    and loaded back renders the same frames on the card."""
    from ssar_tpu_torch.gan.render import render_latents_to_video
    from ssar_tpu_torch.gan.stylegan2 import StyleGAN2Config
    from ssar_tpu_torch.gan.wrapper import StyleGAN2Synthesizer
    from ssar_tpu_torch.utils.device import full_precision

    cfg = syn_cpu.config
    rng = np.random.RandomState(SEED + 9)
    mod = rng.randn(12).astype(np.float32)
    bends = [{"layer": 1, "transform": lambda x: 1.5 * x + 0.1},
             {"layer": 3, "transform": lambda x, m: x + m[:, None, None, None], "modulation": mod}]
    lat = torch.as_tensor(rng.randn(4, cfg.n_latent, 512).astype(np.float32))
    frame_idx = [2, 5, 11, 40]   # the last is clipped to the modulation's length
    out = []   # (bent, non-square) images on the card, then on the CPU
    for device in (dev, torch.device("cpu")):
        syn = StyleGAN2Synthesizer(config=cfg, dtype=torch.float32, device=device, params=_to(syn_cpu.params, device))
        syn.set_bends(bends)
        small = StyleGAN2Synthesizer(config=StyleGAN2Config(resolution=64, max_channels=64), output_size=(96, 64),
                                     seed=SEED, dtype=torch.float32, device=device)
        with full_precision():
            out.append((syn(lat, frame_idx=frame_idx).cpu(), small(lat[:, :small.config.n_latent]).cpu()))
    errs = [float((a - b).abs().max()) for a, b in zip(*out)]
    for name, err in zip(("bent", "non-square"), errs):
        if err > 1e-3:
            fail(f"synthesis ({name}) card vs CPU deviates by {err:.3g}")
    if tuple(out[0][1].shape) != (4, 64, 96, 3):
        fail(f"non-square output {tuple(out[0][1].shape)}, expected (4, 64, 96, 3)")

    path = ROOT / "build" / "chip_smoke_runs" / "g_random.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    params = _to(syn_cpu.params, dev)
    torch.save({"g_ema": _rosinality_sd(params)}, path)
    frames = []
    for syn in (StyleGAN2Synthesizer(config=cfg, dtype=torch.bfloat16, device=dev, params=params),
                StyleGAN2Synthesizer(model_file=str(path), config=cfg, dtype=torch.bfloat16, device=dev)):
        sink = render_latents_to_video(syn, lat, None, batch_size=4, progress=False,
                                       writer=FrameSink((3 * cfg.resolution // 2, cfg.resolution)))
        frames.append(sink.crcs)
    if frames[0] != frames[1] or len(frames[0]) != 4:
        fail(f"frames of the .pt loaded back differ from its parameters' ({frames})")
    log(f"[reference] wrapper card vs CPU fp32: bent synthesis max {errs[0]:.3g}, (96, 64) from 64 px max "
        f"{errs[1]:.3g}; a rosinality .pt of the random weights renders the same {len(frames[0])} frames "
        f"(crc[0] {frames[0][0]:08x})")


def beat_sync_frames(track: np.ndarray, sr: int, dev) -> int:
    """The number of beat-synchronous frames the optimize path's segmentation
    makes of `track`: the host beat tracker on the onset envelope of the
    track at 1024 * FPS, beats strictly inside the clip, plus one."""
    from ssar_tpu_torch.audio.beat import onset_strength
    from ssar_tpu_torch.audio.beat_host import beat_track
    from ssar_tpu_torch.ops.resample import resample
    from ssar_tpu_torch.utils.device import full_precision

    target = 1024 * FPS
    with torch.no_grad(), full_precision():
        audio = resample(torch.as_tensor(track, device=dev), sr, target, lowpass_filter_width=6)
        env = onset_strength(audio, target).cpu().numpy()
    _, beats = beat_track(env, sr=target, hop_length=1024)
    return len([b for b in beats if 0 < b < audio.shape[0] // 1024]) + 1


# lines no longer than k // 2 along one axis or both: the padding keeps reflecting
SHORT_LINES = [((40, 3), 7), ((5, 9), 31), ((2, 6, 1), 9)]


def median_case(shape, kind: str, gen, dev) -> torch.Tensor:
    """Distinct values, quantised values with a constant row ("ties"), or one
    value in 300 a NaN ("nan")."""
    x = torch.randn(shape, generator=gen, device=dev)
    if kind == "ties":
        x = torch.round(x * 2) / 2
        x[..., 0, :] = 1.0
    elif kind == "nan":
        flat = x.view(-1)
        flat[torch.randperm(flat.numel(), generator=gen, device=dev)[: max(1, flat.numel() // 300)]] = float("nan")
    return x


def equal_with_nans(got: torch.Tensor, want: torch.Tensor) -> bool:
    """NaNs in the same places and every other value equal."""
    return torch.equal(got.isnan(), want.isnan()) and torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0))


def check_median(dev, n_sync: int):
    """B1's forward against its plain version, exactly (a selection): the
    serve path's (1025, 193), the long-form chunks' (1025, 1569) and tuning
    HPSS's (1025, 97), the random-patch and evaluation paths' (1025, 1441),
    a 3-minute track's (1025, 4320) on both axes, the directogram's k = 3
    filters at (1440, 8) and (192, 8), the
    optimize path's (2n, n) k = 7 and (n, n) k = 9, batched and awkward
    shapes, short lines, and on each an input holding NaNs (a window with a
    NaN gives NaN in both)."""
    from ssar_tpu_torch.ops.median import median_filter, median_filter_plain

    g = torch.Generator(device=dev).manual_seed(SEED)
    n = n_sync
    path = [((2 * n, n), 7), ((n, n), 9)]
    timed = [((1025, 193), 31), ((1025, 192), 31), ((1025, LONG_CHUNK_FRAMES), 31),
             ((1025, LONG_TUNING_FRAMES), 31), ((1025, PATCH_FRAMES), 31), ((1025, 4320), 31),
             ((4, 1025, 4320), 31), ((PATCH_SECONDS * FPS, 8), 3), ((8 * FPS, 8), 3)] + path
    checks = timed + [((1000, 100), 31), ((37, 16), 31), ((3, 53, 77), 7), ((53, 77), 9), ((130, 70), 9)] + SHORT_LINES
    max_err, rows, n_nan = 0.0, [], 0
    for shape, k in checks:
        for kind in ("distinct", "nan"):
            if kind == "nan" and math.prod(shape) > 5e6:
                continue
            x = median_case(shape, kind, g, dev)
            for axis in (-1, -2):
                got = median_filter(x, k, axis)
                want = median_filter_plain(x, k, axis)
                torch.cuda.synchronize()
                if not (equal_with_nans(got, want) if kind == "nan" else torch.equal(got, want)):
                    fail(f"sliding median differs from the plain version at {shape}, k={k}, axis={axis}, {kind} input")
                if kind == "nan":
                    n_nan += int(got.isnan().sum())
                    continue
                max_err = max(max_err, float((got - want).abs().max()))
                if (shape, k) not in timed or ((shape, k) in path and axis != -1):
                    continue
                ms = cuda_ms(lambda: median_filter(x, k, axis))
                plain = cuda_ms(lambda: median_filter_plain(x, k, axis), runs=20)
                dev_ms = device_ms_per_call(lambda: median_filter(x, k, axis))
                bound, by, ops_ms = median_bound_ms(x.numel(), k)
                rows.append({"shape": list(shape), "k": k, "axis": axis, "ms": ms, "dev_ms": dev_ms, "plain_ms": plain,
                             "bound_ms": bound, "bound_by": by})
                log(f"[kernel] sliding_median {shape} k={k} axis={axis}: {ms:.4f} ms, device {dev_ms:.4f} ms "
                    f"(plain {plain:.3f} ms, bound {bound:.5f} ms by {by}; the design's "
                    f"{median_design_ops(k):.1f} min/max an output take {ops_ms:.5f} ms)")
                if dev_ms < bound:
                    fail(f"sliding median's device time {dev_ms} ms at {shape} reads below its bound {bound} ms")
    if n_nan == 0:
        fail("the NaN inputs gave no NaN output")
    log(f"[kernel] sliding_median bit-exact on {len(checks)} shapes x both axes, {len(SHORT_LINES)} of them with lines "
        f"no longer than k // 2; NaNs in the same places as the plain version's ({n_nan} NaN outputs)")
    return rows, max_err


def check_median_bwd(dev, n_sync: int):
    """B1's backward against its plain version, bit for bit (the kernel
    gathers in the order the plain version adds): HPSS shapes (the serve
    path's, the long-form chunks', a 3-minute track's) on both axes,
    the optimize path's (2n, n) k = 7 and (n, n) k = 9 at the 40 s track's n,
    batched and ragged shapes, short lines; on distinct values, on quantised
    values with a constant row and on inputs holding NaNs (their windows
    route nothing); two launches equal."""
    from ssar_tpu_torch.ops import median_cuda
    from ssar_tpu_torch.ops.median import median_filter, sliding_median_bwd_plain

    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    n = n_sync
    path = [((2 * n, n), 7), ((n, n), 9)]
    timed = [((1025, 193), 31), ((1025, LONG_CHUNK_FRAMES), 31), ((1025, 4320), 31)] + path
    checks = timed + [((4, 1025, 300), 31), ((1000, 100), 31), ((37, 16), 31), ((3, 53, 77), 7), ((130, 70), 9),
                      ((5, 9), 9), ((3, 5, 40), 1)] + SHORT_LINES
    rows, max_err = [], 0.0
    for shape, k in checks:
        for kind in ("distinct", "ties", "nan"):
            ties = kind != "distinct"   # only distinct inputs are timed
            x = median_case(shape, kind, g, dev)
            cot = torch.randn(shape, generator=g, device=dev)
            for axis in (-1, -2):
                leaf = x.clone().requires_grad_()
                out = median_filter(leaf, k, axis)
                before = median_cuda.bwd_launches
                (got,) = torch.autograd.grad(out, leaf, cot)
                if median_cuda.bwd_launches != before + 1:
                    fail(f"median_filter's backward did not launch the kernel at {shape}, k={k}, axis={axis}")
                out = out.detach()
                again = median_cuda.sliding_median_bwd_cuda(x, out, cot, k, axis % x.ndim)
                want = sliding_median_bwd_plain(x, out, cot, k, axis)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"sliding median backward differs from the plain version at {shape}, k={k}, axis={axis}, "
                         f"{kind} input: max abs error {float((got - want).abs().max()):.3g}")
                if not torch.equal(got, again):
                    fail(f"sliding median backward: two launches differ at {shape}, k={k}, axis={axis}")
                max_err = max(max_err, float((got - want).abs().max()))
                if ties or (shape, k) not in timed or ((shape, k) in path and axis != -1):
                    continue
                fn = lambda: median_cuda.sliding_median_bwd_cuda(x, out, cot, k, axis % x.ndim)
                plain = lambda: sliding_median_bwd_plain(x, out, cot, k, axis)
                row = {"shape": list(shape), "k": k, "axis": axis, "path": (shape, k) in path, "ms": cuda_ms(fn),
                       "dev_ms": device_ms_per_call(fn), "plain_ms": cuda_ms(plain, runs=10),
                       "plain_dev_ms": device_ms_per_call(plain, calls=5)}
                row["bound_ms"], row["bound_by"], ops_ms = median_bwd_bound_ms(x.numel(), k)
                rows.append(row)
                if row["dev_ms"] < row["bound_ms"]:
                    fail(f"sliding median backward's device time {row['dev_ms']} ms at {shape} reads below its bound")
                log(f"[kernel] sliding_median_bwd {shape} k={k} axis={axis}: {row['ms']:.4f} ms, device "
                    f"{row['dev_ms']:.4f} ms (plain {row['plain_ms']:.4f}, device {row['plain_dev_ms']:.4f}; bound "
                    f"{row['bound_ms']:.5f} ms by {row['bound_by']}, operations {ops_ms:.5f} ms)")
    log(f"[kernel] sliding_median_bwd bit-exact on {len(checks)} shapes x both axes x (distinct, tied, NaN) inputs, "
        f"{len(SHORT_LINES)} of them with lines no longer than k // 2; two launches bit-identical; n_sync {n}")
    return rows, max_err


GENERIC = [((1025, 193), 33), ((1025, 193), 63), ((3, 40, 70), 33), ((37, 16), 63), ((5, 9), 33)]


def check_median_generic(dev):
    """The generic kernels (odd k > 31, forward and backward) against the
    plain versions, bit for bit, on distinct, tied and NaN-holding inputs on
    both axes, each launch counted apart from the templated kernels'; timed
    at (1025, 193), k = 33 and 63, on distinct values."""
    from ssar_tpu_torch.ops import median_cuda
    from ssar_tpu_torch.ops.median import median_filter_plain, sliding_median_bwd_plain

    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    rows, max_err = [], 0.0
    for shape, k in GENERIC:
        for kind in ("distinct", "ties", "nan"):
            x = median_case(shape, kind, g, dev)
            cot = torch.randn(shape, generator=g, device=dev)
            for axis in (-1, -2):
                a = axis % x.ndim
                before = (median_cuda.launches, median_cuda.generic_launches, median_cuda.generic_bwd_launches)
                out = median_cuda.sliding_median_cuda(x, k, a)
                gx = median_cuda.sliding_median_bwd_cuda(x, out, cot, k, a)
                after = (median_cuda.launches, median_cuda.generic_launches, median_cuda.generic_bwd_launches)
                if after != (before[0], before[1] + 1, before[2] + 1):
                    fail(f"generic median at k={k}: launch counts {before} -> {after}")
                want = median_filter_plain(x, k, axis)
                want_gx = sliding_median_bwd_plain(x, want, cot, k, axis)
                torch.cuda.synchronize()
                if not equal_with_nans(out, want) or not torch.equal(gx, want_gx):
                    fail(f"generic median differs from the plain version at {shape}, k={k}, axis={axis}, {kind}")
                if kind != "distinct":
                    continue
                max_err = max(max_err, float((out - want).abs().max()), float((gx - want_gx).abs().max()))
                if shape != (1025, 193):
                    continue
                fwd = lambda: median_cuda.sliding_median_cuda(x, k, a)  # noqa: E731
                bwd = lambda: median_cuda.sliding_median_bwd_cuda(x, out, cot, k, a)  # noqa: E731
                row = {"shape": list(shape), "k": k, "axis": axis, "ms": cuda_ms(fwd), "dev_ms": device_ms_per_call(fwd),
                       "plain_ms": cuda_ms(lambda: median_filter_plain(x, k, axis), runs=10),
                       "bwd_ms": cuda_ms(bwd), "bwd_dev_ms": device_ms_per_call(bwd),
                       "bwd_plain_ms": cuda_ms(lambda: sliding_median_bwd_plain(x, out, cot, k, axis), runs=5)}
                row["bound_ms"], row["bound_by"], _ = median_bound_ms(x.numel(), k)
                row["bwd_bound_ms"], row["bwd_bound_by"], _ = median_bwd_bound_ms(x.numel(), k)
                rows.append(row)
                log(f"[kernel] sliding_median generic {shape} k={k} axis={axis}: forward {row['ms']:.4f} ms, device "
                    f"{row['dev_ms']:.4f} (plain {row['plain_ms']:.3f}; bound {row['bound_ms']:.5f} by "
                    f"{row['bound_by']}); backward {row['bwd_ms']:.4f} ms, device {row['bwd_dev_ms']:.4f} (plain "
                    f"{row['bwd_plain_ms']:.3f}; bound {row['bwd_bound_ms']:.5f} by {row['bwd_bound_by']})")
    log(f"[kernel] sliding_median generic (k > 31) forward and backward bit-exact on {len(GENERIC)} shapes x both "
        f"axes x (distinct, tied, NaN) inputs")
    return rows, max_err


def device_kernels(fn) -> list[str]:
    """The device events (kernels, copies, fills) of one call of `fn`, by
    name, from torch.profiler; traced again if it lost them (a call launches
    at least one), up to five times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() for _ in range(e.count)
                 if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
        if names:
            return names
        time.sleep(0.1)
    fail("torch.profiler lost the device events of one call in five traces in a row")


def graph_ms(fn, calls: int = 10, replays: int = 20) -> float:
    """Device time of one call of `fn` without the profiler and without the
    host: `calls` calls captured in a CUDA graph (after warm-up calls on the
    capturing stream, so that nothing is first allocated in the capture),
    replayed back to back `replays` times between two CUDA events."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / (replays * calls)


def check_absdiff(dev):
    """B2 against its plain version at the ssabsdiff loss's shapes (batch 32,
    8 s windows: latents 18 x 512 and the 4..32 px noise maps), the
    evaluation's video shapes ((1440, 3 x 256 x 256) and (192, 3 x 1024 x
    1024)), a ragged E on the long-row route (3 x 1024 x 1024 + 3), a batched
    split plan (4, 48, 3 x 512 x 512), an odd E (2, 40, 99999), ragged and
    T = 2 shapes; rtol 1e-5 (float32 sums of positive terms in another
    order), and two launches equal bit for bit; each row's share of its
    bound.  Then float16 and bfloat16 inputs, read as they are, at the
    latents' shape (bfloat16 also at the 8 s clip's): one launch a call, one
    kernel and no cast on the profiler's trace, within one unit in the last
    place of the float32 plain version cast, two launches equal."""
    from ssar_tpu_torch.ops import absdiff_cuda
    from ssar_tpu_torch.ops.absdiff import batch_absdiff, batch_absdiff_plain

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    path = [(32, 192, 18 * 512), (32, 192, 1024), (32, 192, 256), (32, 192, 64), (32, 192, 16)]
    video = [(1, PATCH_SECONDS * FPS, EVAL_VIDEO_E), (1, 8 * FPS, CLIP_VIDEO_E)]  # the evaluation's clips
    split = [(1, 8 * FPS, CLIP_VIDEO_E + 3), (4, 48, 3 * 512 * 512), (2, 40, 99999)]
    half = [(path[0], torch.float16), (path[0], torch.bfloat16), (video[1], torch.bfloat16)]
    rows, max_err = [], 0.0
    for shape, dtype in [(s, torch.float32) for s in path + video + split + [(3, 33, 7), (4, 2, 100), (1, 2, 1)]] \
            + half:
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        before = absdiff_cuda.launches
        got, again = batch_absdiff(x), batch_absdiff(x)
        if absdiff_cuda.launches != before + 2 or got.dtype != dtype:
            fail(f"absdiff at {shape} {dtype} did not launch the kernel once a call (or returned {got.dtype})")
        if not torch.equal(got, again):
            fail(f"absdiff: two launches differ at {shape} {dtype}")
        if dtype == torch.float32:
            ok, err = within(got, batch_absdiff_plain(x), 1e-5, 0.0)
            max_err = max(max_err, err)
        else:
            # held to the float32 plain version's result cast to the dtype, within one unit in its last place
            ok, err = within(got.float(), batch_absdiff_plain(x.float()).to(dtype).float(), torch.finfo(dtype).eps,
                             0.0)
            names = device_kernels(lambda: batch_absdiff(x))
            if len(names) != 1 or "absdiff_kernel" not in names[0]:
                fail(f"absdiff at {shape} {dtype}: one call ran {names} on the card, not one absdiff kernel")
        torch.cuda.synchronize()
        if not ok:
            fail(f"absdiff at {shape} {dtype} differs from the plain version: max abs error {err:.3g}")
        plan = absdiff_cuda.plan(x)
        row = {"shape": list(shape), "dtype": str(dtype), "path": dtype == torch.float32 and shape in path,
               "video": shape in video, "plan": {k: plan[k] for k in ("vec", "tc", "chunks", "slices", "threads")},
               "ms": cuda_ms(lambda: batch_absdiff(x)),
               "plain_ms": cuda_ms(lambda: batch_absdiff_plain(x)),
               "dev_ms": device_ms_per_call(lambda: batch_absdiff(x)),
               "plain_dev_ms": device_ms_per_call(lambda: batch_absdiff_plain(x))}
        row["bound_ms"], row["bound_by"] = absdiff_bound_ms(*shape, itemsize=x.element_size())
        rows.append(row)
        log(f"[kernel] absdiff {shape} {dtype}: {row['ms']:.4f} ms, device {row['dev_ms']:.4f} ms = "
            f"{100 * row['bound_ms'] / row['dev_ms']:.1f} % of the bound {row['bound_ms']:.5f} ms by "
            f"{row['bound_by']} (plain in {dtype} {row['plain_ms']:.4f}, device {row['plain_dev_ms']:.4f}); "
            f"plan {row['plan']}; max abs error {err:.3g}")
        del x, got, again
    return rows, max_err


def vandermonde_f64(args, L: int, g: torch.Tensor):
    """K and its four gradients (da, db, dcre, dcim) for the cotangent g in
    float64, from the same fp32-rounded products fl(a l) and fl(b l) that the
    kernels and the plain version take: what both are held to for the SFU's
    accuracy cost."""
    a, b, cre, cim = args
    l = torch.arange(L, dtype=torch.float32, device=a.device)
    E = (a[:, :, None] * l).double().exp()
    x = (b[:, :, None] * l).double()
    c, s = x.cos(), x.sin()
    cr, ci = cre.double()[:, :, None], cim.double()[:, :, None]
    K = 2 * (E * (cr * c - ci * s)).sum(1)
    gE = g.double()[:, None, :] * E
    gl = gE * l.double()
    return K, (2 * (gl * (cr * c - ci * s)).sum(2), -2 * (gl * (cr * s + ci * c)).sum(2), 2 * (gE * c).sum(2),
               -2 * (gE * s).sum(2))


def check_vandermonde(dev):
    """B3 forward and backward against the plain version and its autograd,
    on the inputs of freshly initialised S4D layers (N = 32 is state_dim 64):
    (104, 32, 192) the train path (hidden 32, fixed decoder), (56, 32, 192)
    and (32, 32, 192) hidden 16 and 8 (and the Sashimi U-Net's full-rate
    tier), (64, 32, 48) and (128, 32, 12) its pooled tier and centre,
    (104, 32, 4320) a 3-minute track,
    (104, 64, 4320) an S4DLayer(104, 128) on it (|b l| up to ~8.5e4, the
    angle reduction at its widest), (13, 7, 1000) ragged.  rtol 1e-4 with an
    atol of 1e-5 of the largest magnitude (exp / sin / cos of the same fp32
    products, summed in another order); two launches bit-identical.  Both the
    kernels' and the plain version's largest error against a float64
    evaluation of the same fp32 products, relative to the largest magnitude,
    is logged."""
    from ssar_tpu_torch.models.s4 import S4DLayer
    from ssar_tpu_torch.ops import vandermonde_cuda
    from ssar_tpu_torch.ops.vandermonde import s4d_vandermonde, s4d_vandermonde_plain, zoh_factors

    def rel(got, want):
        return float((got.double() - want).abs().max() / want.abs().max())

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    rows, fwd_err, bwd_err = [], 0.0, 0.0
    for H, N, L in ((104, 32, 192), (56, 32, 192), (32, 32, 192), (64, 32, 48), (128, 32, 12), (104, 32, 4320),
                    (104, 64, 4320), (13, 7, 1000)):
        torch.manual_seed(SEED + H + N)
        layer = S4DLayer(H, 2 * N).to(dev)
        with torch.no_grad():
            args = [t.contiguous() for t in zoh_factors(layer.log_dt, layer._A_re(), layer.A_im, layer.C_re,
                                                        layer.C_im)]
        g = torch.randn(H, L, generator=gen, device=dev)
        leaves = [a.clone().requires_grad_() for a in args]
        K = s4d_vandermonde(*leaves, L)
        grads = torch.autograd.grad(K, leaves, g)
        K_plain = s4d_vandermonde_plain(*leaves, L)
        grads_plain = torch.autograd.grad(K_plain, leaves, g, retain_graph=True)
        again, grads_again = vandermonde_cuda.s4d_vandermonde_cuda(*args, L), \
            vandermonde_cuda.s4d_vandermonde_bwd_cuda(*args, g)
        torch.cuda.synchronize()
        K, K_ref = K.detach(), K_plain.detach()
        ok, err = within(K, K_ref, 1e-4, 1e-5 * float(K_ref.abs().max()))
        if not ok:
            fail(f"s4d_vandermonde differs from the plain version at {(H, N, L)}: max abs error {err:.3g}")
        fwd_err = max(fwd_err, err)
        for name, a, b in zip(("a", "b", "cre", "cim"), grads, grads_plain):
            ok, err = within(a, b, 1e-4, 1e-5 * float(b.abs().max()))
            if not ok:
                fail(f"s4d_vandermonde_bwd d{name} differs from autograd of the plain version at {(H, N, L)}: "
                     f"max abs error {err:.3g} (largest |grad| {float(b.abs().max()):.3g})")
            bwd_err = max(bwd_err, err)
        if not torch.equal(again, K) or not all(torch.equal(x, y) for x, y in zip(grads_again, grads)):
            fail(f"s4d_vandermonde: two launches differ at {(H, N, L)}")
        K64, grads64 = vandermonde_f64(args, L, g)
        f64 = {"fwd": rel(K, K64), "plain_fwd": rel(K_ref, K64),
               "bwd": max(rel(x, y) for x, y in zip(grads, grads64)),
               "plain_bwd": max(rel(x, y) for x, y in zip(grads_plain, grads64))}
        del K64, grads64

        fns = {"": lambda: vandermonde_cuda.s4d_vandermonde_cuda(*args, L),
               "plain_": lambda: s4d_vandermonde_plain(*args, L),
               "bwd_": lambda: vandermonde_cuda.s4d_vandermonde_bwd_cuda(*args, g),
               "bwd_plain_": lambda: torch.autograd.grad(K_plain, leaves, g, retain_graph=True)}
        row = {"shape": [H, N, L]}
        for key, fn in fns.items():
            row[key + "ms"], row[key + "dev_ms"] = cuda_ms(fn), device_ms_per_call(fn)
        row["bound_ms"], row["bound_by"] = vandermonde_bound_ms(H, N, L, backward=False)
        row["bwd_bound_ms"], row["bwd_bound_by"] = vandermonde_bound_ms(H, N, L, backward=True)
        rows.append(row)
        log(f"[kernel] s4d_vandermonde {(H, N, L)}: forward {row['ms']:.4f} ms, device {row['dev_ms']:.4f} "
            f"(plain {row['plain_ms']:.4f}, device {row['plain_dev_ms']:.4f}; bound {row['bound_ms']:.5f} by "
            f"{row['bound_by']}); backward {row['bwd_ms']:.4f} ms, device {row['bwd_dev_ms']:.4f} (plain autograd "
            f"{row['bwd_plain_ms']:.4f}, device {row['bwd_plain_dev_ms']:.4f}; bound {row['bwd_bound_ms']:.5f} by "
            f"{row['bwd_bound_by']}); largest error against float64 of the same fp32 products, over the largest "
            f"magnitude: forward kernel {f64['fwd']:.3g}, plain {f64['plain_fwd']:.3g}; backward kernel "
            f"{f64['bwd']:.3g}, plain {f64['plain_bwd']:.3g}")
    log(f"[kernel] s4d_vandermonde within tolerance on {len(rows)} shapes, two launches bit-identical; max abs "
        f"error forward {fwd_err:.3g}, backward {bwd_err:.3g}")
    return rows, fwd_err, bwd_err


def _metric_rows(log_dir: Path, tag: str) -> list[float]:
    """The values of one tag in a run's metrics.csv."""
    out = []
    for line in (log_dir / "metrics.csv").read_text().splitlines():
        _, name, value = line.split(",")
        if name == tag:
            out.append(float(value))
    return out


def _ckpt_params(path: Path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)["params"]


def run_trainer(flags: list[str], steps: int, tag: str) -> tuple[Path, float]:
    """``train.main`` for `steps` steps; fails unless every
    step's loss and the val loss are finite and every trainable parameter
    moved away from its initialisation."""
    from ssar_tpu_torch.train import train as trainer

    batch = trainer.build_parser().parse_args(flags).batch_size
    argv = flags + ["--n_examples", str(steps * batch), "--out_dir", str(ROOT / "build" / "chip_smoke_runs")]
    t0 = time.perf_counter()
    log_dir, val_loss = trainer.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    args = trainer.build_parser().parse_args(argv)
    losses = _metric_rows(log_dir, f"Loss/{args.loss}")
    if len(losses) != steps or not all(math.isfinite(v) for v in losses) or not math.isfinite(val_loss):
        fail(f"{tag}: {len(losses)} step losses (expected {steps}), finite={all(map(math.isfinite, losses))}, "
             f"val {val_loss}")
    torch.manual_seed(args.seed)  # main's initialisation, rebuilt on the CPU
    init = trainer.make_model(args, np.zeros(59, np.float32), np.ones(59, np.float32),
                              np.zeros((args.n_latent_split * args.hidden_size, 18, 512), np.float32))
    final = _ckpt_params(trainer._latest_checkpoint(log_dir))
    # an LSTM's torch input bias stands for no flax parameter and is held at zero (models/backbones.py)
    unchanged = [k for k, p in init.named_parameters()
                 if torch.equal(p.detach(), final[k]) and not k.endswith("lstm.bias_ih_l0")]
    if unchanged:
        fail(f"{tag}: parameters unchanged after {steps} steps: {unchanged}")
    log(f"[train] {tag}: {steps} steps in {seconds:.2f} s (main, evals and renders included); loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f}; val {val_loss:.5f}; {log_dir.relative_to(ROOT)}")
    return log_dir, val_loss


def timed_steps(dev, flags: list[str], data, ds, palette, steps: int = 20, warm: int = 3) -> dict:
    """A warm loop of ``train_step_gather`` as ``main`` drives it (one int32
    index vector uploaded per step): steps/s, examples/s, peak memory."""
    from ssar_tpu_torch.train import train as trainer
    from ssar_tpu_torch.train.data import compute_stats

    args = trainer.build_parser().parse_args(flags)
    mean, std = compute_stats(ds.features)
    torch.manual_seed(args.seed)
    model = trainer.make_model(args, mean, std, palette).to(dev)
    opt = trainer.ClippedAdam([p for p in model.parameters() if p.requires_grad], args.lr, args.grad_clip)
    _, step_gather, _ = trainer.make_train_step(model, opt, args.loss, dev)
    gens = (torch.Generator(dev).manual_seed(1), torch.Generator(dev).manual_seed(2))
    idx = ds.index_batches(args.batch_size, seed=args.seed)
    for _ in range(warm):
        step_gather(data, torch.as_tensor(next(idx), dtype=torch.int32).to(dev), gens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step_gather(data, torch.as_tensor(next(idx), dtype=torch.int32).to(dev), gens) for _ in range(steps)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not bool(torch.isfinite(torch.stack(losses)).all()):
        fail(f"timed {args.loss}/{args.decoder}: non-finite loss")
    peak = torch.cuda.max_memory_allocated() / 2**30
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            step_gather(data, torch.as_tensor(next(idx), dtype=torch.int32).to(dev), gens)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.is_user_annotation), key=lambda e: -e.self_device_time_total)
    top = [(e.key[:60], round(e.self_device_time_total / 5e3, 4)) for e in kernels[:5]]
    return {"steps_per_s": steps / seconds, "examples_per_s": steps * args.batch_size / seconds,
            "ms_per_step": seconds / steps * 1e3, "peak_gib": peak, "device_ms_per_step": device_ms(prof) / 5,
            "launches_per_step": sum(e.count for e in kernels) / 5, "top": top}


def train_path(dev, feats: torch.Tensor) -> tuple[dict, Path]:
    """Phase 6; returns the absdiff / Vandermonde launch counts of the
    full-width ssabsdiff run, and its run directory."""
    from ssar_tpu_torch.generate.audio2video import react
    from ssar_tpu_torch.ops import absdiff_cuda, vandermonde_cuda
    from ssar_tpu_torch.train import train as trainer
    from ssar_tpu_torch.train.data import synthetic_dataset

    # the cell's run: evals at the first and the last step, a checkpoint and a
    # 256 px render after the first step and at the end
    args = trainer.build_parser().parse_args(TRAIN_FLAGS)
    B = args.batch_size
    schedule = ["--eval_every", str((TRAIN_STEPS - 1) * B), "--ckpt_every", str(TRAIN_STEPS * B)]
    absdiff_cuda.launches = vandermonde_cuda.launches = vandermonde_cuda.bwd_launches = 0
    log_dir, _ = run_trainer(TRAIN_FLAGS + schedule, TRAIN_STEPS, "sashimi/fixed/ssabsdiff")
    counts = {"absdiff": absdiff_cuda.launches, "s4d_vandermonde": vandermonde_cuda.launches,
              "s4d_vandermonde_bwd": vandermonde_cuda.bwd_launches}
    evals = len(_metric_rows(log_dir, "Loss/val")) * math.ceil(16 / B)  # batches: 16 val windows each
    fcd = _metric_rows(log_dir, "Eval/FCD")   # --fcd is on by default, as in the JAX trainer
    if len(fcd) != len(_metric_rows(log_dir, "Loss/val")) or not all(map(math.isfinite, fcd)):
        fail(f"train path: Eval/FCD {fcd} at {len(_metric_rows(log_dir, 'Loss/val'))} evals")
    log(f"[train] Eval/FCD {fcd}")
    renders = sorted(log_dir.glob("sample_*.y4m")) + sorted(log_dir.glob("sample_*.mp4"))
    # per step one forward and one backward Vandermonde per S4D layer and 5 absdiff (one per
    # prediction); each eval batch the same forward; each eval's diagnostics and each render's reactor one
    # forward per layer
    n = args.num_layers
    want = {"absdiff": 5 * (TRAIN_STEPS + evals),
            "s4d_vandermonde": n * (TRAIN_STEPS + evals + len(_metric_rows(log_dir, "Loss/val")) + len(renders)),
            "s4d_vandermonde_bwd": n * TRAIN_STEPS}
    log(f"[train] launches in the ssabsdiff run: {counts} (expected {want}: {TRAIN_STEPS} steps, {evals} evals, "
        f"{len(renders)} renders)")
    if counts != want or min(counts.values()) == 0:
        fail(f"kernel launches on the train path {counts}, expected {want}")
    if len(renders) != 2:
        fail(f"expected 2 checkpoint renders, found {[p.name for p in renders]}")
    px, frames = args.render_size, min(args.duration, 4) * args.fps  # the render's synthetic clip
    y4m_bytes = len(f"YUV4MPEG2 W{px} H{px} F{args.fps}:1 Ip A1:1 C420jpeg\n") + frames * (6 + px * px * 3 // 2)
    for path in renders:  # .mp4 through cv2 where it is importable, else .y4m
        size = path.stat().st_size
        if (path.suffix == ".y4m" and size != y4m_bytes) or size == 0:
            fail(f"render {path.name}: {size} bytes, expected {frames} frames at {px} px")
    log(f"[train] renders: {[f'{p.name} {p.stat().st_size} B' for p in renders]}")

    for flags, tag in ((["--loss", "selfsupervised"], "sashimi/fixed/selfsupervised"),
                       (["--loss", "supervised"], "sashimi/fixed/supervised"),
                       (["--loss", "supervised", "--decoder", "learned"], "sashimi/learned/supervised")):
        run_trainer(TRAIN_FLAGS + flags + ["--eval_every", "1000000", "--ckpt_every", "1000000",
                                           "--no-render_at_ckpt"], 4, tag)

    # warm timed loops on the device-resident data main uses (64 windows, 8 s)
    ds = synthetic_dataset(n_windows=64, n_frames=args.duration * args.fps)
    data = ds.to_device(dev)
    palette = np.random.RandomState(SEED).randn(args.n_latent_split * args.hidden_size, 18, 512).astype(np.float32)
    log(f"[train] device-resident data {sum(a.nbytes for a in ds.arrays) / 1e9:.3f} GB")
    for flags, tag in (([], "ssabsdiff/fixed"), (["--loss", "selfsupervised"], "selfsupervised/fixed"),
                       (["--loss", "supervised"], "supervised/fixed"),
                       (["--loss", "supervised", "--decoder", "learned"], "supervised/learned")):
        r = timed_steps(dev, TRAIN_FLAGS + flags, data, ds, palette)
        log(f"[train] timed train_step_gather {tag}: {r['steps_per_s']:.2f} steps/s = {r['examples_per_s']:.1f} "
            f"examples/s ({r['ms_per_step']:.3f} ms/step, batch {B} x {args.duration * args.fps} frames); peak memory "
            f"{r['peak_gib']:.3f} GiB; device busy {r['device_ms_per_step']:.3f} ms/step in "
            f"{r['launches_per_step']:.0f} kernels (idle share >= {max(0.0, 1 - r['device_ms_per_step'] / r['ms_per_step']):.3f}); "
            f"top device ms/step {r['top']}")
    del data

    # the trained sashimi reactor on the serve path (phase 4's features)
    model = trainer.make_model(args, np.zeros(59, np.float32), np.ones(59, np.float32),
                               np.zeros((args.n_latent_split * args.hidden_size, 18, 512), np.float32))
    model.load_state_dict(_ckpt_params(trainer._latest_checkpoint(log_dir)))
    model = model.to(dev).eval()
    vandermonde_cuda.launches = 0
    latents, noise = react(model, feats, torch.Generator(dev).manual_seed(SEED + 4))
    torch.cuda.synchronize()
    T = feats.shape[0]
    if tuple(latents.shape) != (T, 18, 512) or [tuple(n.shape) for n in noise] != [(T, 1, s, s) for s in
                                                                                   (4, 8, 16, 32)]:
        fail(f"trained sashimi reactor: latents {tuple(latents.shape)}, noise {[tuple(n.shape) for n in noise]}")
    if not (bool(torch.isfinite(latents).all()) and all(bool(torch.isfinite(n).all()) for n in noise)):
        fail("trained sashimi reactor: non-finite output on the serve path's features")
    if vandermonde_cuda.launches != args.num_layers:
        fail(f"trained sashimi reactor launched the Vandermonde kernel {vandermonde_cuda.launches} times, "
             f"expected {args.num_layers}")
    log(f"[train] trained sashimi reactor on the serve features: latents {tuple(latents.shape)}, "
        f"{vandermonde_cuda.launches} Vandermonde launches")
    return counts, log_dir


class _CaptureGrads:
    """An optimizer that keeps the gradients and leaves the parameters."""

    def __init__(self, params):
        self.params, self.grads = list(params), None

    def step(self, grads):
        self.grads = [g.detach().cpu() for g in grads]


@contextlib.contextmanager
def _injected_base_noise(base: dict):
    """The reactor's smoothed base noise replaced by fixed maps (by size)."""
    from ssar_tpu_torch.models import reactor

    saved = reactor.smoothed_noise
    reactor.smoothed_noise = lambda shape_bt, size, sigma=5.0, *, generator=None, device=None: \
        torch.as_tensor(base[size], device=device)
    try:
        yield
    finally:
        reactor.smoothed_noise = saved


def reference_step(dev):
    """Phase 7: one ssabsdiff train step (hidden 4, 1 layer, T = 96, B = 2,
    dropout 0, injected base noise) on the card, in full fp32, and on the CPU
    from the same weights: loss within rtol 1e-4, each gradient within 1e-3
    of its leaf's largest magnitude."""
    from ssar_tpu_torch.train import train as trainer
    from ssar_tpu_torch.train.data import compute_stats, synthetic_dataset
    from ssar_tpu_torch.utils.device import full_precision

    args = trainer.build_parser().parse_args(["--backbone", "sashimi", "--decoder", "fixed", "--loss", "ssabsdiff",
                                              "--hidden_size", "4", "--num_layers", "1", "--dropout", "0"])
    ds = synthetic_dataset(n_windows=2, n_frames=96, seed=3)
    mean, std = compute_stats(ds.features)
    torch.manual_seed(SEED)
    cpu_model = trainer.make_model(args, mean, std, np.random.RandomState(SEED).randn(12, 18, 512).astype(np.float32))
    with torch.no_grad():  # keep each split's envelope sum away from the env / env.sum pole
        cpu_model.envelopes.out.bias[:12] += 1.0
    card_model = copy.deepcopy(cpu_model).to(dev)
    rs = np.random.RandomState(SEED + 5)
    base = {s: rs.randn(2, 96, s, s).astype(np.float32) for s in (4, 8, 16, 32)}

    def step(model, device):
        capture = _CaptureGrads(p for p in model.parameters() if p.requires_grad)
        train_step = trainer.make_train_step(model, capture, "ssabsdiff", device)[0]
        batch = tuple(torch.as_tensor(np.asarray(a, np.float32)).to(device) for a in ds.arrays)
        with _injected_base_noise(base):
            loss = float(train_step(batch, (None, None)))
        return loss, capture.grads

    with full_precision():
        card_loss, card_grads = step(card_model, dev)
    cpu_loss, cpu_grads = step(cpu_model, torch.device("cpu"))
    if not (math.isfinite(card_loss) and abs(card_loss - cpu_loss) <= 1e-4 * abs(cpu_loss)):
        fail(f"reference step: loss on the card {card_loss!r}, on the CPU {cpu_loss!r}")
    worst = 0.0
    for (name, _), gc, gp in zip(((n, p) for n, p in cpu_model.named_parameters() if p.requires_grad),
                                 card_grads, cpu_grads):
        scale = float(gp.abs().max())
        err = float((gc - gp).abs().max())
        if not err <= 1e-3 * scale:
            fail(f"reference step: gradient of {name} on the card differs by {err:.3g} (largest {scale:.3g})")
        worst = max(worst, err / scale if scale else 0.0)
    log(f"[reference] ssabsdiff step card vs CPU: loss {card_loss:.7f} vs {cpu_loss:.7f}; worst gradient error "
        f"{worst:.3g} of its leaf's largest magnitude ({len(cpu_grads)} leaves)")


# the comparison study's optimizer settings (the reference's metrics/comparison.py)
COMPARISON = dict(objective="procrustes", norm_grads=False, n_latent_split=3, n_latent_groups=3, n_latent_per_group=3,
                  n_noise=5, n_params=128, log_steps=16, use_audio_segmentation_features=True,
                  feature_weight_boosts={"onsets": 3.0, "rms": 10.0, "rosa_segmentation": 2.0, "drop_strength": 10.0})
# the standalone optimizer's defaults with the segmentation loss switched on
STANDALONE = dict(objective="rv2", n_params=512, n_latent_split=1, n_latent_groups=1, n_latent_per_group=6,
                  n_noise=6, lambda_lap=1.0, prediction_similarity_penalty=0.1)


def profiled_steps(problem, steps: int) -> dict:
    """torch.profiler over `steps` optimizer steps of a prepared problem:
    wall ms, device-busy ms and kernels a step."""
    from torch.profiler import ProfilerActivity, profile

    from ssar_tpu_torch.train.train import ClippedAdam
    from ssar_tpu_torch.utils.device import full_precision

    opt = ClippedAdam([problem.hippo.c], 1e-3)

    def step():
        loss = problem.loss_fn()
        opt.step(torch.autograd.grad(loss, [problem.hippo.c]))

    with full_precision():
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    kernels = sorted((e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.is_user_annotation), key=lambda e: -e.self_device_time_total)
    return {"profiled_ms_per_step": wall, "device_ms_per_step": device_ms(prof) / steps,
            "kernels_per_step": sum(e.count for e in kernels) / steps,
            "top": [(e.key[:60], round(e.self_device_time_total / steps / 1e3, 4)) for e in kernels[:5]]}


def timed_optimize(**kwargs):
    """``optimize(**kwargs)`` with its ``prepare`` call timed and its problem
    kept: returns (optimize's result, the Problem, seconds of "features",
    "hippo", "prepare" (all of the set-up) and "steps" (the rest of the call))."""
    from ssar_tpu_torch.generate import optimize as opt

    kept, prepare = {}, opt.prepare

    def timed_prepare(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kept["problem"] = prepare(*a, **k)
        torch.cuda.synchronize()
        kept["prepare"] = time.perf_counter() - t0
        return kept["problem"]

    opt.prepare = timed_prepare
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(None):
            result = opt.optimize(out_dir=str(ROOT / "build" / "chip_smoke_runs"), seed=SEED, **kwargs)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        opt.prepare = prepare
    problem = kept["problem"]
    return result, problem, dict(problem.seconds, prepare=kept["prepare"], steps=total - kept["prepare"])


def optimize_comparison(dev, track: np.ndarray, config):
    """Phase 8: the comparison configuration, 512 steps at full width, then
    an eval render of 192 frames at 1024 px."""
    from ssar_tpu_torch.generate import optimize as opt

    n_steps = 512
    torch.cuda.reset_peak_memory_stats()
    (envs, latents, noise, losses), problem, secs = timed_optimize(audio=track, sr=44100, fps=FPS, n_steps=n_steps,
                                                                   **COMPARISON)
    peak = torch.cuda.max_memory_allocated() / 2**30
    T = 40 * FPS
    shapes = (tuple(envs.shape), tuple(latents.shape), [tuple(n.shape) for n in noise])
    if shapes != ((T, 37), (T, 18, 512), [(T, s, s) for s in (4, 8, 16, 32, 64)]):
        fail(f"optimize (comparison): shapes {shapes}")
    if not all(bool(torch.isfinite(t).all()) for t in (envs, latents, *noise)):
        fail("optimize (comparison): non-finite output")
    if len(losses) != n_steps // 16 or not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"optimize (comparison): losses {losses[:2]} ... {losses[-2:]} ({len(losses)} values)")
    log(f"[optimize] comparison: 40 s @ 44.1 kHz -> envelopes {shapes[0]}, latents {shapes[1]}, {len(noise)} noise maps; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} in {n_steps} steps; features {secs['features']:.3f} s, HiPPO init "
        f"(N = 128) {secs['hippo']:.3f} s, set-up {secs['prepare']:.3f} s, steps {secs['steps']:.3f} s = "
        f"{secs['steps'] / n_steps * 1e3:.3f} ms/step; peak memory {peak:.3f} GiB")

    r = profiled_steps(problem, 5)
    log(f"[optimize] comparison, profiled: device busy {r['device_ms_per_step']:.3f} ms/step in "
        f"{r['kernels_per_step']:.0f} kernels, {r['device_ms_per_step'] / (secs['steps'] / n_steps * 1e3):.3f} of the "
        f"unprofiled step ({r['profiled_ms_per_step']:.3f} ms/step under the profiler); top device ms/step {r['top']}")

    sink = FrameSink((1536, 1024))
    t0 = time.perf_counter()
    opt._render_eval(None, latents[:192], [n[:192] for n in noise], None, None, FPS, config, device=dev, writer=sink)
    torch.cuda.synchronize()
    if len(sink.crcs) != 192 or len(set(sink.crcs)) < 96 or not (16 <= sink.y_range[0] <= sink.y_range[1] <= 235):
        fail(f"optimize eval render: {len(sink.crcs)} frames, {len(set(sink.crcs))} distinct, luma {sink.y_range}")
    log(f"[optimize] eval render: 192 frames 1024x1024 in {time.perf_counter() - t0:.3f} s (synthesizer built "
        f"inside), {len(set(sink.crcs))} distinct frames")


def optimize_standalone(dev, track: np.ndarray, n_sync: int) -> dict:
    """Phase 9: the standalone configuration with the segmentation loss, 8
    steps; returns the sliding median's launch counts of this run."""
    from ssar_tpu_torch.generate import optimize as opt
    from ssar_tpu_torch.ops import median_cuda

    n_steps, n_pred, n_feat = 8, 2 + STANDALONE["n_noise"], len(opt.AFNS)
    median_cuda.launches = median_cuda.bwd_launches = 0
    torch.cuda.reset_peak_memory_stats()
    (envs, latents, noise, losses), problem, secs = timed_optimize(audio=track, sr=44100, fps=FPS, n_steps=n_steps,
                                                                   log_steps=1, **STANDALONE)
    counts = {"sliding_median": median_cuda.launches, "sliding_median_bwd": median_cuda.bwd_launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    # set-up: three of the features separate harmonic from percussive (chromagram, tonnetz through its own
    # chromagram, onsets): one HPSS, two filters each; every feature's segmentation runs two filters, forward
    # only.  Each step: two filters per prediction, forward and backward.
    want = {"sliding_median": 3 * 2 + 2 * n_feat + 2 * n_pred * n_steps, "sliding_median_bwd": 2 * n_pred * n_steps}
    log(f"[optimize] standalone + segmentation loss: launches {counts} (expected {want}: {n_feat} features, "
        f"{n_pred} predictions, {n_steps} steps)")
    if counts != want:
        fail(f"sliding-median launches on the optimize path {counts}, expected {want}")
    T = 40 * FPS
    if tuple(envs.shape) != (T, 18) or tuple(latents.shape) != (T, 18, 512) or len(noise) != 6:
        fail(f"optimize (standalone): shapes {tuple(envs.shape)}, {tuple(latents.shape)}, {len(noise)} noise maps")
    if len(losses) != n_steps or not all(math.isfinite(v) for v in losses) or not all(
            bool(torch.isfinite(t).all()) for t in (envs, latents, *noise)):
        fail(f"optimize (standalone): losses {losses}")
    log(f"[optimize] standalone: loss {losses[0]:.4f} -> {losses[-1]:.4f} in {n_steps} steps; features "
        f"{secs['features']:.3f} s, HiPPO init (N = 512, T_pad {T + 256}) {secs['hippo']:.3f} s, set-up "
        f"{secs['prepare']:.3f} s, steps {secs['steps']:.3f} s = {secs['steps'] / n_steps * 1e3:.1f} ms/step; "
        f"peak memory {peak:.3f} GiB")

    if len(problem.beats) + 1 != n_sync:
        fail(f"optimize (standalone): {len(problem.beats) + 1} beat-synchronous frames, kernel check used {n_sync}")
    loss = problem.loss_fn()
    (grad,) = torch.autograd.grad(loss, [problem.hippo.c])
    loss = loss.detach()
    if not (math.isfinite(float(loss)) and bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0):
        fail(f"optimize (standalone): loss {float(loss)}, gradient finite={bool(torch.isfinite(grad).all())}")
    r = profiled_steps(problem, 1)
    log(f"[optimize] standalone, profiled: device busy {r['device_ms_per_step']:.3f} ms/step in "
        f"{r['kernels_per_step']:.0f} kernels, {r['device_ms_per_step'] / (secs['steps'] / n_steps * 1e3):.3f} of the "
        f"unprofiled step, the rest is the host ({r['profiled_ms_per_step']:.1f} ms/step under the profiler); top "
        f"device ms/step {r['top']}")
    return counts


@contextlib.contextmanager
def _injected_draws(init_f: np.ndarray, draws: dict):
    """The optimizer's initial envelopes and noise draws replaced by fixed arrays."""
    from ssar_tpu_torch.generate import optimize as opt

    saved = opt.initial_envelopes, opt.noise_base_draw
    opt.initial_envelopes = lambda n, e, generator, device: torch.as_tensor(init_f, device=device)
    opt.noise_base_draw = lambda T, size, generator, device: torch.as_tensor(draws[size], device=device)
    try:
        yield
    finally:
        opt.initial_envelopes, opt.noise_base_draw = saved


def reference_optimize(dev):
    """Phase 10: loss and gradient of the HiPPO coefficients for both
    configurations at a small size (6 s at 12 fps, N = 64, a 32 px mapper's
    palette given as an array) on the card and on the CPU, from the same
    initial envelopes, noise draws and palette.  Loss within rtol 1e-3; the
    gradient within 2e-2 of its largest magnitude: features, cuSOLVER's
    against LAPACK's eigenvectors and 100 k-means iterations differ in
    float32 round-off, which eigh's backward magnifies by 1 / (gap between
    eigenvalues)."""
    from ssar_tpu_torch.generate import optimize as opt
    from ssar_tpu_torch.utils.device import full_precision

    fps, sr = 12, 1024 * 12
    track = synthetic_track(sr, 6.0, section_seconds=1.5)
    rs = np.random.RandomState(SEED + 7)
    small = {"comparison": dict(COMPARISON, n_params=64, n_noise=2, ks=(2, 4)),
             "standalone": dict(STANDALONE, n_params=64, n_noise=2, n_latent_per_group=3, ks=(2, 4))}
    for tag, cfg in small.items():
        cfg.pop("log_steps", None)
        n_pal = cfg["n_latent_split"] * cfg["n_latent_groups"] * cfg["n_latent_per_group"]
        n_env = n_pal + 2 * cfg["n_noise"]
        palette = rs.randn(n_pal, 9, 512).astype(np.float32)
        init_f = rs.rand(6 * fps, n_env).astype(np.float32)
        draws = {2 ** (i + 2): rs.randn(6 * fps, 2 ** (i + 2), 2 ** (i + 2)).astype(np.float32)
                 for i in range(cfg["n_noise"])}
        out = {}
        for device in (dev, torch.device("cpu")):
            with _injected_draws(init_f, draws):
                problem = opt.prepare(track, sr, fps=fps, palette=palette, device=device, **cfg)
            with full_precision():
                loss = problem.loss_fn()
                (grad,) = torch.autograd.grad(loss, [problem.hippo.c])
            out[device.type] = (float(loss.detach()), grad.cpu(), problem)
        (l_card, g_card, p_card), (l_cpu, g_cpu, p_cpu) = out["cuda"], out["cpu"]
        if p_card.beats != p_cpu.beats:
            fail(f"reference optimize ({tag}): beats on the card {p_card.beats} != CPU {p_cpu.beats}")
        if "rosa_segmentation" in p_cpu.features and not torch.equal(
                p_card.features["rosa_segmentation"].cpu(), p_cpu.features["rosa_segmentation"]):
            fail(f"reference optimize ({tag}): hard segmentation labels differ between the card and the CPU")
        scale = float(g_cpu.abs().max())
        err = float((g_card - g_cpu).abs().max())
        if not (math.isfinite(l_card) and abs(l_card - l_cpu) <= 1e-3 * abs(l_cpu)):
            fail(f"reference optimize ({tag}): loss on the card {l_card!r}, on the CPU {l_cpu!r}")
        if not (scale > 0 and err <= 2e-2 * scale):
            fail(f"reference optimize ({tag}): gradient of c on the card differs by {err:.3g} (largest {scale:.3g})")
        log(f"[reference] optimize {tag} card vs CPU: loss {l_card:.6f} vs {l_cpu:.6f}; gradient error "
            f"{err / scale:.3g} of its largest magnitude")


def patch_path(dev) -> dict:
    """Phase 11: the random-patch CLI's ``generate`` at its defaults on a
    60 s track read from a wav, after an untimed warm-up; then at 1024 px on
    its first 20 s.  Returns the sliding-median launch count of the timed
    60 s call."""
    from scipy.io import wavfile

    from ssar_tpu_torch.gan.stylegan2 import StyleGAN2Config
    from ssar_tpu_torch.gan.wrapper import StyleGAN2
    from ssar_tpu_torch.generate import keys, sample
    from ssar_tpu_torch.generate.mir import retrieve_music_information
    from ssar_tpu_torch.generate.patch import Patch
    from ssar_tpu_torch.ops import median_cuda

    out_dir = ROOT / "build" / "chip_smoke_runs" / "patch"
    out_dir.mkdir(parents=True, exist_ok=True)
    wav = out_dir / "patch_track.wav"
    track = synthetic_track(44100, PATCH_SECONDS, section_seconds=8)
    wavfile.write(wav, 44100, np.round(track / np.abs(track).max() * 32000).astype(np.int16))
    config, seed, batch = StyleGAN2Config(), 42, 16

    # warm-up: the track's music information (cuFFT plans and filter banks at its shapes) with the launch count,
    # the noise trees of every chunk alone, and one rendered chunk at 256 px
    audio, sr = sample.load_audio(str(wav), 0, None, FPS, device=dev)
    median_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    features, segmentations, tempo = retrieve_music_information(audio, sr, device=dev)
    torch.cuda.synchronize()
    warm_mir_s, warm_b1 = time.perf_counter() - t0, median_cuda.launches
    if warm_b1 != PATCH_B1:
        fail(f"retrieve_music_information launched the sliding median {warm_b1} times, expected {PATCH_B1}")
    T = features["rms"].shape[0]
    if T != PATCH_SECONDS * FPS or len(segmentations) != 9 * 6:
        fail(f"music information: T = {T}, {len(segmentations)} segmentations")
    G = StyleGAN2(output_size=(256, 256), config=config, seed=seed, device=dev)
    palette = G.mapper(keys.normal(keys.PRNGKey(seed), (180, 512), device=dev))
    with torch.no_grad():
        latents, noise = Patch(features, segmentations, tempo, fps=FPS, seed=seed).forward(palette, downscale_factor=4)
        noise = noise[4 : 4 + G.synthesizer.n_noises_used]
        starts = sample.chunk_starts(T, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in starts:
            windows = [nm(s, batch) for nm in noise]
        torch.cuda.synchronize()
        trees_s = time.perf_counter() - t0
        G.synthesizer(latents[:batch], noises=[w[..., None] for w in windows])
        torch.cuda.synchronize()
    del G, palette, latents, noise, windows, features, segmentations
    log(f"[patch] warm-up: music information of {PATCH_SECONDS} s in {warm_mir_s:.3f} s ({warm_b1} sliding-median "
        f"launches, tempo {tempo:.1f} BPM); noise trees alone for {len(starts)} chunks of {batch} at 256 px: "
        f"{trees_s:.3f} s ({trees_s / len(starts) * 1e3:.3f} ms a chunk)")

    counts = {}
    for downscale, duration, n_frames, shape in ((4, None, PATCH_SECONDS * FPS, (384, 256)),
                                                 (1, 20.0, 20 * FPS, (1536, 1024))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        median_cuda.launches = 0
        stats, sink = {}, FrameSink(shape)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(None):
            out = sample.generate(audio_file=str(wav), seed=seed, fps=FPS, audio_duration=duration,
                                  downscale_factor=downscale, batch_size=batch, config=config,
                                  out_dir=str(out_dir), writer=sink, device=dev, stats=stats)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        b1, side = median_cuda.launches, shape[1]
        if b1 != PATCH_B1:
            fail(f"random-patch path at {side} px launched the sliding median {b1} times, expected {PATCH_B1}")
        if len(sink.crcs) != n_frames or stats["frames"] != n_frames:
            fail(f"random-patch path at {side} px: {len(sink.crcs)} frames written, expected {n_frames}")
        if len(set(sink.crcs)) < n_frames // 2 or not (16 <= sink.y_range[0] <= sink.y_range[1] <= 235):
            fail(f"random-patch frames at {side} px: {len(set(sink.crcs))} distinct, luma {sink.y_range}")
        json_file = Path(out.replace(".mp4", ".json"))
        if not json_file.exists() or json.loads(json_file.read_text())["seed"] != seed:
            fail(f"random-patch path at {side} px: no patch JSON beside {out}")
        seconds = (duration or PATCH_SECONDS)
        log(f"[patch] generate {seconds:g} s @ 44.1 kHz wav -> {n_frames} I420 frames {side}x{side}, batch {batch}, "
            f"bf16, downscale_factor {downscale}: " + ", ".join(f"{k} {stats[k]:.3f}" for k in (
                "load_s", "mir_features_s", "mir_segmentation_s", "model_s", "patch_s", "render_s"))
            + f"; end to end {total:.3f} s = {n_frames / total:.2f} fps = {seconds / total:.2f}x realtime; render "
            f"{n_frames / stats['render_s']:.2f} fps; noise banks {stats['bank_bytes'] / 1e6:.1f} MB; peak memory "
            f"{peak:.2f} GiB; sliding_median launches {b1} (expected {PATCH_B1}); {json_file.name}; "
            f"frame crc[0] {sink.crcs[0]:08x}")
        if downscale == 4:
            counts = {"sliding_median": b1}
            log(f"[patch] noise trees alone (warm-up) are {trees_s / stats['render_s']:.3f} of this render")
    return counts


def two_part_track(sr: int, seconds: float = 4.0) -> np.ndarray:
    """A quiet-noise 220 Hz half and a noisy 330 Hz half with a click every
    half second: the track of tests/test_torch_patch.py, on which the tuning
    estimate and the hard CQT labels have a wide margin."""
    t = np.arange(int(sr * seconds)) / sr
    rng = np.random.RandomState(0)
    half = seconds / 2
    audio = (0.4 * np.sin(2 * np.pi * np.cumsum(np.where(t < half, 220.0, 330.0)) / sr)
             + np.where(t < half, 0.02, 0.15) * rng.randn(len(t))).astype(np.float32)
    audio[:: sr // 2] += 1.0
    return audio


@contextlib.contextmanager
def _banks_from_the_cpu():
    """``keys.normal`` drawing every array on the CPU, then moving it."""
    from ssar_tpu_torch.generate import keys

    saved = keys.normal
    keys.normal = lambda key, shape=(), device=None: saved(key, shape).to(device or "cpu")
    try:
        yield
    finally:
        keys.normal = saved


def reference_patch(dev):
    """Phase 12: the random-patch system at a small size on the card and on
    the CPU (fp32, 64 px model, 4 s at 12 fps).  Music information: each
    feature within its docs/PARITY.md budget, the same tempo and CQT labels,
    and the same labels when the card segments the CPU's features.  One
    seed's Patch with the banks drawn on the CPU on both devices, from the
    CPU's music information: the same JSON, latents and every layer's noise
    windows within 1e-4, frames within 1e-3."""
    from ssar_tpu_torch.audio.features import PARITY_BUDGETS
    from ssar_tpu_torch.gan.stylegan2 import StyleGAN2Config
    from ssar_tpu_torch.gan.wrapper import StyleGAN2Mapper, StyleGAN2Synthesizer
    from ssar_tpu_torch.generate import mir
    from ssar_tpu_torch.generate.patch import Patch
    from ssar_tpu_torch.utils.device import full_precision

    fps, ks = 12, (2, 4)
    sr = 1024 * fps
    audio = two_part_track(sr)
    group = {"chromagram": "chroma", "tonnetz": "tonnetz", "mfcc": "mfcc", "spectral_contrast": "contrast",
             "spectral_flatness": "flatness", "rms": "rms", "drop_strength": "drop_strength", "onsets": "onsets"}
    card = mir.retrieve_music_information(audio, sr, ks=ks, device=dev)
    cpu = mir.retrieve_music_information(audio, sr, ks=ks, device="cpu")
    if card[2] != cpu[2]:
        fail(f"music information: tempo on the card {card[2]} != CPU {cpu[2]}")
    worst = {}
    for name, f in cpu[0].items():
        budget = PARITY_BUDGETS[group[name]][1] if name in group else 1e-3
        worst[name] = float((card[0][name].cpu() - f).abs().max())
        if worst[name] > budget:
            fail(f"music information: {name} card vs CPU deviates by {worst[name]:.3g} > {budget}")
    for k in ks:
        if not torch.equal(card[1][("rosa", k)].cpu(), cpu[1][("rosa", k)]):
            fail(f"music information: CQT labels (k = {k}) differ between the card and the CPU")

    # the card's host segmentation, tempo and post-processing of the CPU's raw features
    with torch.no_grad(), full_precision():
        raw = {fn.__name__: fn(torch.as_tensor(audio), sr) for fn in mir.AFEATFNS}

    def fed_feature(name):
        def fn(a, s):
            return raw[name].to(a.device)
        fn.__name__ = name
        return fn

    saved = mir.AFEATFNS
    mir.AFEATFNS = [fed_feature(name) for name in raw]
    try:
        fed = mir.retrieve_music_information(audio, sr, ks=ks, include_rosa=False, device=dev)
    finally:
        mir.AFEATFNS = saved
    for key, labels in fed[1].items():
        if not torch.equal(labels.cpu(), cpu[1][key]):
            fail(f"music information: labels of {key} from the CPU's features differ on the card")

    cfg = StyleGAN2Config(resolution=64)
    mapper = StyleGAN2Mapper(config=cfg, seed=SEED, device="cpu")
    palette = mapper(torch.randn(24, 512, generator=torch.Generator().manual_seed(SEED)))
    syn_cpu = StyleGAN2Synthesizer(config=cfg, dtype=torch.float32, device="cpu", params=mapper.params)
    syn_card = StyleGAN2Synthesizer(config=cfg, dtype=torch.float32, device=dev, params=_to(mapper.params, dev))
    feats, segs, tempo = cpu
    out, jsons = {}, []
    # the patch and its noise trees in sample.generate's own scope, no_grad only: their gaussian filters take
    # full float32 themselves (fault C4); the synthesis, which sample.generate runs in bf16, in full float32
    with _banks_from_the_cpu(), torch.no_grad():
        for device in (dev, torch.device("cpu")):
            patch = Patch(_to(feats, device), {k: v.to(device) for k, v in segs.items()}, tempo, fps=fps, seed=7)
            path = ROOT / "build" / "chip_smoke_runs" / f"patch_{device.type}.json"
            path.parent.mkdir(parents=True, exist_ok=True)
            patch.save(str(path))
            jsons.append(path.read_text())
            # banks of a 1024 px model's layers at 1/4, as sample.generate renders 256 px from one: layers
            # 4 .. 12 then have the 64 px model's noise sizes
            latents, noise = patch.forward(palette.to(device), downscale_factor=4)
            T = latents.shape[0]
            windows = [[nm(i, 4).cpu() for i in (0, T - 2)] for nm in noise]
            syn = syn_card if device.type == "cuda" else syn_cpu
            with full_precision():
                frames = syn(latents[:4], noises=[nm(0, 4)[..., None] for nm in noise[4 : 4 + syn.n_noises_used]])
            frames = frames.cpu()
            out[device.type] = (latents.cpu(), windows, frames)
    if jsons[0] != jsons[1]:
        fail("patch JSON differs between the card and the CPU")
    (lat_a, win_a, img_a), (lat_b, win_b, img_b) = out["cuda"], out["cpu"]
    lat_err = float((lat_a - lat_b).abs().max())
    win_err = max(float((a - b).abs().max()) for wa, wb in zip(win_a, win_b) for a, b in zip(wa, wb))
    img_err = float((img_a - img_b).abs().max())
    if not (lat_err <= 1e-4 and win_err <= 1e-4 and img_err <= 1e-3):
        fail(f"patch card vs CPU: latents {lat_err:.3g} (1e-4), noise windows {win_err:.3g} (1e-4), frames "
             f"{img_err:.3g} (1e-3)")
    errors = ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
    log(f"[reference] music information card vs CPU (4 s at {fps} fps): tempo {card[2]} on both, CQT labels equal, "
        f"labels from the CPU's features equal; feature max errors: {errors}")
    log(f"[reference] patch (seed 7, 64 px, fp32, banks drawn on the CPU) card vs CPU: the same JSON; latents "
        f"{lat_err:.3g}, {len(win_a)} layers' noise windows {win_err:.3g}, frames {img_err:.3g}")


def check_c4(dev):
    """Fault C4: ``gaussian_filter`` on the card with TF32 explicitly allowed
    for cuDNN, within 1e-6 of float64 on the CPU relative to the largest
    output; beside it, the same convolution without the filter's own scope,
    as it ran before the repair (whether cuDNN picks a TF32 algorithm)."""
    import torch.nn.functional as F

    from ssar_tpu_torch.ops.gaussian import gaussian_filter, gaussian_kernel

    rows = []
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for shape, sigma in (((1440, 59), 2.0), ((192, 4, 32, 32), 5.0), ((96, 3, 64, 64), 20.0)):
            x = torch.randn(shape, generator=torch.Generator().manual_seed(SEED))
            want = gaussian_filter(x.double(), sigma)
            scale = float(want.abs().max())
            fixed = float((gaussian_filter(x.to(dev), sigma).cpu().double() - want).abs().max()) / scale
            r = int(sigma * 4)
            flat = F.pad(x.reshape(shape[0], -1).T[:, None, :].to(dev), (r, r), mode="circular")
            raw = F.conv1d(flat, gaussian_kernel(sigma, r, device=dev)[None, None])[:, 0].T.reshape(shape)
            before = float((raw.cpu().double() - want).abs().max()) / scale
            rows.append(f"{shape} sigma {sigma}: {fixed:.3g} (without the scope {before:.3g})")
            if not fixed <= 1e-6:
                fail(f"gaussian_filter on the card with TF32 allowed: {fixed:.3g} of the largest output from float64")
        if torch.backends.cudnn.allow_tf32 is not True:
            fail("gaussian_filter did not restore cudnn.allow_tf32")
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    log("[reference] C4: gaussian_filter with TF32 allowed, error against float64 over the largest output: "
        + "; ".join(rows))


def render_rgb(synthesizer, latents, noise, side: int, batch: int) -> torch.Tensor:
    """The serve path's render loop with uint8 RGB transfer: (T, side, side,
    3) frames in pinned host memory."""
    from ssar_tpu_torch.gan.render import render_latents_to_video
    from ssar_tpu_torch.generate.audio2video import duplicate_pyramid

    sink = RGBSink(latents.shape[0], side)
    render_latents_to_video(synthesizer, latents, duplicate_pyramid(noise)[: synthesizer.n_noises_used],
                            output_size=(side, side), batch_size=batch, progress=False, transfer="rgb", writer=sink)
    if sink.n != latents.shape[0]:
        fail(f"the render wrote {sink.n} frames, expected {latents.shape[0]}")
    return sink.frames


def eval_stages(audio: np.ndarray, sr: int, video: torch.Tensor) -> dict:
    """The evaluation's stages, each timed alone on the card (outside the
    launch-counted runs): resampling, HPSS and onsets, chroma, histograms,
    spatial spectrum, optical flow, directogram (with its onset envelope)
    and beat tracking."""
    from ssar_tpu_torch.audio.beat import onset_strength
    from ssar_tpu_torch.audio.beat_host import beat_track
    from ssar_tpu_torch.audio.features import harmonic, percussive
    from ssar_tpu_torch.audio.processing import onset_envelope, spectral_flux
    from ssar_tpu_torch.audio.spectral import chroma_cens
    from ssar_tpu_torch.metrics.chroma import _frame_histograms, nn_filter_cosine_median
    from ssar_tpu_torch.metrics.rhythmic import _audio_at_rate
    from ssar_tpu_torch.utils.device import full_precision
    from ssar_tpu_torch.video.features import directogram, optical_flow, video_spectrogram

    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return out

    with full_precision():
        a, s = timed("resample_s", lambda: _audio_at_rate(audio, sr, FPS, video.device))
        timed("hpss_onsets_s", lambda: onset_strength(percussive(a), s))
        timed("chroma_s", lambda: nn_filter_cosine_median(chroma_cens(harmonic(a), s)))
        timed("histograms_s", lambda: _frame_histograms(video))
        timed("spectrum_s", lambda: video_spectrogram(video))
        flow = timed("optical_flow_s", lambda: optical_flow(video))
        env = timed("directogram_s", lambda: onset_envelope(spectral_flux(directogram(flow))).cpu().numpy())
        timed("beat_tracking_s", lambda: beat_track(env, sr=FPS * 1024, hop_length=1024))
    return stages


def evaluation(audio: np.ndarray, sr: int, video: torch.Tensor, beats: bool = True) -> dict:
    """evaluate_reactivity, every VIDEO_FEATURES entry and (with `beats`)
    visual_beats on the card, each timed, with the B1 and B2 launches of
    each."""
    from ssar_tpu_torch.metrics.sectional import evaluate_reactivity
    from ssar_tpu_torch.ops import absdiff_cuda, median_cuda
    from ssar_tpu_torch.video.features import VIDEO_FEATURES
    from ssar_tpu_torch.video.visual_beats import visual_beats

    out = {"seconds": {}, "b1": {}, "b2": {}}

    def run(name, fn):
        torch.cuda.synchronize()
        b1, b2 = median_cuda.launches, absdiff_cuda.launches
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t0
        out["b1"][name], out["b2"][name] = median_cuda.launches - b1, absdiff_cuda.launches - b2
        return res

    out["scores"] = run("evaluate_reactivity", lambda: evaluate_reactivity(audio, sr, video, FPS, device=video.device))
    out["features"] = run("VIDEO_FEATURES", lambda: {k: fn(video) for k, fn in VIDEO_FEATURES.items()})
    if beats:
        out["beats"] = run("visual_beats", lambda: visual_beats(video, fps=FPS))
    return out


def check_evaluation(res: dict, T: int, where: str):
    """Scores in range, every feature finite with T rows, and the B1 and B2
    launches equal to the counts derived from the code."""
    r, c = res["scores"]["rhythmic"], res["scores"]["chromatic"]
    if not (math.isfinite(r) and math.isfinite(c) and 0.0 <= r <= 1.0 and -1.0 <= c <= 1.0):
        fail(f"evaluation {where}: rhythmic {r} (in [0, 1]?), chromatic {c} (in [-1, 1]?)")
    for name, f in res["features"].items():
        if f.shape[0] != T or not bool(torch.isfinite(f).all()):
            fail(f"evaluation {where}: VIDEO_FEATURES[{name!r}] {tuple(f.shape)}, finite={bool(torch.isfinite(f).all())}")
    for key, want in (("b1", EVAL_B1), ("b2", EVAL_B2)):
        want = {k: v for k, v in want.items() if k in res[key]}
        if res[key] != want:
            fail(f"evaluation {where}: {'sliding_median' if key == 'b1' else 'absdiff'} launches {res[key]}, "
                 f"expected {want}")


def evaluate_path(dev, synthesizer, config, palette, clip_audio: np.ndarray, clip_latents, clip_noise) -> dict:
    """Phase 13: phase 11's 60 s track through the serve path (features, the
    GRU reactor, 1440 frames of the 1024 px StyleGAN2 in bf16, batch 16) into
    uint8 RGB frames, prepared on the card as a decoded file would be
    (box-mean downsampling by 4, / 255: (1440, 3, 256, 256) float32), then
    evaluate_reactivity, every VIDEO_FEATURES entry and visual_beats, after
    one untimed run at the same shapes; then phase 4's 8 s clip at 1024 px as
    it is; then the reactive and static clips of the reference's test.
    Returns the B1 and B2 launch counts of the timed 60 s evaluation, and
    the prepared 60 s frames and phase 4's clip prepared at 256 px (on the
    host) for phase 22."""
    from ssar_tpu_torch.audio.features import audio2features
    from ssar_tpu_torch.generate.audio2video import react
    from ssar_tpu_torch.metrics.rhythmic import rhythmic_reactivity
    from ssar_tpu_torch.metrics.sectional import prepare_frames
    from ssar_tpu_torch.models.reactor import LatentNoiseReactor

    sr = 44100
    track = synthetic_track(sr, PATCH_SECONDS, section_seconds=8)
    T = PATCH_SECONDS * FPS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = audio2features(track, sr, FPS, device=dev)
    torch.manual_seed(SEED)
    model = LatentNoiseReactor(feats.mean(0), feats.std(0) + 1e-6, palette, backbone="gru", hidden_size=32,
                               num_layers=4).to(dev).eval()
    latents, noise = react(model, feats, torch.Generator(dev).manual_seed(SEED + 1))
    frames = render_rgb(synthesizer, latents, noise, EVAL_SIDE, 16)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    video = prepare_frames(frames, EVAL_DOWNSAMPLE, device=dev)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0 - render_s
    side = EVAL_SIDE // EVAL_DOWNSAMPLE
    if tuple(video.shape) != (T, 3, side, side) or float(video.std()) == 0.0:
        fail(f"prepared frames {tuple(video.shape)}, std {float(video.std())}")
    del frames
    log(f"[evaluate] {PATCH_SECONDS} s @ 44.1 kHz -> features -> GRU reactor -> {T} uint8 RGB frames at "
        f"{EVAL_SIDE} px (bf16, batch 16) in {render_s:.3f} s; prepared on the card (box mean / "
        f"{EVAL_DOWNSAMPLE}, / 255) to {tuple(video.shape)} float32 ({video.numel() * 4 / 1e9:.2f} GB) in "
        f"{prepare_s:.3f} s")

    evaluation(track, sr, video)   # untimed: cuFFT plans, cuDNN heuristics, host caches at these shapes
    torch.cuda.reset_peak_memory_stats()
    res = evaluation(track, sr, video)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_evaluation(res, T, f"{PATCH_SECONDS} s at {side} px")
    sec = res["seconds"]
    bpm, beats = res["beats"]
    stages = eval_stages(track, sr, video)
    log(f"[evaluate] {PATCH_SECONDS} s at {side} px: evaluate_reactivity {sec['evaluate_reactivity']:.3f} s = "
        f"{PATCH_SECONDS / sec['evaluate_reactivity']:.2f}x realtime (rhythmic {res['scores']['rhythmic']:.6f}, "
        f"chromatic {res['scores']['chromatic']:.6f}); VIDEO_FEATURES ({len(res['features'])}) "
        f"{sec['VIDEO_FEATURES']:.3f} s; visual_beats {sec['visual_beats']:.3f} s ({bpm:.1f} BPM, {len(beats)} "
        f"beats); all three {sum(sec.values()):.3f} s = {PATCH_SECONDS / sum(sec.values()):.2f}x realtime; peak "
        f"memory {peak:.2f} GiB; sliding_median launches {res['b1']}, absdiff launches {res['b2']} (as derived)")
    log("[evaluate] stages alone: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    counts = {"sliding_median": sum(res["b1"].values()), "absdiff": sum(res["b2"].values())}
    kept = {"video60": video.cpu()}   # phase 22's input, off the card until then

    # phase 4's 8 s clip at 1024 px, not downsampled: the widest frame that users pass
    frames = render_rgb(synthesizer, clip_latents, clip_noise, EVAL_SIDE, 16)
    video = prepare_frames(frames, 1, device=dev)
    kept["clip256"] = prepare_frames(frames, EVAL_DOWNSAMPLE, device=dev).cpu()
    del frames
    n = video.shape[0]
    evaluation(clip_audio, sr, video, beats=False)
    torch.cuda.reset_peak_memory_stats()
    res = evaluation(clip_audio, sr, video, beats=False)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_evaluation(res, n, f"8 s at {EVAL_SIDE} px")
    sec = res["seconds"]
    log(f"[evaluate] 8 s at {EVAL_SIDE} px ({tuple(video.shape)} float32, {video.numel() * 4 / 1e9:.2f} GB): "
        f"evaluate_reactivity {sec['evaluate_reactivity']:.3f} s = {8 / sec['evaluate_reactivity']:.2f}x realtime "
        f"(rhythmic {res['scores']['rhythmic']:.6f}, chromatic {res['scores']['chromatic']:.6f}); VIDEO_FEATURES "
        f"{sec['VIDEO_FEATURES']:.3f} s; peak memory {peak:.2f} GiB; sliding_median launches {res['b1']}, absdiff "
        f"launches {res['b2']} (as derived)")
    del video

    # the reference's constructed clips (tests/test_metrics_video.py): a white flash on each onset of a click
    # track scores higher than a static clip
    rng = np.random.RandomState(SEED)
    sr_c, n = 24576, 48
    audio = 0.05 * rng.randn(sr_c * 2).astype(np.float32)
    audio[:: sr_c // 4] += 1.5
    reactive = np.zeros((n, 3, 16, 16), np.float32)
    reactive[::6] = 1.0
    static = np.full((n, 3, 16, 16), 0.5, np.float32) + 0.01 * rng.rand(n, 3, 16, 16).astype(np.float32)
    r_reactive = float(rhythmic_reactivity(audio, sr_c, reactive, FPS, device=dev))
    r_static = float(rhythmic_reactivity(audio, sr_c, static, FPS, device=dev))
    if not r_reactive > r_static:
        fail(f"rhythmic reactivity: flashes on the onsets {r_reactive} <= a static clip {r_static}")
    log(f"[evaluate] constructed clips: flashes on the onsets {r_reactive:.6f} > static {r_static:.6f}")
    return counts, kept


def textured_clip(T: int, side: int, seed: int = SEED) -> np.ndarray:
    """(T, 3, side, side) in [0, 1]: six gratings a channel drifting by
    (0.7, -0.4) px a frame, a clip on which the flow is well posed
    everywhere (tests/test_torch_video.py's)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    out = np.zeros((T, 3, side, side))
    t = np.arange(T)[:, None, None]
    for c in range(3):
        for _ in range(6):
            fx, fy = rng.uniform(0.05, 0.25, 2) * rng.choice([-1, 1], 2)
            ph = rng.uniform(0, 2 * np.pi)
            out[:, c] += np.sin(2 * np.pi * (fx * (xx - 0.7 * t) + fy * (yy + 0.4 * t)) + ph)
    return ((out - out.min()) / (out.max() - out.min())).astype(np.float32)


def reference_evaluate(dev):
    """Phase 14: the evaluation at a small size on the card and on the CPU
    (the same port code): a 4 s track through a 128 px fp32 StyleGAN2 into
    96 uint8 frames, prepared on both devices to 64 px (equal); both scores within 1e-5,
    every VIDEO_FEATURES output within 1e-4 of its largest magnitude,
    farneback_flow within 1e-4 px on the interior of a textured clip, and
    visual_beats with the same tempo.  Every comparison is made before any
    fails, so one run reports them all."""
    from ssar_tpu_torch.audio.features import audio2features
    from ssar_tpu_torch.gan.stylegan2 import StyleGAN2Config
    from ssar_tpu_torch.gan.wrapper import StyleGAN2Synthesizer
    from ssar_tpu_torch.generate.audio2video import react
    from ssar_tpu_torch.metrics.sectional import evaluate_reactivity, prepare_frames
    from ssar_tpu_torch.models.reactor import LatentNoiseReactor
    from ssar_tpu_torch.utils.device import full_precision
    from ssar_tpu_torch.video.features import VIDEO_FEATURES
    from ssar_tpu_torch.video.flow import farneback_flow
    from ssar_tpu_torch.video.visual_beats import visual_beats

    sr = 1024 * FPS
    audio = two_part_track(sr)
    cfg = StyleGAN2Config(resolution=128, max_channels=64)   # 12 W+ rows: three splits of the palette
    syn = StyleGAN2Synthesizer(config=cfg, seed=SEED, dtype=torch.float32, device=dev)
    feats = audio2features(audio, sr, FPS, device=dev)
    torch.manual_seed(SEED)
    palette = torch.randn(96, cfg.n_latent, 512, generator=torch.Generator().manual_seed(SEED))
    model = LatentNoiseReactor(feats.mean(0), feats.std(0) + 1e-6, palette, backbone="gru", hidden_size=32,
                               num_layers=4).to(dev).eval()
    latents, noise = react(model, feats, torch.Generator(dev).manual_seed(SEED + 1))
    with full_precision():
        frames = render_rgb(syn, latents, noise, 128, 16)
    v_card = prepare_frames(frames, 2, device=dev)   # to 64 px (cv2's INTER_AREA at 2: halves up)
    v_cpu = prepare_frames(frames, 2, device="cpu")
    problems = []
    if not torch.equal(v_card.cpu(), v_cpu):
        problems.append("prepare_frames differs between the card and the CPU")

    card = evaluate_reactivity(audio, sr, v_card, FPS, device=dev)
    cpu = evaluate_reactivity(audio, sr, v_cpu, FPS, device="cpu")
    score_err = {k: abs(card[k] - cpu[k]) for k in card}
    problems += [f"{k} card {card[k]} vs CPU {cpu[k]}" for k, e in score_err.items() if not e <= 1e-5]

    feat_err = {}
    for name, fn in VIDEO_FEATURES.items():
        a, b = fn(v_card).cpu(), fn(v_cpu)
        scale = float(b.abs().max())
        feat_err[name] = float((a - b).abs().max()) / max(scale, 1e-30)
        if not feat_err[name] <= 1e-4:
            problems.append(f"VIDEO_FEATURES[{name!r}] card vs CPU {feat_err[name]:.3g} of its largest magnitude")

    gray = torch.from_numpy(textured_clip(96, 64).mean(axis=1))
    flow_card, flow_cpu = farneback_flow(gray.to(dev)).cpu(), farneback_flow(gray)
    flow_err = float((flow_card - flow_cpu)[..., 8:-8, 8:-8].abs().max())
    if not flow_err <= 1e-4:
        problems.append(f"farneback_flow card vs CPU {flow_err:.3g} px on the interior")
    drift = float(flow_cpu[:, 0, 8:-8, 8:-8].median())

    (bpm_card, beats_card), (bpm_cpu, beats_cpu) = visual_beats(v_card, fps=FPS), visual_beats(v_cpu, fps=FPS)
    if bpm_card != bpm_cpu:
        problems.append(f"visual_beats tempo card {bpm_card} vs CPU {bpm_cpu}")
    log(f"[reference] evaluation card vs CPU (4 s, 96 frames of a 128 px fp32 StyleGAN2 at 64 px): scores card {card}, CPU "
        f"{cpu}; VIDEO_FEATURES errors over their largest magnitudes: "
        + ", ".join(f"{k} {v:.3g}" for k, v in feat_err.items())
        + f"; farneback_flow on a textured clip {flow_err:.3g} px (interior, drift {drift:.3f} px a frame); "
        f"visual_beats {bpm_card} / {bpm_cpu} BPM, beats equal: {np.array_equal(beats_card, beats_cpu)}")
    if problems:
        fail("evaluation card vs CPU: " + "; ".join(problems))

# ------------------------------------------------------------------ 15-18 --
# the reactor backbones of the JAX package's BACKBONES beyond the grid's sashimi and the serve path's GRU
NEW_BACKBONES = ("lstm", "conv", "mlp", "transformer")
BACKBONE_STEPS = 4


def _peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def backbones_path(dev) -> dict:
    """Phase 15: ``train.main`` at the grid of record's width with each new
    backbone (ssabsdiff, fixed decoder), then the experiments.py smoke grid's
    cell (mlp, learned decoder, supervised), each 4 steps with an eval at the
    first; B2's launches read around each ssabsdiff run and checked exactly
    (5 a step and 5 an eval batch), no B3; a warm timed loop of each; then a
    learned-decoder reactor with ``noise_mode="conv3d"`` through ``react``
    and one gradient step.  Returns B2's launches over the four runs."""
    from ssar_tpu_torch.generate.audio2video import react
    from ssar_tpu_torch.models.reactor import ConvNoiseUpsampler, LatentNoiseReactor
    from ssar_tpu_torch.ops import absdiff_cuda, vandermonde_cuda
    from ssar_tpu_torch.train import train as trainer
    from ssar_tpu_torch.train.data import compute_stats, synthetic_dataset

    args = trainer.build_parser().parse_args(TRAIN_FLAGS)
    B = args.batch_size
    once = ["--eval_every", "1000000", "--ckpt_every", "1000000", "--no-render_at_ckpt"]
    total = 0
    for name in NEW_BACKBONES:
        flags = TRAIN_FLAGS + ["--backbone", name] + once
        absdiff_cuda.launches = vandermonde_cuda.launches = vandermonde_cuda.bwd_launches = 0
        log_dir, _ = run_trainer(flags, BACKBONE_STEPS, f"{name}/fixed/ssabsdiff")
        evals = len(_metric_rows(log_dir, "Loss/val")) * math.ceil(16 / B)
        want = 5 * (BACKBONE_STEPS + evals)
        got = (absdiff_cuda.launches, vandermonde_cuda.launches + vandermonde_cuda.bwd_launches)
        if got != (want, 0):
            fail(f"{name} backbone: absdiff / Vandermonde launches {got}, expected ({want}, 0)")
        fcd = _metric_rows(log_dir, "Eval/FCD")
        if len(fcd) != 1 or not math.isfinite(fcd[0]):
            fail(f"{name} backbone: Eval/FCD {fcd}")
        total += got[0]
        log(f"[backbones] {name}: absdiff launches {got[0]} (expected {want}: {BACKBONE_STEPS} steps, {evals} eval "
            f"batch), Eval/FCD {fcd[0]:.4f}")
    run_trainer(TRAIN_FLAGS + ["--backbone", "mlp", "--decoder", "learned", "--loss", "supervised"] + once,
                BACKBONE_STEPS, "mlp/learned/supervised (the experiments.py smoke cell)")

    ds = synthetic_dataset(n_windows=64, n_frames=args.duration * args.fps)
    data = ds.to_device(dev)
    palette = np.random.RandomState(SEED).randn(args.n_latent_split * args.hidden_size, 18, 512).astype(np.float32)
    for name, extra in [(n, []) for n in NEW_BACKBONES] + [("mlp", ["--decoder", "learned", "--loss", "supervised"])]:
        r = timed_steps(dev, TRAIN_FLAGS + ["--backbone", name] + extra, data, ds, palette)
        log(f"[backbones] timed train_step_gather {name} {' '.join(extra) or 'fixed ssabsdiff'}: {r['ms_per_step']:.3f} "
            f"ms/step = {r['examples_per_s']:.1f} examples/s (batch {B} x {args.duration * args.fps} frames); peak "
            f"memory {r['peak_gib']:.3f} GiB; device busy {r['device_ms_per_step']:.3f} ms/step in "
            f"{r['launches_per_step']:.0f} kernels; top device ms/step {r['top']}")
    del data

    # the v1 reactor's 3-D-conv noise pyramid: the learned decoder through react, then one gradient step
    mean, std = compute_stats(ds.features)
    torch.manual_seed(SEED)
    model = LatentNoiseReactor(mean, std, backbone="gru", hidden_size=args.hidden_size, num_layers=args.num_layers,
                               decoder="learned", noise_mode="conv3d").to(dev)
    if not isinstance(model.decoder.noise_head, ConvNoiseUpsampler):
        fail("noise_mode='conv3d' did not build the ConvNoiseUpsampler")
    feats = torch.as_tensor(ds.features[0], dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    latents, noise = react(model.eval(), feats)
    torch.cuda.synchronize()
    t_react = time.perf_counter() - t0
    T = feats.shape[0]
    if tuple(latents.shape) != (T, 18, 512) or [tuple(n.shape) for n in noise] != [(T, 1, s, s) for s in (4, 8, 16, 32)]:
        fail(f"conv3d reactor: latents {tuple(latents.shape)}, noise {[tuple(n.shape) for n in noise]}")
    if not (bool(torch.isfinite(latents).all()) and all(bool(torch.isfinite(n).all()) for n in noise)):
        fail("conv3d reactor: non-finite output")
    model.train()
    x, lat = (torch.as_tensor(a[:B], dtype=torch.float32, device=dev) for a in (ds.features, ds.latents))
    noise_t = [torch.as_tensor(n[:B], dtype=torch.float32, device=dev) for n in ds.noises]

    def step():
        pred_lat, pred_noise = model(x)
        loss_ = (pred_lat - lat).square().mean() + sum((n - t).square().mean() for n, t in zip(pred_noise, noise_t))
        return loss_, torch.autograd.grad(loss_, [p for p in model.parameters() if p.requires_grad])

    t0 = time.perf_counter()
    step()   # the first call: cuDNN's choice of 3-D convolution algorithms
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss, grads = step()
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    up = [g for (n, _), g in zip(((n, p) for n, p in model.named_parameters() if p.requires_grad), grads)
          if "noise_head" in n]
    if not (math.isfinite(float(loss)) and all(bool(torch.isfinite(g).all()) for g in grads)
            and all(float(g.abs().max()) > 0 for g in up)):
        fail(f"conv3d reactor: loss {float(loss)}, a non-finite or zero gradient in the noise pyramid")
    log(f"[backbones] conv3d learned reactor (gru, hidden {args.hidden_size}, {args.num_layers} layers): react on "
        f"{T} frames {t_react * 1e3:.2f} ms, noise {[tuple(n.shape) for n in noise]}; a gradient step at batch {B} "
        f"{t_step * 1e3:.2f} ms (the first {t_first * 1e3:.2f}), loss {float(loss):.5f}, {len(up)} pyramid gradients finite and non-zero; peak "
        f"memory {_peak_gib():.3f} GiB")
    return {"absdiff": total}


# the Sashimi U-Net at the grid's hidden width, every other argument at the JAX package's defaults
SASHIMI = dict(features=32, n_layers_per_tier=2, n_tiers=2, pool=4, expand=2, state_dim=64)
SASHIMI_BATCH, SASHIMI_FRAMES = 32, 192


def sashimi_path(dev) -> dict:
    """Phase 16: the Sashimi U-Net forward and the backward of a mean-square
    loss at batch 32 x 192 frames, B3's launches read around one of each and
    checked exactly; timed; then 192 SashimiStreamer steps against the
    forward (float32 without TF32) within 1e-4 of the largest magnitude."""
    from ssar_tpu_torch.models.sashimi import Sashimi, SashimiStreamer
    from ssar_tpu_torch.ops import vandermonde_cuda
    from ssar_tpu_torch.utils.device import full_precision

    cfg = SASHIMI
    torch.manual_seed(SEED)
    model = Sashimi(**cfg).to(dev)
    gen = torch.Generator().manual_seed(SEED + 6)
    x = torch.randn(SASHIMI_BATCH, SASHIMI_FRAMES, cfg["features"], generator=gen).to(dev)
    target = torch.randn(x.shape, generator=gen).to(dev)

    def forward():
        with torch.no_grad():
            return model(x)

    def forward_backward():
        model.zero_grad(set_to_none=True)
        loss = (model(x) - target).square().mean()
        loss.backward()
        return loss

    forward_backward()   # warm-up: cuFFT plans, the kernels' first launches
    torch.cuda.synchronize()
    # every tier: n_layers_per_tier blocks down and up; the centre n_layers_per_tier; one B3 forward and one
    # backward a block, at (features * expand**tier, state_dim / 2, frames / pool**tier) and the centre's
    blocks = cfg["n_tiers"] * 2 * cfg["n_layers_per_tier"] + cfg["n_layers_per_tier"]
    vandermonde_cuda.launches = vandermonde_cuda.bwd_launches = 0
    torch.cuda.reset_peak_memory_stats()
    loss = forward_backward()
    torch.cuda.synchronize()
    counts = {"s4d_vandermonde": vandermonde_cuda.launches, "s4d_vandermonde_bwd": vandermonde_cuda.bwd_launches}
    if counts != {"s4d_vandermonde": blocks, "s4d_vandermonde_bwd": blocks}:
        fail(f"Sashimi forward + backward launched B3 {counts}, expected {blocks} of each")
    if not math.isfinite(float(loss)) or any(p.grad is None or not bool(torch.isfinite(p.grad).all())
                                             for p in model.parameters()):
        fail(f"Sashimi: loss {float(loss)} or a gradient missing or non-finite")
    peak = _peak_gib()
    fwd_ms, step_ms = cuda_ms(forward, runs=10), cuda_ms(forward_backward, runs=10)
    shapes = [(cfg["features"] * cfg["expand"] ** t, cfg["state_dim"] // 2, SASHIMI_FRAMES // cfg["pool"] ** t)
              for t in range(cfg["n_tiers"] + 1)]
    log(f"[sashimi] features {cfg['features']}, {cfg['n_tiers']} tiers of {cfg['n_layers_per_tier']} blocks, pool "
        f"{cfg['pool']}, expand {cfg['expand']}, state {cfg['state_dim']}; batch {SASHIMI_BATCH} x {SASHIMI_FRAMES} "
        f"frames: forward {fwd_ms:.3f} ms, forward + backward {step_ms:.3f} ms = "
        f"{SASHIMI_BATCH / step_ms * 1e3:.1f} examples/s; peak memory {peak:.3f} GiB; B3 {counts} at (H, N, L) "
        f"{shapes} (exact)")

    model.eval()
    with torch.no_grad(), full_precision():
        want = model(x)
        streamer = SashimiStreamer(model, SASHIMI_BATCH)
        t0 = time.perf_counter()
        got = torch.stack([streamer.step(x[:, t]) for t in range(SASHIMI_FRAMES)], dim=1)
        torch.cuda.synchronize()
        t_stream = time.perf_counter() - t0
    err = float((got - want).abs().max() / want.abs().max())
    if not err <= 1e-4:
        fail(f"SashimiStreamer differs from the forward by {err:.3g} of the largest magnitude")
    log(f"[sashimi] {SASHIMI_FRAMES} SashimiStreamer steps in {t_stream:.3f} s "
        f"({t_stream / SASHIMI_FRAMES * 1e3:.3f} ms a frame, batch {SASHIMI_BATCH}); against the forward "
        f"{err:.3g} of the largest magnitude")
    return counts


def _timed(fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, _peak_gib()


def trainers_path(dev):
    """Phase 17: the other model families' trainers at the JAX package's
    defaults on the card: ms a step, peak memory, finite losses; the
    Audio2Latent loss falls and its FCD is finite; the calibration G keeps its
    mapping."""
    from ssar_tpu_torch.gan import stylegan2 as sg
    from ssar_tpu_torch.train import palette_g, trainers
    from ssar_tpu_torch.train.data import synthetic_dataset

    ds = synthetic_dataset(n_windows=64, n_frames=8 * FPS)

    def report(tag, steps, seconds, peak, losses, extra=""):
        flat = [v for seq in losses for v in seq]
        if not flat or not all(math.isfinite(v) for v in flat):
            fail(f"{tag}: non-finite losses")
        log(f"[trainers] {tag}: {steps} steps in {seconds:.3f} s = {seconds / steps * 1e3:.2f} ms/step; peak memory "
            f"{peak:.3f} GiB; loss {[round(seq[0], 5) for seq in losses]} -> {[round(seq[-1], 5) for seq in losses]}"
            f"{extra}")

    (model, m), secs, peak = _timed(lambda: trainers.train_audio2latent(ds, n_steps=20, batch_size=8, device=dev))
    losses = m["losses"]
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        fail(f"train_audio2latent: loss did not fall: {losses}")
    report("train_audio2latent (gru, hidden 32, 2 layers, batch 8, (192, 18, 512) latents)", 20, secs, peak, [losses])
    (_, m_fcd), secs, _ = _timed(lambda: trainers.train_audio2latent(ds, n_steps=1, batch_size=8, eval_fcd=True,
                                                                     device=dev))
    if not (math.isfinite(m_fcd["fcd"]) and m_fcd["fcd"] >= 0):
        fail(f"train_audio2latent eval_fcd: {m_fcd['fcd']}")
    log(f"[trainers] train_audio2latent eval_fcd: FCD {m_fcd['fcd']:.4f} (one step, the encoder's 50 steps and the "
        f"FCD in {secs:.3f} s)")

    (_, m), secs, peak = _timed(lambda: trainers.train_psagan(ds, n_steps=10, batch_size=8, device=dev))
    report("train_psagan (features 32, 3 stages, batch 8)", 10, secs, peak, [m["d_losses"], m["g_losses"]])

    wplus = np.ascontiguousarray(ds.latents[:, :24])   # 24-frame W+ sequences: the discriminator's seq_len
    (_, m), secs, peak = _timed(lambda: trainers.train_stylevideogan(wplus, n_steps=10, batch_size=4, device=dev))
    report("train_stylevideogan (latent 32, batch 4, 18 styles, 24 frames)", 10, secs, peak,
           [m["d_losses"], m["g_losses"]])

    (_, m), secs, peak = _timed(lambda: trainers.train_sslstm(ds, n_steps=10, batch_size=4, device=dev))
    report("train_sslstm (hidden 16, 2 layers, batch 4)", 10, secs, peak, [m["losses"]])
    g_cfg = sg.StyleGAN2Config(resolution=64)
    g_params = sg.init_generator(g_cfg, torch.Generator().manual_seed(SEED), dev)
    (_, m), secs, peak = _timed(lambda: trainers.train_sslstm(ds, n_steps=10, batch_size=4, gan_params=g_params,
                                                              gan_config=g_cfg, video_patch_weight=0.5, device=dev))
    report("train_sslstm with video_patch_weight 0.5 through a 64 px G", 10, secs, peak, [m["losses"]])

    # scripts/train_calibration_g.py's defaults, cut to 25 steps
    c_cfg = sg.StyleGAN2Config(resolution=256, max_channels=128)
    init = sg.init_generator(c_cfg, torch.Generator().manual_seed(SEED), dev)
    mapping = _to(init["mapping"], "cpu")
    (out, secs, peak) = _timed(lambda: palette_g.train_calibration_g(c_cfg, n_steps=25, batch_size=16, lr=2e-3,
                                                                     lambda_adv=0.05, r1_gamma=1.0, progress=False,
                                                                     device=dev, params=init))
    params, _, losses = out
    moved = not torch.equal(params["convs"][0]["weight"].cpu(), init["convs"][0]["weight"].cpu())
    same_map = all(torch.equal(a["weight"].cpu(), b["weight"]) and torch.equal(a["bias"].cpu(), b["bias"])
                   for a, b in zip(params["mapping"], mapping))
    if not (moved and same_map):
        fail(f"train_calibration_g: synthesis moved {moved}, mapping unchanged {same_map}")
    report("train_calibration_g (256 px, max_channels 128, batch 16, lambda_adv 0.05, R1 1.0, bf16)", 25, secs,
           peak, [losses["mse"], losses["d_loss"], losses["g_adv"]],
           f"; mapping unchanged; palette alignment {palette_g.palette_target_alignment(params, c_cfg):.3f}")


def reference_families(dev):
    """Phase 18: card against CPU at a small size in float32 without TF32,
    the same weights and draws (``keys.normal`` drawn on the CPU): every new
    backbone's forward, the Sashimi forward and backward, the Discriminator
    and PSPEncoder, the conv3d noise pyramid, and two steps of each trainer
    (losses, and the parameters after them), each within 1e-4 of the largest
    magnitude."""
    from ssar_tpu_torch.gan import stylegan2 as sg
    from ssar_tpu_torch.gan.discriminator import Discriminator, PSPEncoder
    from ssar_tpu_torch.generate import keys
    from ssar_tpu_torch.models.backbones import make_backbone
    from ssar_tpu_torch.models.reactor import ConvNoiseUpsampler
    from ssar_tpu_torch.models.sashimi import Sashimi
    from ssar_tpu_torch.train import palette_g, trainers
    from ssar_tpu_torch.train.data import synthetic_dataset
    from ssar_tpu_torch.train.palette_g import _leaves
    from ssar_tpu_torch.utils.device import full_precision

    worst = {}

    def check(tag, got, want, scale=None):
        err = float((got.detach().cpu().double() - want.detach().double()).abs().max())
        scale = float(want.detach().abs().max()) if scale is None else scale
        if not err <= 1e-4 * scale:
            fail(f"reference {tag}: card differs from the CPU by {err:.3g} (largest {scale:.3g})")
        worst[tag] = max(worst.get(tag, 0.0), err / scale if scale else 0.0)

    def check_grads(tag, card_leaves, cpu_leaves):
        """Gradients within 1e-4 of the largest gradient of the network."""
        pairs = [(a.grad, b.grad) for a, b in zip(card_leaves, cpu_leaves) if b.grad is not None]
        scale = max(float(b.abs().max()) for _, b in pairs)
        for a, b in pairs:
            check(tag, a, b, scale)

    gen = torch.Generator().manual_seed(SEED + 8)
    with full_precision():
        x = torch.randn(4, 48, 16, generator=gen)
        for name in NEW_BACKBONES:
            torch.manual_seed(SEED)
            cpu = make_backbone(name, 16, 2)[0]
            card = copy.deepcopy(cpu).to(dev)
            check(f"backbone {name}", card(x.to(dev)), cpu(x))
        torch.manual_seed(SEED)
        cpu = Sashimi(16, state_dim=16)
        card = copy.deepcopy(cpu).to(dev)
        xs = torch.randn(2, 64, 16, generator=gen)
        check("sashimi forward", card(xs.to(dev)), cpu(xs))
        for m, inp in ((cpu, xs), (card, xs.to(dev))):
            m(inp).square().mean().backward()
        check_grads("sashimi backward", list(card.parameters()), list(cpu.parameters()))
        img = torch.randn(4, 32, 32, 3, generator=gen)
        for tag, make in (("Discriminator", lambda: Discriminator(32, 1)), ("PSPEncoder", lambda: PSPEncoder(6, 32)),
                          ("ConvNoiseUpsampler", lambda: ConvNoiseUpsampler(16, 16))):
            torch.manual_seed(SEED)
            cpu = make().eval()
            card = copy.deepcopy(cpu).to(dev)
            inp = img if tag != "ConvNoiseUpsampler" else x
            with torch.no_grad():
                g, w = card(inp.to(dev)), cpu(inp)
            for a, b in zip(g if isinstance(g, list) else [g], w if isinstance(w, list) else [w]):
                check(tag, a, b)

        normal = keys.normal
        keys.normal = lambda key, shape=(), device=None: normal(key, shape).to(device or "cpu")
        try:
            ds = synthetic_dataset(n_windows=4, n_frames=16, seed=3)
            wplus = np.random.RandomState(4).randn(4, 6, 2, 512).astype(np.float32) * 0.1
            cfg = sg.StyleGAN2Config(resolution=16, max_channels=16)
            init = sg.init_generator(cfg, torch.Generator().manual_seed(SEED))
            runs = {   # one step each: its losses, and the gradients it applied (left in .grad)
                "train_audio2latent": lambda d: trainers.train_audio2latent(ds, n_steps=1, batch_size=2,
                                                                            hidden_size=8, device=d),
                "train_psagan": lambda d: trainers.train_psagan(ds, n_steps=1, batch_size=2, features=8, n_stages=2,
                                                                device=d),
                "train_stylevideogan": lambda d: trainers.train_stylevideogan(wplus, n_steps=1, batch_size=2,
                                                                              latent_dim=8, device=d),
                "train_sslstm": lambda d: trainers.train_sslstm(ds, n_steps=1, batch_size=2, hidden_size=6,
                                                                n_patches=4, patch_len=4, device=d),
            }
            for tag, run in runs.items():
                (m_cpu, l_cpu), (m_card, l_card) = run("cpu"), run(dev)
                for k, v in l_cpu.items():
                    check(f"{tag} {k}", torch.tensor(l_card[k]), torch.tensor(v))
                mods_cpu = [m for m in (m_cpu if isinstance(m_cpu, tuple) else (m_cpu,)) if m is not None]
                mods_card = [m for m in (m_card if isinstance(m_card, tuple) else (m_card,)) if m is not None]
                for a, b in zip(mods_card, mods_cpu):
                    check_grads(f"{tag} gradients", list(a.parameters()), list(b.parameters()))
            c_cpu, c_card = (palette_g.train_calibration_g(cfg, n_steps=1, batch_size=2, progress=False, device=d,
                                                           params=_to(init, d), dtype=torch.float32)
                             for d in ("cpu", dev))
            for k in c_cpu[2]:
                check(f"train_calibration_g {k}", torch.tensor(c_card[2][k]), torch.tensor(c_cpu[2][k]))
            synth = [k for k in c_cpu[0] if k not in ("mapping", "w_avg")]
            check_grads("train_calibration_g G gradients", _leaves([c_card[0][k] for k in synth]),
                        _leaves([c_cpu[0][k] for k in synth]))
            check_grads("train_calibration_g D gradients", list(c_card[1].parameters()), list(c_cpu[1].parameters()))
        finally:
            keys.normal = normal
    log("[reference] other families card vs CPU (fp32, no TF32), worst error over the largest magnitude: "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))


# ------------------------------------------------------------------ 19-21 --
# the kernels' launch counters, read around each path of phases 19 and 20
COUNTED = ("sliding_median", "sliding_median_bwd", "absdiff", "s4d_vandermonde", "s4d_vandermonde_bwd")


def _zero_counts():
    from ssar_tpu_torch.ops import absdiff_cuda, median_cuda, vandermonde_cuda

    median_cuda.launches = median_cuda.bwd_launches = median_cuda.generic_launches = 0
    median_cuda.generic_bwd_launches = absdiff_cuda.launches = 0
    vandermonde_cuda.launches = vandermonde_cuda.bwd_launches = 0


def _counts() -> dict:
    from ssar_tpu_torch.ops import absdiff_cuda, median_cuda, vandermonde_cuda

    if median_cuda.generic_launches or median_cuda.generic_bwd_launches:
        fail("a path launched the generic (k > 31) median kernels, which no caller asks for")
    return {"sliding_median": median_cuda.launches, "sliding_median_bwd": median_cuda.bwd_launches,
            "absdiff": absdiff_cuda.launches, "s4d_vandermonde": vandermonde_cuda.launches,
            "s4d_vandermonde_bwd": vandermonde_cuda.bwd_launches}


def _expect(what: str, got: dict, **want):
    """Fail unless the launch counts are exactly `want` (every other kernel 0)."""
    want = {k: want.get(k, 0) for k in COUNTED}
    if got != want:
        fail(f"{what}: kernel launches {got}, expected {want}")


def _add(total: dict, counts: dict):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def optional_packages() -> dict:
    """Which of the optional packages the harness uses this machine has (found
    without importing them: grain imports JAX where it is installed with it)."""
    import importlib.util

    return {name: importlib.util.find_spec(name) is not None for name in ("grain", "matplotlib", "pandas")}


# B1 launches, derived from the code: an HPSS is two filters.  The comparison's 9 audio features separate
# harmonic from percussive four times (chromagram, tonnetz's chromagram, onsets, pulse); its 12 video features
# filter two directograms at k = 3 (directogram, video_flow_onsets), and take one absdiff (B2).  A reactor's
# audio2features takes 4, the random patch's music information 8, the optimizer's feature set 6 (chromagram,
# tonnetz, onsets), the LucidSonicDreams recipe 4 (onsets, harmonic RMS); the recipes' chroma and onsets 2 each.
SCORE_B1, SCORE_B2 = 8 + 4, 1
PREDICT_B1 = {"random_patch": PATCH_B1, "sashimi_ssabsdiff": 4, "ssopt": 6, "lucid": 4}
RECIPE_B1 = {"low": 0, "high_chroma": 2, "high_onset": 2, "high_both": 4}
STUDY_SR, STUDY_SECONDS, STUDY_CLIPS = 1024 * FPS, 16, 2   # scripts/run_study.py: 16 s clips, cut from 6 to 2


def _raw_tracks(seed: int, lengths: list[int]):
    """Feature, latent and noise tracks of the given frame counts, concatenated."""
    rs = np.random.RandomState(seed)
    n = sum(lengths)
    return (rs.randn(n, 59).astype(np.float32), (0.1 * rs.randn(n, 18, 512)).astype(np.float32),
            [(0.1 * rs.randn(n, s, s)).astype(np.float32) for s in (4, 8, 16, 32)])


def raw_cache_run(dev) -> dict:
    """Phase 19's raw streaming cache: three synthetic tracks written both as a
    raw cache and as windowed shards; the trainer's first batch equal from
    either; then ``train.main`` at the train cell's width for 4 steps on the
    raw cache through ``MmapWindowDataset``, B2 / B3 launches exact."""
    from ssar_tpu_torch.train import data

    root = ROOT / "build" / "chip_smoke_runs"
    raw, shards = root / "raw_cache", root / "windowed_cache"
    L = 8 * FPS
    lengths = {"train": [480, 600, 384], "val": [336]}
    for seed, (split, lens) in enumerate(lengths.items()):
        feats, lats, noises = _raw_tracks(SEED + seed, lens)
        data.write_raw_cache(raw, split, feats, lats, noises, L, lens)
        cuts = np.cumsum([0] + lens)
        shards.mkdir(parents=True, exist_ok=True)
        for name, a in zip(["features", "latents"] + [f"noise{s}" for s in (4, 8, 16, 32)], [feats, lats, *noises]):
            np.save(shards / f"{split}_{name}.npy",
                    np.concatenate([data.overlapping_slices(a[lo:hi], L) for lo, hi in zip(cuts, cuts[1:])]))
    mean, std = data.compute_stats(_raw_tracks(SEED, lengths["train"])[0])
    for d in (raw, shards):
        np.save(d / "train_mean.npy", mean)
        np.save(d / "train_std.npy", std)
    ds_raw, ds_shards = data.load_cached(raw, "train"), data.load_cached(shards, "train")
    if not isinstance(ds_raw, data.MmapWindowDataset) or len(ds_raw) != len(ds_shards) != 21:
        fail(f"raw cache: {type(ds_raw).__name__} of {len(ds_raw)} windows, shards {len(ds_shards)}")
    t0 = time.perf_counter()
    first = next(ds_raw.batches_from(ds_raw.index_batches(32, seed=42)))
    gather_s = time.perf_counter() - t0
    want = next(ds_shards.batches_from(ds_shards.index_batches(32, seed=42)))
    if not all(np.array_equal(a, b) for a, b in zip(first, want)):
        fail("raw cache: the first batch differs from the windowed shards' for the same starts")
    if not all(torch.equal(torch.as_tensor(a).to(dev).cpu(), torch.as_tensor(a)) for a in first):
        fail("raw cache: a batch changed on its way to the card")
    log(f"[checkpoint] raw cache: {len(ds_raw)} train windows from {len(lengths['train'])} tracks; the first batch "
        f"of 32 equals the windowed shards' ({sum(a.nbytes for a in first) / 1e6:.1f} MB gathered in "
        f"{gather_s * 1e3:.1f} ms by the native loader)")

    _zero_counts()
    steps, B = 4, 32
    flags = TRAIN_FLAGS + ["--cache_dir", str(raw), "--eval_every", str((steps - 1) * B), "--no-render_at_ckpt"]
    log_dir, _ = run_trainer(flags, steps, "sashimi/fixed/ssabsdiff on the raw cache")
    counts = _counts()
    n_val, evals = 4, 2   # one wrap-padded val batch an eval; evals at the first and the last step
    # a step: 5 absdiff, one forward and one backward Vandermonde a layer; an eval batch: 5 absdiff and the
    # forward; each eval's diagnostics: one more forward
    _expect("train.main on the raw cache", counts, absdiff=5 * (steps + evals), s4d_vandermonde=4 * (steps + 2 * evals),
            s4d_vandermonde_bwd=4 * steps)
    if len(ds_raw.starts) != 21 or n_val != len(data.load_cached(raw, "val")):
        fail("raw cache: unexpected window counts")
    pngs = sorted(p.name for p in log_dir.glob("diagnostics_*.png"))
    if optional_packages()["matplotlib"]:
        if pngs != ["diagnostics_00000000.png", f"diagnostics_{(steps - 1) * B:08d}.png"]:
            fail(f"diagnostics: {pngs}")
        log(f"[checkpoint] diagnostics written at each eval: {pngs}")
    else:
        log("[checkpoint] diagnostics skipped: matplotlib is not installed here (the trainer says so and goes on)")
    return counts


def checkpoint_path(dev, log_dir: Path, feats: torch.Tensor) -> dict:
    """Phase 19: phase 6's run loaded back, a long-form render and split
    renders through it, the feature sensitivity, and training on the raw
    streaming cache; each path's launches checked exactly."""
    from ssar_tpu_torch.gan.stylegan2 import StyleGAN2Config
    from ssar_tpu_torch.generate.audio2video import react
    from ssar_tpu_torch.train import evaluate, train as trainer
    from ssar_tpu_torch.train.data import synthetic_dataset

    log(f"[checkpoint] optional packages on this machine: {optional_packages()}")
    total = {}
    args = trainer.build_parser().parse_args(TRAIN_FLAGS)
    trained = trainer.make_model(args, np.zeros(59, np.float32), np.ones(59, np.float32),
                                 np.zeros((args.n_latent_split * args.hidden_size, 18, 512), np.float32))
    trained.load_state_dict(_ckpt_params(trainer._latest_checkpoint(log_dir)))
    trained = trained.to(dev).eval()
    _zero_counts()
    t0 = time.perf_counter()
    model, cfg = evaluate.load_checkpoint(str(log_dir), device=dev)
    load_s = time.perf_counter() - t0
    (lat_a, noise_a), (lat_b, noise_b) = (react(m, feats, torch.Generator(dev).manual_seed(SEED + 4))
                                          for m in (trained, model))
    if not (torch.equal(lat_a, lat_b) and all(torch.equal(a, b) for a, b in zip(noise_a, noise_b))):
        fail("load_checkpoint: the loaded reactor's output differs from the trained one's")
    if model.envelopes.backbone.__class__ is not trained.envelopes.backbone.__class__ or cfg is not None:
        fail("load_checkpoint: another model than the run's")
    _expect("the loaded and the trained reactor on phase 4's features", _counts(), s4d_vandermonde=2 * args.num_layers)
    _add(total, _counts())
    log(f"[checkpoint] load_checkpoint of phase 6's run in {load_s:.3f} s: its forward on phase 4's features equals "
        f"the trained model's bit for bit (latents {tuple(lat_b.shape)}, {len(noise_b)} noise maps)")

    sr = 44100
    track = synthetic_track(sr, PATCH_SECONDS, section_seconds=8)
    T = PATCH_SECONDS * FPS
    sink = FrameSink((1536, 1024))
    _zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    evaluate.generate_longform(str(log_dir), track, sr, gan_config=StyleGAN2Config(), output_size=(1024, 1024),
                               batch_size=16, device=dev, writer=sink)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    if len(sink.crcs) != T or len(set(sink.crcs)) < T // 2 or not (16 <= sink.y_range[0] <= sink.y_range[1] <= 235):
        fail(f"generate_longform: {len(sink.crcs)} frames (expected {T}), {len(set(sink.crcs))} distinct, "
             f"luma {sink.y_range}")
    _expect("generate_longform", _counts(), sliding_median=4, s4d_vandermonde=args.num_layers)
    _add(total, _counts())
    log(f"[checkpoint] generate_longform: {PATCH_SECONDS} s @ 44.1 kHz -> {T} I420 frames 1024x1024 (bf16, batch 16, "
        f"the synthesizer built inside) in {long_s:.3f} s = {T / long_s:.2f} fps, {PATCH_SECONDS / long_s:.2f}x "
        f"realtime; peak memory {_peak_gib():.2f} GiB")

    _zero_counts()
    t0 = time.perf_counter()
    writers = evaluate.generate_by_data_split(str(log_dir), synthetic_dataset(n_windows=2, n_frames=8 * FPS),
                                              str(ROOT / "build" / "chip_smoke_runs" / "split"), device=dev)
    split_s = time.perf_counter() - t0
    if [w.frames_written for w in writers] != [8 * FPS] * 2:
        fail(f"generate_by_data_split: {[w.frames_written for w in writers]} frames")
    _expect("generate_by_data_split", _counts(), s4d_vandermonde=2 * args.num_layers)
    _add(total, _counts())
    log(f"[checkpoint] generate_by_data_split: 2 windows of {8 * FPS} frames at 256 px to mp4 in {split_s:.3f} s")

    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sens = evaluate.feature_sensitivity(model, feats)
    sens_s = time.perf_counter() - t0
    F = feats.shape[1]
    if len(sens) != F * 4 or not all(math.isfinite(v) and v >= 0 for v in sens.values()):
        fail(f"feature_sensitivity: {len(sens)} values")
    _expect("feature_sensitivity", _counts(), s4d_vandermonde=(1 + 4 * F) * args.num_layers)
    _add(total, _counts())
    top = sorted(sens.items(), key=lambda kv: -kv[1])[:3]
    log(f"[checkpoint] feature_sensitivity: {feats.shape[0]} frames x {F} features x 4 perturbations = {1 + 4 * F} "
        f"forwards in {sens_s:.3f} s ({sens_s / (1 + 4 * F) * 1e3:.2f} ms a forward, one read at the end); largest "
        f"{[(f'{k[0]}/{k[1]}', round(v, 5)) for k, v in top]}")

    _add(total, raw_cache_run(dev))
    return total


def _study_tracks():
    return [(f"clip{i}", synthetic_track(STUDY_SR, STUDY_SECONDS, section_seconds=None if i == 0 else 4.0), STUDY_SR)
            for i in range(STUDY_CLIPS)]


@contextlib.contextmanager
def _timed_resize(acc: list):
    """The comparison's low-resolution resize, synchronised and timed into `acc`."""
    from ssar_tpu_torch.metrics import comparison

    saved = comparison.resize

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = saved(*a, **kw)
        torch.cuda.synchronize()
        acc.append(time.perf_counter() - t0)
        return out

    comparison.resize = timed
    try:
        yield
    finally:
        comparison.resize = saved


def study_path(dev, log_dir: Path) -> dict:
    """Phase 20: scripts/run_study.py's configuration on the card (a 256 px G
    with random weights, 16 s clips cut from 6 to 2): the battery and the
    forward-only pass of four predictors, the scorer's calibration on the four
    recipes, the AV feature study and its report, the OOD of a rendered clip
    against the generator through a discriminator's features, and the
    preliminary study on the study's features; every record present and
    finite, launches exact."""
    import shutil

    from ssar_tpu_torch.gan.discriminator import Discriminator
    from ssar_tpu_torch.gan.stylegan2 import StyleGAN2Config
    from ssar_tpu_torch.gan.wrapper import StyleGAN2
    from ssar_tpu_torch.metrics import comparison, generate, ood, preliminary, study
    from ssar_tpu_torch.ops.resize import resize
    from ssar_tpu_torch.train import evaluate
    from ssar_tpu_torch.train.losses import audio_reactive_loss

    out = ROOT / "build" / "chip_smoke_runs" / "study"
    shutil.rmtree(out, ignore_errors=True)
    total = {}
    G = StyleGAN2(output_size=(256, 256), config=StyleGAN2Config(resolution=256, max_channels=512), seed=SEED,
                  device=dev)
    clips = _study_tracks()
    reactor, _ = evaluate.load_checkpoint(str(log_dir), device=dev)
    models = {"random_patch": comparison.RandomGenerator(G, fps=FPS, seed=0),
              "sashimi_ssabsdiff": comparison.SupervisedSequenceModel(reactor, fps=FPS, G=G),
              "ssopt": comparison.SelfSupervisedOptimization(fps=FPS, gan_config=G.config, device=dev),
              "lucid": comparison.LucidSonicBaseline(G, fps=FPS)}
    T = STUDY_SECONDS * FPS

    resize_s = []
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _timed_resize(resize_s):
        records = comparison.compare_models("study", models, clips, G, out_dir=str(out))
    battery_s = time.perf_counter() - t0
    got = sorted((r["clip"], r["model_name"]) for r in records)
    if got != sorted((c, m) for c, _, _ in clips for m in models):
        fail(f"compare_models: records for {got}, expected every (clip, model) pair")
    for r in records:
        bad = [k for k, v in r.items() if isinstance(v, float) and not math.isfinite(v)]
        if bad or len(r) != 1 + 9 * 12 + 3 + 3:
            fail(f"compare_models {r['clip']}/{r['model_name']}: {len(r)} entries, non-finite {bad[:5]}")
    n = len(clips)
    _expect("the study's battery", _counts(), sliding_median=n * sum(PREDICT_B1[m] + SCORE_B1 for m in models),
            absdiff=n * len(models) * SCORE_B2, s4d_vandermonde=n * 4)
    _add(total, _counts())
    log(f"[study] battery: {len(records)} records ({n} clips x {len(models)} models, {T} frames each, 256 px rendered, "
        f"128 px scored) in {battery_s:.1f} s; peak memory {_peak_gib():.2f} GiB; the low-resolution resize "
        f"{sum(resize_s):.3f} s over {len(resize_s)} batches")
    for r in records:
        log(f"[study]   {r['clip']}/{r['model_name']}: correlation {r['correlation']:.4f}, latent correlation "
            f"{r['latent_correlation']:.4f}, mean latent step {r['mean_latent_step']:.4f}, pixel step "
            f"{r['mean_pixel_step']:.4f}; {r['wall_s']} s")
    log(f"[study] random patch music information: {models['random_patch'].mir_seconds} s a clip; ssopt losses "
        f"{[round(c[0], 3) for c in models['ssopt'].loss_curves]} -> {[round(c[-1], 3) for c in models['ssopt'].loss_curves]}")

    _zero_counts()
    t0 = time.perf_counter()
    speed = comparison.compare_models("runtimes", models, clips, G, out_dir=str(out), forward_only=True)
    if len(speed) != n * len(models) or not all(r["time"] > 0 for r in speed):
        fail(f"forward-only pass: {len(speed)} records")
    _expect("the forward-only pass", _counts(),
            sliding_median=n * sum(b for m, b in PREDICT_B1.items() if m != "random_patch"), s4d_vandermonde=n * 4)
    _add(total, _counts())
    log(f"[study] forward only ({time.perf_counter() - t0:.1f} s): " + ", ".join(
        f"{r['clip']}/{r['model_name']} {r['n'] / r['time']:.1f} frames/s" for r in speed))

    # the scorer's calibration on the first clip: the four recipes at 256 px, resized to 128 as run_study does,
    # scored with the study's features (also the AV study's pairs)
    clip_name, audio, sr = clips[0]
    cache = out / "features"
    pairs, calib = [], {}
    _zero_counts()
    t0 = time.perf_counter()
    for recipe in generate.CORRELATION_RECIPES:
        video = generate.render_correlation_clip(recipe, audio, sr, G, fps=FPS, seed=7)
        video128 = resize(video.permute(0, 2, 3, 1), (video.shape[0], 128, 128, 3), method="bilinear")
        video128 = video128.permute(0, 3, 1, 2)
        afeats, vfeats = study.extract_av_features(audio, sr, video128, cache_stem=str(cache / recipe), device=dev)
        a = {k: v[None] for k, v in afeats.items()}
        v = {k: f[None] for k, f in vfeats.items()}
        rec = {"overall": float(1 - audio_reactive_loss(a, v)[0])}
        rec["chroma_channel"] = float(np.mean([float(1 - audio_reactive_loss([a[an]], [v[vn]])[0])
                                               for an in ("chromagram", "tonnetz") for vn in ("rgb_hist", "hsv_hist")]))
        calib[recipe] = rec
        pairs.append((recipe, audio, sr, video128))
    _expect("the calibration", _counts(), sliding_median=sum(RECIPE_B1.values()) + 4 * SCORE_B1, absdiff=4 * SCORE_B2)
    _add(total, _counts())
    if not all(math.isfinite(x) for r in calib.values() for x in r.values()):
        fail(f"calibration: {calib}")
    log(f"[study] calibration ({time.perf_counter() - t0:.1f} s): " + ", ".join(
        f"{k} overall {r['overall']:.4f} chroma {r['chroma_channel']:.4f}" for k, r in calib.items()))

    _zero_counts()
    t0 = time.perf_counter()
    plots = optional_packages()["matplotlib"]   # the report is figures: written where matplotlib is installed
    av = study.av_feature_study(pairs, out_dir=str(out / "report") if plots else None,
                                groups={r: r for r, *_ in pairs}, cache_dir=str(cache), device=dev)
    _expect("av_feature_study (its features cached)", _counts())
    if len(av) != 4 * len(study.STUDY_MEASURES) * (9 * 12 + 1) or not all(math.isfinite(r["value"]) for r in av):
        fail(f"av_feature_study: {len(av)} records, non-finite {sum(not math.isfinite(r['value']) for r in av)}")
    stats, best = study.group_stats(av), study.extrema(av, n=1)
    if len(stats) != 4 * len(study.STUDY_MEASURES) * (9 * 12 + 1) or len(best) != 4:
        fail(f"av_feature_study statistics: {len(stats)} cells, extrema of {len(best)} groups")
    report = sorted(p.name for p in (out / "report").iterdir()) if plots else "skipped: matplotlib is not installed"
    log(f"[study] av_feature_study: {len(av)} records in {time.perf_counter() - t0:.1f} s; concat procrustes by "
        f"recipe {[(g, round(d['best'][0][0], 4)) for g, d in best.items()]}; report {report}")

    torch.manual_seed(SEED)
    D = Discriminator(resolution=128, channel_multiplier=1).to(dev)
    t0 = time.perf_counter()
    scores = ood.video_vs_generator(pairs[0][3], G, n_samples=256, extractor=ood.discriminator_extractor(D))
    if not all(math.isfinite(v) for v in scores.values()):
        fail(f"video_vs_generator: {scores}")
    log(f"[study] video_vs_generator (256 samples, a random 128 px discriminator's features) in "
        f"{time.perf_counter() - t0:.1f} s: " + ", ".join(f"{k} {v:.4g}" for k, v in scores.items()))

    feats = [study.extract_av_features(audio, sr, p[3], cache_stem=str(cache / p[0]), device=dev) for p in pairs]
    groups = {"calibration": {"video_spectrogram": torch.stack([v["video_spectrogram"] for _, v in feats]),
                              "audio_feat": torch.stack([a["mfcc"] for a, _ in feats]),
                              "audio_chroma": torch.stack([a["chromagram"] for a, _ in feats]),
                              "video_onsets": torch.stack([v["video_flow_onsets"][:, 0] for _, v in feats]),
                              "audio_onsets": torch.stack([a["onsets"][:, 0] for a, _ in feats])}}
    groups = {g: {c: v.cpu().numpy() for c, v in cols.items()} for g, cols in groups.items()}
    t0 = time.perf_counter()
    aligned, misaligned = preliminary.preliminary_study(groups, ["video_spectrogram"], ["audio_feat"], n_samples=4,
                                                        out_dir=str(out / "preliminary"), device=dev)
    rows = aligned + misaligned
    if len(rows) != 2 or not all(math.isfinite(v) for r in rows for k, v in r.items() if k != "group"):
        fail(f"preliminary_study: {rows}")
    log(f"[study] preliminary_study ({time.perf_counter() - t0:.1f} s): aligned "
        + ", ".join(f"{k} {v:.4g}" for k, v in aligned[0].items() if k != "group"))
    return total


def reference_study(dev):
    """Phase 21: the checkpoint and comparison paths at a small size in float32
    (a 64 px G, a 4 s clip) on the card and on the CPU, with the same weights
    and draws: each predictor's latents within 1e-3 of their largest
    magnitude and its ``evaluate_clip`` record within 2e-3 absolute.  The
    optimizer runs 0 steps here (its set-up, envelopes and decoder): Adam's
    first step moves every coefficient by +-lr with the sign of its
    gradient, which round-off decides for the smallest ones (its latents
    moved 7.5e-3 apart after 2 steps; its step is phase 10's check), and its
    record is held complete and finite only (the optimizer's nearly static
    video makes the correlation magnify round-off).  ``feature_sensitivity``
    within 1e-4 of its largest delta, ``ood.compute`` with the default extractor
    within 1e-4 relative, one calibration recipe's frames within 1e-3."""
    import types

    from ssar_tpu_torch.gan.stylegan2 import StyleGAN2Config
    from ssar_tpu_torch.gan.wrapper import StyleGAN2Mapper, StyleGAN2Synthesizer
    from ssar_tpu_torch.generate import mir
    from ssar_tpu_torch.metrics import comparison, generate, ood
    from ssar_tpu_torch.models.reactor import LatentNoiseReactor
    from ssar_tpu_torch.train import evaluate
    from ssar_tpu_torch.utils.device import full_precision

    sr = 1024 * FPS
    audio = two_part_track(sr, 4.0)
    T = len(audio) // 1024
    cfg = StyleGAN2Config(resolution=64, max_channels=64)
    weights = StyleGAN2Mapper(config=cfg, seed=SEED, device="cpu").params

    def small_g(device, params):
        mapper = StyleGAN2Mapper(config=cfg, device=device)
        mapper.params = params
        return types.SimpleNamespace(config=cfg, mapper=mapper, synthesizer=StyleGAN2Synthesizer(
            config=cfg, dtype=torch.float32, device=device, params=params))

    G_cpu, G_card = small_g(torch.device("cpu"), weights), small_g(dev, _to(weights, dev))
    music = mir.retrieve_music_information(audio, sr, device="cpu")
    torch.manual_seed(SEED)
    palette = np.random.RandomState(SEED).randn(3 * 8, cfg.n_latent, 512).astype(np.float32)
    # the fixed decoder divides each split's envelopes by their sum, which magnifies round-off near a sum of 0
    # (ROADMAP C): the guard keeps |sum| >= 0.1 and the palette envelopes' biases are lifted, as the CPU tests do
    reactor = LatentNoiseReactor(np.zeros(59), np.ones(59), palette, backbone="sashimi", hidden_size=8, num_layers=2,
                                 env_guard_eps=0.1)
    with torch.no_grad():
        reactor.envelopes.out.bias[: 3 * 8] += 1.0
    rs = np.random.RandomState(SEED + 11)
    base = [rs.randn(1, T, 2 ** (i + 2), 2 ** (i + 2)).astype(np.float32) for i in range(4)]
    opt_init = rs.rand(T, 27 + 10).astype(np.float32)
    opt_draws = {2 ** (i + 2): rs.randn(T, 2 ** (i + 2), 2 ** (i + 2)).astype(np.float32) for i in range(5)}

    def predictors(G, device):
        model = LatentNoiseReactor(np.zeros(59), np.ones(59), palette, backbone="sashimi", hidden_size=8,
                                   num_layers=2, env_guard_eps=0.1)
        model.load_state_dict(reactor.state_dict())
        model = model.to(device)
        fixed_base = [torch.as_tensor(b, device=device) for b in base]
        model.decoder.forward = lambda x, base_noise=None, generator=None, _f=model.decoder.forward: _f(
            x, base_noise=fixed_base)
        patch = comparison.RandomGenerator(G, fps=FPS, seed=3)
        patch._mir = lambda a, s: (_to(music[0], device), {k: v.to(device) for k, v in music[1].items()}, music[2])
        return {"random_patch": patch, "reactor": comparison.SupervisedSequenceModel(model, fps=FPS),
                "ssopt": comparison.SelfSupervisedOptimization(fps=FPS, n_steps=0, gan_config=cfg, device=device),
                "lucid": comparison.LucidSonicBaseline(G, fps=FPS)}

    class Kept:
        """A predictor that keeps its last prediction's latents."""

        def __init__(self, predictor):
            self.predictor, self.latents = predictor, None

        def predict(self, audio_, sr_):
            latents, noise = self.predictor.predict(audio_, sr_)
            self.latents = torch.as_tensor(latents).cpu()
            return latents, noise

    records, latents = {}, {}
    with _banks_from_the_cpu(), full_precision(), _injected_draws(opt_init, opt_draws):
        for tag, device, G in (("card", dev, G_card), ("cpu", torch.device("cpu"), G_cpu)):
            kept = {name: Kept(p) for name, p in predictors(G, device).items()}
            records[tag] = {name: comparison.evaluate_clip(G, p, audio, sr) for name, p in kept.items()}
            latents[tag] = {name: p.latents for name, p in kept.items()}
        worst = {}
        for name, want in records["cpu"].items():
            got = records["card"][name]
            if got.keys() != want.keys() or not all(math.isfinite(v) for v in got.values()):
                fail(f"evaluate_clip on the card ({name}): {len(got)} entries, not all finite")
            lat_err = float((latents["card"][name] - latents["cpu"][name]).abs().max()
                            / latents["cpu"][name].abs().max())
            err = max(abs(got[k] - want[k]) for k in want)
            worst[name] = (lat_err, err)
            # the optimizer's video barely moves (mean pixel step ~2e-3 in phase 20), and the procrustes
            # correlation of near-constant features magnifies its latents' round-off: its latents are held
            if not (lat_err <= 1e-3 and (name == "ssopt" or err <= 2e-3)):
                fail(f"evaluate_clip card vs CPU ({name}): latents {lat_err:.3g} of their largest magnitude, "
                     f"a score {err:.3g}")

        feats = torch.as_tensor(np.random.RandomState(SEED + 12).randn(T, 59).astype(np.float32))
        sens = [np.array(list(evaluate.feature_sensitivity(predictors(G_cpu, device)["reactor"].model, feats).values()))
                for device in (dev, torch.device("cpu"))]
        sens_err = float(np.abs(sens[0] - sens[1]).max() / np.abs(sens[1]).max())
        if not sens_err <= 1e-4:
            fail(f"feature_sensitivity card vs CPU: {sens_err:.3g} of the largest delta")

        rs = np.random.RandomState(SEED + 13)
        real, fake = rs.rand(24, 3, 64, 64).astype(np.float32), rs.rand(24, 64, 64, 3).astype(np.float32) ** 2
        o_card = ood.compute(real, fake, allow_random_extractor=True, device=dev)
        o_cpu = ood.compute(real, fake, allow_random_extractor=True, device="cpu")
        ood_err = max(abs(o_card[k] - o_cpu[k]) / max(abs(o_cpu[k]), 1e-12) for k in o_cpu)
        if not ood_err <= 1e-4:
            fail(f"ood.compute card vs CPU: {o_card} vs {o_cpu}")

        clip_card = generate.render_correlation_clip("high_both", audio, sr, G_card, fps=FPS, seed=7).cpu()
        clip_cpu = generate.render_correlation_clip("high_both", audio, sr, G_cpu, fps=FPS, seed=7)
        clip_err = float((clip_card - clip_cpu).abs().max())
        if not clip_err <= 1e-3:
            fail(f"render_correlation_clip card vs CPU: {clip_err:.3g}")
    log(f"[reference] comparison card vs CPU (64 px, 4 s, fp32): evaluate_clip latents / worst score error "
        + ", ".join(f"{k} {v[0]:.3g} / {v[1]:.3g}" for k, v in worst.items())
        + f"; feature_sensitivity {sens_err:.3g}; ood.compute {ood_err:.3g}; high_both recipe frames {clip_err:.3g}")


# ------------------------------------------------------------------ 22-23 --
# the parity CLI's B1 launches, derived from the code: of its ten rows only chroma and tonnetz separate harmonic
# from percussive (one HPSS, two filters, a call), in the warm-up call, in each of its --trials timed calls and in
# the gradient's forward; the gradient's backward launches B1 bwd twice a row
PARITY_TRIALS = 5
PARITY_B1, PARITY_B1_BWD = 2 * 2 * (1 + PARITY_TRIALS + 1), 2 * 2
SWAV_BATCH, PSP_BATCH, PSP_STYLES = 32, 16, 18
PSP_BATCHES = (8, 16, 32)
# phase 23's tolerances, card against CPU in fp32: the networks' outputs within 1e-4 of the largest CPU value;
# hpcp and raw_hpcp too, but a frame may exceed it where a peak's bin decision (a rounding to the nearest
# constant-Q bin, a pitch-class window's edge) flips on an ulp of the spectrum: at most 2 % of the frames
REF_RTOL, REF_FLIP_SHARE = 1e-4, 0.02


def _finite(name: str, x: torch.Tensor, shape: tuple):
    if tuple(x.shape) != tuple(shape) or not bool(torch.isfinite(x).all()):
        fail(f"{name}: {tuple(x.shape)} (expected {tuple(shape)}), finite={bool(torch.isfinite(x).all())}")


def extractors_path(dev, eval_frames: dict, clip_audio: np.ndarray, synthesizer, config) -> tuple[dict, list]:
    """Phase 22: the twelfth slice's modules at full width on the card, each
    stage timed with ``utils.profiling.StageTimer`` and its peak memory read:
    the 2-D median helpers on phase 11's track's |STFT| (1025, 1441), k = 31,
    bit-equal to the plain version; ``video_absdiff`` on phase 13's prepared
    frames against ``absdiff_plain``; hpcp, raw_hpcp, tempogram_ratio on
    phase 11's track; the parity CLI at 8 s; a full-width ResNet-50 through
    ``swav_extractor`` (224 px, batch 32) into ``ood.compute``; an IR-SE50
    GradualStyleEncoder (18 x 512, a latent_avg from the decoder's mapping)
    through ``invert_frames`` (batch 16, traced once), ``psp_apply`` through
    phase 4's 1024 px decoder with and without a latent_mask, and
    ``autotune`` over the inversion's batch size; SlowFast R50 at
    ``SlowFastConfig()`` over phase 4's clip at 256 px; ``synchro_saliency``
    on phase 4's track and clip.  Random weights drawn on the card from the
    seed.  B1 / B1 bwd / B2 launches checked exactly at each stage; returns
    the phase's launch counts and the new call sites' kernel rows."""
    import contextlib
    import io

    from ssar_tpu_torch.audio import parity
    from ssar_tpu_torch.audio.extra import hpcp, raw_hpcp, tempogram_ratio
    from ssar_tpu_torch.audio.spectral import stft
    from ssar_tpu_torch.gan.psp import GradualStyleEncoder, IR_STAGES, invert_frames, psp_apply
    from ssar_tpu_torch.gan.stylegan2 import mapping
    from ssar_tpu_torch.generate import sample
    from ssar_tpu_torch.metrics.ood import compute
    from ssar_tpu_torch.models.extractors import synchro_saliency
    from ssar_tpu_torch.models.resnet import ResNet50, swav_extractor
    from ssar_tpu_torch.models.slowfast_r50 import SlowFastConfig, SlowFastR50, SlowFastR50Extractor
    from ssar_tpu_torch.ops.absdiff import absdiff_plain, video_absdiff
    from ssar_tpu_torch.ops.median import median_filter2d_freq, median_filter2d_time, median_filter_plain
    from ssar_tpu_torch.utils.profiling import StageTimer, autotune, trace

    timer, peaks, total = StageTimer(), {}, {}

    @contextlib.contextmanager
    def measured(name: str, **launches):
        """Time a stage (the device synchronised around it), read its peak
        memory, and check its kernel launches exactly."""
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        with timer.stage(name):
            yield
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        counts = _counts()
        _expect(f"phase 22 {name}", counts, **launches)
        _add(total, counts)

    def seconds(name: str) -> float:
        return timer.records[name][-1]

    # the 2-D median helpers on phase 11's track's |STFT|, and video_absdiff on phase 13's frames
    audio60, sr = sample.load_audio(str(ROOT / "build" / "chip_smoke_runs" / "patch" / "patch_track.wav"), 0, None, FPS)
    a60 = torch.as_tensor(audio60, device=dev)
    S = stft(a60).abs()
    _finite("|STFT| of phase 11's track", S, (1025, PATCH_FRAMES))
    median_filter2d_freq(S), median_filter2d_time(S)   # warm-up: the kernel library is loaded
    with measured("median_filter2d", sliding_median=2):
        m_freq, m_time = median_filter2d_freq(S), median_filter2d_time(S)
    if not (torch.equal(m_freq, median_filter_plain(S, 31, 0)) and torch.equal(m_time, median_filter_plain(S, 31, 1))):
        fail("median_filter2d_freq / _time differ from median_filter_plain on the card")
    video60 = eval_frames["video60"].to(dev)
    T60, E60 = video60.shape[0], video60[0].numel()
    with measured("video_absdiff", absdiff=1):
        env = video_absdiff(video60)
    ok, ad_err = within(env[:, 0], absdiff_plain(video60), 1e-5, 0.0)
    if not ok or tuple(env.shape) != (T60, 1):
        fail(f"video_absdiff {tuple(env.shape)} differs from absdiff_plain by {ad_err:.3g} (rtol 1e-5)")

    # the new call sites' kernel rows, between the counted stages.  Device times from CUDA-graph replays
    # (graph_ms): at this point of the script torch.profiler hands back no device events for these calls
    # (five traces in a row).  |STFT| is a transposed view that the wrapper copies contiguous
    # before the kernel: the call site's device time is the copy and the kernel, the contiguous input's the
    # kernel's alone
    rows = []
    Sc = S.contiguous()
    for site, x in (("", S), (", contiguous input", Sc)):
        for name, fn, axis in (("median_filter2d_freq", median_filter2d_freq, 0),
                               ("median_filter2d_time", median_filter2d_time, 1)):
            rows.append({"site": name + site, "shape": list(x.shape), "ms": cuda_ms(lambda: fn(x)),
                         "dev_ms": graph_ms(lambda: fn(x)),
                         "plain_ms": cuda_ms(lambda: median_filter_plain(x, 31, axis), runs=5),
                         "bound_ms": median_bound_ms(x.numel(), 31)[0], "bound_by": "bytes"})
    ad_bound, ad_by = absdiff_bound_ms(1, T60, E60)
    rows.append({"site": "video_absdiff", "shape": [T60, E60], "ms": cuda_ms(lambda: video_absdiff(video60)),
                 "dev_ms": graph_ms(lambda: video_absdiff(video60)),
                 "plain_ms": cuda_ms(lambda: absdiff_plain(video60), runs=5), "bound_ms": ad_bound, "bound_by": ad_by})
    for r in rows:
        log(f"[extractors] {r['site']} {r['shape']}: call {r['ms']:.4f} ms, device (graph replays) "
            f"{r['dev_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")

    # audio extras and the parity CLI
    with measured("hpcp"):
        h = hpcp(a60, sr)
    with measured("raw_hpcp"):
        rh = raw_hpcp(a60, sr)
    with measured("tempogram_ratio"):
        tr = tempogram_ratio(a60, sr, 120.0)
    _finite("hpcp", h, (a60.shape[0] // 1024, 12))
    _finite("raw_hpcp", rh, (a60.shape[0] // 512, 12))
    _finite("tempogram_ratio", tr, (8,))
    out = io.StringIO()
    with measured("parity_cli", sliding_median=PARITY_B1, sliding_median_bwd=PARITY_B1_BWD), \
            contextlib.redirect_stdout(out):
        parity.main(["--seconds", "8", "--trials", str(PARITY_TRIALS)])
    table = out.getvalue()
    for line in table.splitlines():
        log(f"[extractors] parity | {line}")
    if "FAIL" in table:
        fail("the parity CLI could not take a gradient (FAIL) on the card")
    for row in ("rms", "melspec"):
        line = next(ln for ln in table.splitlines() if ln.startswith(row))
        if "shape" in line or not float(line.split("/")[-1]) < 1e-2:
            fail(f"parity CLI: the {row} row's oracle diff is not below 1e-2: {line}")

    # ResNet-50 through swav_extractor into the OOD metrics
    real = video60[:256].permute(0, 2, 3, 1)
    fake = eval_frames["clip256"].to(dev).permute(0, 2, 3, 1)
    torch.manual_seed(SEED)
    with torch.device(dev):
        resnet = ResNet50().eval()
    extract = swav_extractor(resnet, batch_size=SWAV_BATCH)
    extract(real[:SWAV_BATCH])
    with measured("swav_features"):
        f_real, f_fake = extract(real), extract(fake)
    _finite("swav features (real)", f_real, (real.shape[0], 2048))
    _finite("swav features (fake)", f_fake, (fake.shape[0], 2048))
    with measured("ood_compute"):
        ood = compute(real, fake, extractor=extract, device=dev)
    if not all(math.isfinite(v) for v in ood.values()):
        fail(f"ood.compute through swav_extractor: {ood}")
    n_img = real.shape[0] + fake.shape[0]

    # pSp: the IR-SE50 GradualStyleEncoder, inversion, psp_apply through the 1024 px decoder, autotune
    torch.manual_seed(SEED)
    with torch.device(dev):
        encoder = GradualStyleEncoder(IR_STAGES[50], PSP_STYLES, 512, 256).eval()
        z = torch.randn(4096, 512, generator=torch.Generator(dev).manual_seed(SEED), device=dev)
        latent_avg = mapping(synthesizer.params, z, config).mean(0).expand(PSP_STYLES, -1).contiguous()
    psp = {"encoder": encoder, "decoder": synthesizer.params, "latent_avg": latent_avg}
    clip = eval_frames["clip256"].to(dev).permute(0, 2, 3, 1) * 2 - 1   # (192, 256, 256, 3) in [-1, 1]
    invert_frames(psp, clip[:PSP_BATCH], batch_size=PSP_BATCH, device=dev)
    with measured("invert_frames"):
        w = invert_frames(psp, clip, batch_size=PSP_BATCH, device=dev)
    _finite("invert_frames", w, (clip.shape[0], PSP_STYLES, 512))
    trace_dir = ROOT / "build" / "chip_smoke_runs" / "psp_trace"
    with trace(str(trace_dir)):
        invert_frames(psp, clip, batch_size=PSP_BATCH, device=dev)
        torch.cuda.synchronize()
    traces = sorted(trace_dir.glob("trace-*.json"))
    if not traces or traces[-1].stat().st_size == 0:
        fail(f"utils.profiling.trace wrote no trace under {trace_dir}")
    with torch.no_grad():
        psp_apply(psp, clip[:PSP_BATCH], config)
        with measured("psp_apply"):
            frames, codes = psp_apply(psp, clip[:PSP_BATCH], config)
            frames_m, codes_m = psp_apply(psp, clip[:PSP_BATCH], config, latent_mask=[0, 1, 2, 3],
                                          inject_latent=w[PSP_BATCH : 2 * PSP_BATCH], alpha=0.5)
    side = min(config.resolution, 256)   # psp_apply pools frames larger than 256 px to 256
    for name, f, c in (("psp_apply", frames, codes), ("psp_apply with a latent_mask", frames_m, codes_m)):
        _finite(f"{name} frames", f, (PSP_BATCH, side, side, 3))
        _finite(f"{name} codes", c, (PSP_BATCH, PSP_STYLES, 512))
    mixed = 0.5 * w[PSP_BATCH : 2 * PSP_BATCH, :4] + 0.5 * codes[:, :4]
    if not (torch.equal(codes_m[:, 4:], codes[:, 4:]) and within(codes_m[:, :4], mixed, 1e-6, 1e-6)[0]):
        fail("psp_apply's style mixing: rows outside the mask changed or the masked rows are not the mix")
    with measured("autotune"):
        best, results = autotune(lambda batch_size: (lambda x: invert_frames(psp, x, batch_size=batch_size, device=dev)),
                                 [{"batch_size": b} for b in PSP_BATCHES], (clip,), iters=3, warmup=1, device=dev)
    if any("error" in r for r in results):
        fail(f"autotune over invert_frames' batch size: a configuration erred: {results}")

    # SlowFast R50 at the 8x8 R50 config over the clip, and synchro-saliency
    torch.manual_seed(SEED)
    with torch.device(dev):
        slowfast = SlowFastR50(SlowFastConfig()).eval()
    sf_ext = SlowFastR50Extractor(slowfast, device=dev)
    clip01 = eval_frames["clip256"].to(dev)
    sf_ext(clip01[:32])
    with measured("slowfast_r50"):
        sf_feats = sf_ext(clip01)
    for f, d in zip(sf_feats, [88, 352, 704, 1408, 2304]):
        _finite("SlowFastR50Extractor", f, (clip01.shape[0], d))
    if len(sf_feats) != 5:
        fail(f"SlowFastR50Extractor returned {len(sf_feats)} levels")
    with measured("synchro_saliency"):
        sal = synchro_saliency(clip_audio, 44100, clip01, FPS, seed=SEED, device=dev)
    n_audio = ((-(-len(clip_audio) * 160 // 441) - 400) // 160 + 1) // 96   # VGGish's 0.96 s examples at 16 kHz
    _finite("synchro_saliency", sal, (min(n_audio, clip01.shape[0] // 16),))
    if float(sal.abs().max()) > 1 + 1e-5:
        fail(f"synchro_saliency is a cosine but reached {float(sal.abs().max())}")

    log("[extractors] stages (s, peak GiB): " + ", ".join(f"{k} {seconds(k):.3f} / {peaks[k]:.2f}" for k in peaks))
    log(f"[extractors] swav_extractor: ResNet-50 at 224 px, batch {SWAV_BATCH}, {n_img} images ({real.shape[0]} of "
        f"phase 13's frames, phase 4's {fake.shape[0]} at 256 px) in {seconds('swav_features'):.3f} s = "
        f"{n_img / seconds('swav_features'):.1f} images/s; ood.compute {seconds('ood_compute'):.3f} s: "
        + ", ".join(f"{k} {v:.6g}" for k, v in ood.items()))
    log(f"[extractors] invert_frames: IR-SE50 GradualStyleEncoder ({PSP_STYLES} x 512) on {clip.shape[0]} frames at "
        f"256 px, batch {PSP_BATCH}: {seconds('invert_frames'):.3f} s = {clip.shape[0] / seconds('invert_frames'):.1f} "
        f"frames/s; psp_apply x 2 (1024 px decoder, fp32, {PSP_BATCH} frames) {seconds('psp_apply'):.3f} s; trace "
        f"{traces[-1].relative_to(ROOT)} ({traces[-1].stat().st_size / 1e6:.1f} MB); autotune "
        + ", ".join(f"batch {r['batch_size']} {r['time'] * 1e3:.1f} ms" for r in results) + f" -> {best}")
    log(f"[extractors] SlowFast R50 (SlowFastConfig(), clip_len 32) on {clip01.shape[0]} frames at 256 px: "
        f"{seconds('slowfast_r50'):.3f} s = {clip01.shape[0] / seconds('slowfast_r50'):.1f} frames/s, levels "
        f"{[tuple(f.shape) for f in sf_feats]}; synchro_saliency {seconds('synchro_saliency'):.3f} s, "
        f"{sal.shape[0]} windows, mean {float(sal.mean()):.4f}; hpcp {seconds('hpcp'):.3f} s, raw_hpcp "
        f"{seconds('raw_hpcp'):.3f} s, tempogram_ratio {seconds('tempogram_ratio'):.3f} s on 60 s; parity CLI "
        f"{seconds('parity_cli'):.3f} s; launches {total} (as derived)")

    return total, rows


def reference_extractors(dev):
    """Phase 23: the new modules card against CPU at small sizes in fp32, with
    the same weights (drawn on the CPU): ResNet-50 at full width on 64 px
    images, SlowFast R50 at the tests' TINY config, an IR-SE GradualStyleEncoder
    of four one-unit stages through psp_apply and a 64 px decoder (with a
    latent_mask), VGGish on 2 s at 16 kHz, SlowFastVideo on 32 frames at 32
    px; hpcp, raw_hpcp and tempogram_ratio on a 4 s track.  Tolerances:
    ``REF_RTOL``, ``REF_FLIP_SHARE``."""
    from ssar_tpu_torch.audio.extra import hpcp, raw_hpcp, tempogram_ratio
    from ssar_tpu_torch.gan.psp import init_random_params as psp_init
    from ssar_tpu_torch.gan.psp import psp_apply
    from ssar_tpu_torch.gan.stylegan2 import StyleGAN2Config, init_generator
    from ssar_tpu_torch.models import resnet, slowfast_r50
    from ssar_tpu_torch.models.extractors import (SlowFastExtractor, VggishExtractor, random_slowfast_video,
                                                  random_vggish)
    from ssar_tpu_torch.utils.device import full_precision

    rng = np.random.RandomState(SEED)
    errs, flips = {}, {}

    def held(name: str, card: torch.Tensor, cpu: torch.Tensor, flip_rows: bool = False):
        card = card.detach().cpu()
        if card.shape != cpu.shape:
            fail(f"phase 23 {name}: card {tuple(card.shape)} vs CPU {tuple(cpu.shape)}")
        scale = float(cpu.abs().max())
        err = (card - cpu).abs()
        errs[name] = float(err.max()) / scale
        if flip_rows:   # rows beyond the tolerance: a flipped bin decision
            n_flip = int((err.reshape(err.shape[0], -1).amax(1) > REF_RTOL * scale).sum())
            flips[name] = n_flip
            if n_flip > REF_FLIP_SHARE * err.shape[0]:
                fail(f"phase 23 {name}: {n_flip} of {err.shape[0]} frames beyond {REF_RTOL} of the largest value")
        elif not errs[name] <= REF_RTOL:
            fail(f"phase 23 {name}: card vs CPU {errs[name]:.3g} of the largest value > {REF_RTOL}")

    def both(module_cpu):
        return module_cpu, copy.deepcopy(module_cpu).to(dev)

    # ResNet-50 (the JAX package's random weights) on 64 px images
    r_cpu, r_card = both(resnet.init_random_params())
    x = torch.as_tensor(rng.rand(2, 64, 64, 3).astype(np.float32))
    held("resnet50", resnet.resnet50_features(r_card, x.to(dev)), resnet.resnet50_features(r_cpu, x))

    # SlowFast R50 at the tests' TINY config
    tiny = slowfast_r50.SlowFastConfig(alpha=4, beta_inv=4, width=8, depths=(1, 1, 1, 1), fusion_kernel=3,
                                       temp_kernels_slow=(1, 1, 3, 3), temp_kernels_fast=(3, 3, 3, 3))
    s_cpu, s_card = both(slowfast_r50.init_random_params(SEED, tiny))
    fast = torch.as_tensor(rng.rand(2, 3, 8, 32, 32).astype(np.float32) * 2 - 1)
    f_cpu = slowfast_r50.slowfast_features(s_cpu, fast[:, :, ::4], fast)
    f_card = slowfast_r50.slowfast_features(s_card, fast[:, :, ::4].to(dev), fast.to(dev))
    for i, (a, b) in enumerate(zip(f_card, f_cpu)):
        held(f"slowfast_r50 level {i}", a, b)

    # pSp: a four-stage IR-SE encoder through psp_apply and a 64 px decoder
    cfg = StyleGAN2Config(resolution=64, max_channels=64)
    stages = ((8, 8, 1), (8, 12, 1), (12, 16, 1), (16, 24, 1))
    enc_cpu, enc_card = both(psp_init(SEED, stages, cfg.n_latent, input_res=32))
    dec = init_generator(cfg, generator=torch.Generator().manual_seed(SEED))
    avg = torch.as_tensor(0.1 * rng.randn(cfg.n_latent, 512).astype(np.float32))
    p_cpu = {"encoder": enc_cpu, "decoder": dec, "latent_avg": avg}
    p_card = {"encoder": enc_card, "decoder": _to(dec, dev), "latent_avg": avg.to(dev)}
    imgs = torch.as_tensor(rng.rand(2, 32, 32, 3).astype(np.float32) * 2 - 1)
    inj = torch.as_tensor(rng.randn(2, cfg.n_latent, 512).astype(np.float32))
    for kw_name, kw in (("psp_apply", {}), ("psp_apply mixed", {"latent_mask": [0, 3], "alpha": 0.3})):
        with torch.no_grad(), full_precision():
            fc, cc = psp_apply(p_card, imgs.to(dev), cfg, inject_latent=inj.to(dev) if kw else None, **kw)
            fp, cp = psp_apply(p_cpu, imgs, cfg, inject_latent=inj if kw else None, **kw)
        held(f"{kw_name} codes", cc, cp)
        held(f"{kw_name} frames", fc, fp)

    # VGGish and SlowFastVideo through their extractors
    audio = rng.randn(32000).astype(np.float32) * 0.3
    vgg = random_vggish(SEED)
    held("VggishExtractor", VggishExtractor(copy.deepcopy(vgg), device=dev)(audio, 16000),
         VggishExtractor(vgg, device="cpu")(audio, 16000))
    sfv = random_slowfast_video(SEED)
    video = rng.rand(32, 3, 32, 32).astype(np.float32)
    held("SlowFastExtractor", SlowFastExtractor(copy.deepcopy(sfv), device=dev)(video),
         SlowFastExtractor(sfv, device="cpu")(video))

    # the audio extras on a 4 s track
    track = torch.as_tensor(synthetic_track(1024 * FPS, 4.0))
    sr = 1024 * FPS
    held("hpcp", hpcp(track.to(dev), sr), hpcp(track, sr), flip_rows=True)
    held("raw_hpcp", raw_hpcp(track.to(dev), sr), raw_hpcp(track, sr), flip_rows=True)
    held("tempogram_ratio", tempogram_ratio(track.to(dev), sr, 120.0), tempogram_ratio(track, sr, 120.0))
    log("[reference] extractors card vs CPU (fp32), max error / largest value: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f"; frames beyond {REF_RTOL} (flipped bins) {flips}")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


if __name__ == "__main__":
    main()
