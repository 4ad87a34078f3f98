"""Drive the PyTorch port's serve path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA source of the port, compiled with nvcc in parallel;
  3. kernel check: the sliding-median kernel against its plain PyTorch
     version (torch.equal) at the serve path's and a 3-minute track's shapes,
     batched and awkward shapes, and its time beside the plain version's;
  4. main path: a synthetic 8 s track at 44.1 kHz -> audio2features (192, 59)
     -> GRU LatentNoiseReactor (hidden 32, 4 layers, random (96, 18, 512)
     palette) -> 1024 px StyleGAN2 (random weights from the seed, bf16) ->
     192 I420 frames into an in-memory sink; kernel launch counts are read
     around this run only;
  5. reference checks: the card's features and synthesis against the same
     code on the CPU (plain median) at a small size.
It prints one JSON line describing the kernels, then the nvidia-smi line,
then {"ok": true, "device": {...}} as the last line.
"""
from __future__ import annotations

import concurrent.futures
import json
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

SEED = 0
FPS = 24
FP32_PEAK_OPS = 67e12   # H100 SXM fp32 outside the tensor cores (data sheet)
HBM_BYTES_PER_S = 3.35e12


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


def median_bound_ms(numel: int, k: int) -> tuple[float, str]:
    """Least time for one sliding median: each input read and output written
    once (fp32), and the odd-even network's k(k-1)/2 compare-exchanges of two
    fp32 min/max each per output, at the published peaks."""
    t_bytes = 2 * 4 * numel / HBM_BYTES_PER_S * 1e3
    t_ops = numel * k * (k - 1) / FP32_PEAK_OPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def synthetic_track(sr: int, seconds: float) -> np.ndarray:
    """Chirp-modulated tone + noise + clicks every half second."""
    t = np.arange(int(sr * seconds)) / sr
    rng = np.random.RandomState(SEED)
    audio = (0.4 * np.sin(2 * np.pi * 220 * t * (1 + 0.05 * np.sin(2 * np.pi * t / 7)))
             + 0.1 * rng.randn(len(t))).astype(np.float32)
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
    from ssar_tpu_torch.ops.median import median_filter, median_filter_plain
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

    # ---------------------------------------------------------------- 3 --
    g = torch.Generator(device=dev).manual_seed(SEED)
    checks = [((1025, 193), 31), ((1025, 192), 31), ((1025, 4320), 31), ((4, 1025, 4320), 31),
              ((1000, 100), 31), ((37, 16), 31), ((3, 53, 77), 7), ((53, 77), 9), ((130, 70), 9)]
    max_err, rows = 0.0, []
    for shape, k in checks:
        x = torch.rand(shape, generator=g, device=dev)
        for axis in (-1, -2):
            if x.shape[axis] <= k // 2:
                continue
            got = median_filter(x, k, axis)
            want = median_filter_plain(x, k, axis)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"sliding median differs from the plain version at {shape}, k={k}, axis={axis}")
            max_err = max(max_err, float((got - want).abs().max()))
            if k == 31 and shape in ((1025, 193), (1025, 192), (1025, 4320), (4, 1025, 4320)):
                ms = cuda_ms(lambda: median_filter(x, k, axis))
                plain = cuda_ms(lambda: median_filter_plain(x, k, axis), runs=20)
                bound, by = median_bound_ms(x.numel(), k)
                rows.append({"shape": list(shape), "axis": axis, "ms": ms, "plain_ms": plain,
                             "bound_ms": bound, "bound_by": by})
                log(f"[kernel] sliding_median {shape} k={k} axis={axis}: {ms:.4f} ms "
                    f"(plain {plain:.3f} ms, bound {bound:.4f} ms by {by})")
    log(f"[kernel] sliding_median bit-exact on {len(checks)} shapes x both axes")

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

    main_row = [r for r in rows if r["shape"] == [1025, 193]]
    kernels = [{
        "name": "sliding_median", "route": "cuda", "source": "ssar_tpu_torch/csrc/sliding_median.cu",
        "replaces": "ssar_tpu/ops/median_pallas.py:29", "launches": launches, "max_abs_err": max_err,
        # one HPSS at the main path's shape: the time-axis and the frequency-axis filter of (1025, 193)
        "ms": sum(r["ms"] for r in main_row), "plain_ms": sum(r["plain_ms"] for r in main_row),
        "bound_ms": sum(r["bound_ms"] for r in main_row), "bound_by": main_row[0]["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}), flush=True)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


if __name__ == "__main__":
    main()
