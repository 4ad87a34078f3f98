"""Profile the PyTorch port's serve path on one CUDA card with torch.profiler.

    python3 scripts/profile_torch_slice.py

Same path and sizes as chip_smoke.py's main path (synthetic 44.1 kHz track
-> audio2features -> GRU reactor -> 1024 px bf16 StyleGAN2 -> I420 frames in
memory), after one warm-up run.  Writes the kernel table (device time by
name) and a stage summary to chiprun_out/profile_torch_slice.txt under the repo root and prints the
summary: wall time per stage, summed device kernel time per stage and the
device idle share (1 - kernel time / wall time; kernels on two streams can
overlap, so this is a lower bound of the idle share).
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import synthetic_track  # noqa: E402
from ssar_tpu_torch.audio.features import audio2features  # noqa: E402
from ssar_tpu_torch.gan.stylegan2 import StyleGAN2Config  # noqa: E402
from ssar_tpu_torch.gan.wrapper import StyleGAN2Synthesizer  # noqa: E402
from ssar_tpu_torch.generate.audio2video import react, render_reaction  # noqa: E402
from ssar_tpu_torch.models.reactor import LatentNoiseReactor  # noqa: E402


SECONDS = 8.0  # chip_smoke.py's main path
BATCH = 16


class NullSink:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def write_i420(self, frame):
        pass


def device_ms(prof) -> float:
    """Summed device time of the kernels and copies (device-side events only,
    as the profiler's own "Self CUDA time total" counts them)."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation) / 1e3


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_torch_slice: needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    sr = 44100
    audio = synthetic_track(sr, SECONDS)
    config = StyleGAN2Config()
    syn = StyleGAN2Synthesizer(output_size=(1024, 1024), config=config, seed=0, device=dev)
    palette = torch.randn(96, config.n_latent, 512, generator=torch.Generator().manual_seed(0))

    def stages(a):
        """The path on waveform `a` as (stage name, callable) pairs, run in order."""
        state = {}

        def features():
            state["F"] = audio2features(a, sr, 24, device=dev)

        def reactor():
            F = state["F"]
            model = LatentNoiseReactor(F.mean(0), F.std(0) + 1e-6, palette, backbone="gru", hidden_size=32,
                                       num_layers=4).to(dev).eval()
            state["lat"], state["noise"] = react(model, F, torch.Generator(dev).manual_seed(1))

        def render():
            render_reaction(state["lat"], state["noise"], output_size=(1024, 1024), batch_size=BATCH,
                            gan_config=config, synthesizer=syn, writer=NullSink())

        return [("features", features), ("reactor", reactor), ("render", render)]

    for _, fn in stages(audio[:sr]):  # warm-up
        fn()
    torch.cuda.synchronize()

    lines, tables = [f"{smi} | torch {torch.__version__} | {SECONDS} s track, batch {BATCH}"], []
    total_wall = total_dev = 0.0
    for name, fn in stages(audio):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        dev_ms = device_ms(prof)
        total_wall, total_dev = total_wall + wall, total_dev + dev_ms
        lines.append(f"{name}: wall {wall:.1f} ms, device kernels {dev_ms:.1f} ms, "
                     f"idle share >= {max(0.0, 1 - dev_ms / wall):.3f}")
        tables.append(f"== {name} ==\n" + prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))
    lines.append(f"total: wall {total_wall:.1f} ms, device kernels {total_dev:.1f} ms, "
                 f"idle share >= {max(0.0, 1 - total_dev / total_wall):.3f}")
    out = Path(__file__).resolve().parents[1] / "chiprun_out"
    out.mkdir(parents=True, exist_ok=True)
    (out / "profile_torch_slice.txt").write_text("\n".join(lines) + "\n\n" + "\n\n".join(tables))
    print("\n".join(lines))


if __name__ == "__main__":
    main()
