"""Time the GRU backbone two ways on one CUDA card: one stacked cuDNN call
(``nn.GRU(num_layers=4)``) against four single-layer ``nn.GRU`` calls with
the same weights.

    python3 scripts/bench_gru_backbone.py

Shapes: the serve path's reactor input (1, 192, 32) and a 3-minute track's
(1, 4320, 32), forward only in eval mode; the grid's GRU training shape
(32, 192, 32), forward and backward.  It also times the serve reactor
(``LatentNoiseReactor``, GRU, hidden 32, 4 layers) on (1, 192, 59) features
as the port builds it.  Each time is the median of 25 synchronised calls
(CUDA events) and the device time per call from torch.profiler over 20
calls.  Prints one line per shape and the card's name and power limit.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch import nn

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import cuda_ms, device_ms_per_call  # noqa: E402
from ssar_tpu_torch.models.reactor import LatentNoiseReactor  # noqa: E402

FEATURES, LAYERS = 32, 4


def main():
    if not torch.cuda.is_available():
        sys.exit("bench_gru_backbone: needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    torch.manual_seed(0)
    stacked = nn.GRU(FEATURES, FEATURES, num_layers=LAYERS, batch_first=True).to(dev)
    layers = [nn.GRU(FEATURES, FEATURES, batch_first=True).to(dev) for _ in range(LAYERS)]
    with torch.no_grad():
        for i, gru in enumerate(layers):
            for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                getattr(gru, f"{name}_l0").copy_(getattr(stacked, f"{name}_l{i}"))

    def per_layer(x):
        for gru in layers:
            x = gru(x)[0]
        return x

    def run_stacked(x):
        return stacked(x)[0]

    for B, T, train in ((1, 192, False), (1, 4320, False), (32, 192, True)):
        x = torch.randn(B, T, FEATURES, device=dev, requires_grad=train)
        row = {}
        for name, fn in (("stacked", run_stacked), ("per_layer", per_layer)):
            if train:
                def call(fn=fn):
                    fn(x).sum().backward()
            else:
                def call(fn=fn):
                    with torch.no_grad():
                        fn(x)
            row[name] = (cuda_ms(call), device_ms_per_call(call))
        with torch.no_grad():
            err = (run_stacked(x) - per_layer(x)).abs().max().item()
        print(f"gru {'fwd+bwd' if train else 'fwd'} ({B}, {T}, {FEATURES}): "
              f"stacked {row['stacked'][0]:.4f} ms (device {row['stacked'][1]:.4f}), "
              f"per-layer {row['per_layer'][0]:.4f} ms (device {row['per_layer'][1]:.4f}), "
              f"max |diff| {err:.3g}", flush=True)

    rng = np.random.RandomState(0)
    feats = rng.randn(192, 59).astype(np.float32)
    palette = rng.randn(96, 18, 512).astype(np.float32)
    model = LatentNoiseReactor(feats.mean(0), feats.std(0) + 1e-6, palette, backbone="gru",
                               hidden_size=FEATURES, num_layers=LAYERS).to(dev).eval()
    f = torch.as_tensor(feats, device=dev)[None]
    gen = torch.Generator(dev).manual_seed(1)

    def react():
        with torch.no_grad():
            model(f, generator=gen)

    print(f"serve reactor (1, 192, 59) as the port builds it: {cuda_ms(react):.4f} ms "
          f"(device {device_ms_per_call(react):.4f})", flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
