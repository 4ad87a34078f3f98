"""Feature parity and timing harness (``python -m ssar_tpu_torch.audio.parity``).

Counterpart of ``ssar_tpu/audio/parity.py``: for each named feature it prints
the output's statistics, the ms a call (synchronised on the card), the norm
of the gradient of sum |feature| with respect to the waveform (``FAIL`` when
it cannot be taken), and, for rms and the mel spectrogram, the min / mean /
max |diff| against an independent numpy oracle.  It runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..utils.device import full_precision, resolve_device
from . import features as FT
from .beat import onset_strength, plp
from .spectral import mel_basis, melspectrogram


def _mel_oracle(au: np.ndarray, sr: int) -> np.ndarray:
    n_fft, hop = 2048, 1024
    ap = np.pad(au, (n_fft // 2, n_fft // 2), mode="reflect")
    win = 0.5 * (1 - np.cos(2 * np.pi * np.arange(n_fft) / n_fft))
    nf = (len(ap) - n_fft) // hop + 1
    fr = np.stack([ap[i * hop : i * hop + n_fft] * win for i in range(nf)])[:-1]
    S = np.abs(np.fft.rfft(fr, axis=1)) ** 2
    return mel_basis(sr, n_fft) @ S.T


def _rms_oracle(au: np.ndarray, sr: int) -> np.ndarray:
    ap = np.pad(au, (1024, 1024), mode="reflect")
    nf = (len(ap) - 2048) // 1024 + 1
    return np.stack([np.sqrt(np.mean(ap[i * 1024 : i * 1024 + 2048] ** 2)) for i in range(nf - 1)])[:, None]


def harness(sr: int, au: np.ndarray) -> list:
    """(name, feature of a waveform tensor, numpy oracle or None) rows."""
    return [
        ("mfcc", lambda a: FT.mfcc(a, sr), None),
        ("chroma", lambda a: FT.chromagram(a, sr, tuning=0.0), None),
        ("tonnetz", lambda a: FT.tonnetz(a, sr, tuning=0.0), None),
        ("contrast", lambda a: FT.spectral_contrast(a, sr), None),
        ("flatness", lambda a: FT.spectral_flatness(a, sr), None),
        ("onsets", lambda a: onset_strength(a, sr), None),
        ("rms", lambda a: FT.rms(a, sr), lambda: _rms_oracle(au, sr)),
        ("drop_strength", lambda a: FT.drop_strength(a, sr), None),
        ("pulse", lambda a: plp(a, sr), None),
        ("melspec", lambda a: melspectrogram(a, sr), lambda: _mel_oracle(au, sr)),
    ]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--trials", type=int, default=5)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    sr = 1024 * args.fps
    L = int(sr * args.seconds)
    t = np.arange(L) / sr
    au = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * np.random.RandomState(0).randn(L)).astype(np.float32)
    au[:: sr // 2] += 1.5
    aj = torch.as_tensor(au, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    print(f"{'feature'.ljust(16)} {'shape'.ljust(14)} {'min/mean/max'.ljust(28)} "
          f"{'ms/call'.ljust(9)} {'grad'.ljust(8)} oracle |diff|")
    with full_precision():
        for name, fn, oracle in harness(sr, au):
            with torch.no_grad():
                out = fn(aj)
                sync()
                t0 = time.perf_counter()
                for _ in range(args.trials):
                    out = fn(aj)
                sync()
            dt = (time.perf_counter() - t0) / args.trials * 1000

            try:
                a = aj.clone().requires_grad_(True)
                fn(a).abs().sum().backward()
                grad_ok = f"{float(torch.linalg.vector_norm(a.grad)):.2g}"
            except Exception:  # the row reports a feature whose gradient cannot be taken
                grad_ok = "FAIL"

            o = out.detach().cpu().numpy()
            diff = "-"
            if oracle is not None:
                ref = oracle()
                if o.shape == ref.shape:
                    d = np.abs(o - ref)
                    diff = f"{d.min():.2g}/{d.mean():.2g}/{d.max():.2g}"
                else:
                    diff = f"shape {o.shape} vs {ref.shape}"

            stats = f"{o.min():.3f}/{o.mean():.3f}/{o.max():.3f}"
            print(f"{name.ljust(16)} {str(tuple(o.shape)).ljust(14)} {stats.ljust(28)} "
                  f"{dt:7.1f}  {grad_ok.ljust(8)} {diff}", flush=True)


if __name__ == "__main__":
    main()
