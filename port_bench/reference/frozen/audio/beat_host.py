# Frozen copy of ssar_tpu_torch/audio/beat_host.py for the benchmark's plain reference.  It is not
# imported from the port, so a change to the port cannot change what the port is held to;
# port_bench/tests/test_bench_reference.py holds the two together at small sizes.
"""Host-side tempo estimation + dynamic-programming beat tracking (numpy).

The reference calls librosa's `beat.tempo` / `beat.beat_track` on the CPU
(ssar/random/mir.py:29-33) — host-side numpy there too, so this is the
same engineering choice, implemented from the published algorithms:
tempo via onset autocorrelation with a log-normal prior, beats via the
Ellis (2007) dynamic-programming tracker.
"""
from __future__ import annotations

import numpy as np


def tempo_frequencies(n: int, sr: float, hop_length: int) -> np.ndarray:
    """BPM value of each autocorrelation lag (lag 0 -> inf)."""
    lags = np.arange(n, dtype=np.float64)
    lags[0] = 1e-9
    return 60.0 * sr / (hop_length * lags)


def estimate_tempo(onset_envelope: np.ndarray, sr: float = 24576, hop_length: int = 1024,
                   max_tempo: float = 240.0, ac_size: float = 8.0,
                   prior_scale: float = 400.0, prior_s: float = 1.0,
                   start_bpm: float = 120.0) -> float:
    """Global tempo in BPM from an onset envelope.

    Autocorrelation of the onset envelope, weighted by a log-normal prior
    over BPM (the reference passes scipy lognorm(scale=400, s=1),
    ssar/random/mir.py:30-31).
    """
    env = np.asarray(onset_envelope, dtype=np.float64)
    env = env - env.mean()
    n = len(env)
    win = min(n, int(ac_size * sr / hop_length))
    # full autocorrelation via FFT
    f = np.fft.rfft(env, n=2 * n)
    ac = np.fft.irfft(f * np.conj(f))[:win]
    ac = np.maximum(ac, 0)

    bpms = tempo_frequencies(win, sr, hop_length)
    # log-normal prior over bpm
    with np.errstate(divide="ignore"):
        logprior = -0.5 * ((np.log(bpms) - np.log(prior_scale)) / prior_s) ** 2
    logprior[bpms > max_tempo] = -np.inf
    logprior[0] = -np.inf

    score = np.log1p(1e6 * ac) + logprior
    return float(bpms[np.argmax(score)])


def beat_track(onset_envelope: np.ndarray, sr: float = 24576, hop_length: int = 1024,
               bpm: float | None = None, tightness: float = 100.0, trim: bool = False):
    """DP beat tracker (Ellis 2007): returns beat frame indices.

    local score = gaussian-smoothed onset strength; transition cost
    -tightness * (log(interval / period))^2.
    """
    env = np.asarray(onset_envelope, dtype=np.float64)
    if env.std() > 0:
        env = (env - env.mean()) / env.std()
    if bpm is None:
        bpm = estimate_tempo(env, sr, hop_length)
    period = max(1, int(round(60.0 * sr / (hop_length * bpm))))

    # smooth local score with a gaussian of width period/32
    sigma = max(1.0, period / 32.0)
    r = int(4 * sigma)
    k = np.exp(-0.5 * ((np.arange(-r, r + 1)) / sigma) ** 2)
    localscore = np.convolve(env, k / k.sum(), mode="same")

    n = len(localscore)
    backlink = np.full(n, -1, dtype=np.int64)
    cumscore = localscore.copy()
    window = np.arange(-2 * period, -period // 2)
    txcost = -tightness * (np.log(-window / period) ** 2)

    first_beat = True
    for i in range(n):
        idx = i + window
        valid = idx >= 0
        if not valid.any():
            continue
        scores = txcost[valid] + cumscore[idx[valid]]
        best = np.argmax(scores)
        if first_beat and localscore[i] < 0.01 * localscore.max():
            backlink[i] = -1
        else:
            backlink[i] = idx[valid][best]
            first_beat = False
        cumscore[i] = scores[best] + localscore[i]

    # backtrace from the best final beat
    maxes = np.argwhere(cumscore > 0.5 * cumscore.max()).flatten()
    tail = maxes[-1] if len(maxes) else n - 1
    beats = [int(tail)]
    while backlink[beats[-1]] >= 0:
        beats.append(int(backlink[beats[-1]]))
    beats = np.array(beats[::-1])

    if trim:
        w = k / k.sum()
        smooth_env = np.convolve(localscore[beats], np.hanning(5) / np.hanning(5).sum(), mode="same") \
            if len(beats) >= 5 else localscore[beats]
        thresh = 0.5 * (smooth_env**2).mean() ** 0.5
        keep = localscore[beats] > thresh
        beats = beats[keep]
    return bpm, beats
