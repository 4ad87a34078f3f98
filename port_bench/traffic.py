"""The one traffic generator: tracks of synthetic music drawn from a seed,
with the parameters of a mix file (``traffic/<mix>.json``).

Every track of a mix has the same length and rate, whatever the seed; the
seed draws the content: the key, the order of the four-chord cycle, the
loud and quiet sections, the noise and the click phase.  Where the content
changes the work (the random-patch entry draws its patch, and so the size
of its noise trees, from the track's seed), a mix names a ``pool``: the
window's tracks are then the pool's, a fixed set drawn from ``pool_seed``,
in an order and with checked frames drawn from the run's seed.  A track is a chord tone stepping one chord a
section (the segmentation has structure to find), slowly wobbling in pitch,
with noise and a click every half second (onsets and beats to track).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


@dataclass
class Track:
    index: int          # 0, 1, ... in the window; -1 for the set-up track
    seed: int           # the track's own seed (its content; the patch seed of the random-patch entry)
    audio: np.ndarray   # mono float32
    sr: int
    frames: int         # frames the entry renders: seconds * fps
    check: list         # frame indices the correctness check compares, drawn from the seed


def load_mix(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def track_audio(seed: int, sr: int, seconds: float, section_seconds: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(round(sr * seconds))
    t = np.arange(n, dtype=np.float32) / np.float32(sr)
    wobble = 1 + 0.05 * np.sin(np.float32(2 * np.pi / 7) * t + np.float32(rng.uniform(0, 2 * np.pi)))
    base = 220.0 * 2 ** (rng.integers(-5, 7) / 12)
    cycle = np.array([0, 5, 7, 3])[rng.permutation(4)]
    section = (np.arange(n) // int(round(sr * section_seconds))) % 4
    loud = rng.integers(2)
    gain = np.where(section % 2 == loud, np.float32(0.25), np.float32(0.4))
    # each chord tone's phase accumulated in float64 and wrapped before the float32 sine
    step = (base * 2 ** (cycle / 12) / sr)[section] * wobble.astype(np.float64)
    tone = np.zeros(n, np.float32)
    for weight, ratio in ((1.0, 1.0), (0.5, 2 ** (4 / 12)), (0.5, 2 ** (7 / 12))):
        phase = np.mod(np.cumsum(step * ratio), 1.0).astype(np.float32)
        tone += np.float32(weight) * np.sin(np.float32(2 * np.pi) * phase)
    audio = gain * tone / 2 + np.float32(0.1) * rng.standard_normal(n, dtype=np.float32)
    audio[rng.integers(sr // 2):: sr // 2] += 1.0
    return audio.astype(np.float32)


class Tracks:
    """Tracks of `mix` from `seed`: ``setup()`` the set-up track, then
    ``next()`` the window's tracks in order.  The first `prepared` tracks of
    the window are drawn at construction (set-up), the rest when asked."""

    def __init__(self, mix: dict, seed: int, prepared: int | None = None):
        self.mix = mix
        self.rng = np.random.default_rng(int(seed))
        self.drawn: list[Track] = []
        self.pool: list[int] = []
        if mix.get("pool"):
            fixed = np.random.default_rng(int(mix["pool_seed"]))
            self.pool = [int(fixed.integers(1, 2**31 - 1)) for _ in range(int(mix["pool"]))]
            self.pool = [self.pool[i] for i in self.rng.permutation(len(self.pool))]
        self._audio: dict = {}
        self._setup = self._draw(-1)
        for _ in range(mix["prepared_tracks"] if prepared is None else prepared):
            self.drawn.append(self._draw(len(self.drawn)))
        self.served = 0

    def _draw(self, index: int) -> Track:
        m = self.mix
        seed = int(self.rng.integers(1, 2**31 - 1))
        if self.pool and index >= 0:
            seed = self.pool[index % len(self.pool)]
        frames = int(m["seconds"] * m["fps"])
        check = sorted(int(i) for i in self.rng.choice(frames, m["frames_checked"], replace=False))
        sr = int(m["sample_rate"])
        if seed not in self._audio:
            self._audio[seed] = track_audio(seed, sr, m["seconds"], m["section_seconds"])
        return Track(index, seed, self._audio[seed], sr, frames, check)

    def setup(self) -> Track:
        return self._setup

    def next(self) -> Track:
        if self.served == len(self.drawn):
            self.drawn.append(self._draw(self.served))
        track = self.drawn[self.served]
        self.served += 1
        return track
