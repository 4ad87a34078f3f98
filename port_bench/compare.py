"""The numbers the check compares, each a gap between what a candidate (the
port's timed path, or the control) produced and what the plain reference
works out from the same inputs."""
from __future__ import annotations

import numpy as np


def rel_gap(got, want) -> float:
    """max |got - want| over max |want| (one tensor, any shape)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    scale = float(np.abs(want).max()) if want.size else 0.0
    return float(np.abs(got - want).max() / max(scale, 1e-30)) if want.size else 0.0


def column_gap(got, want) -> float:
    """The largest over columns of ``rel_gap`` of a (T, C) feature matrix
    (features of very different scales each held to their own)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    scale = np.maximum(np.abs(want).max(axis=0), 1e-30)
    return float((np.abs(got - want).max(axis=0) / scale).max())


def frame_gap(got: np.ndarray, want: np.ndarray) -> float:
    """Mean absolute difference of two uint8 I420 frames, in levels."""
    if got.shape != want.shape:
        return float("inf")
    return float(np.abs(got.astype(np.int16) - want.astype(np.int16)).mean())


def worst(per_track: list[dict]) -> dict:
    """Each number's largest value over the tracks."""
    out: dict = {}
    for numbers in per_track:
        for k, v in numbers.items():
            out[k] = max(out.get(k, -np.inf), v)
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number at or under its limit, {name: {"value", "limit"}}); a
    number without a value (nothing to compare) fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and np.isfinite(value) and value <= limit
    return ok, checks
