"""Seeded random draws for the patch system, with ``jax.random``'s call surface.

The JAX package threads ``jax.random`` keys through the patch system; the
port keeps that threading but draws with ``torch.Generator``.  A key is a
pair of 32-bit integers, ``split`` derives children by a fixed integer hash
(SplitMix64), and every draw seeds a fresh generator from its key, so one
seed always gives the same patch.

- Draws that fix a patch's structure (``randint``, ``uniform``, ``choice``,
  ``permutation`` and the scalar ``normal``) are made on the CPU, so a
  patch's JSON does not depend on the device.
- Noise banks (``normal`` with a shape) are drawn on the target device from a
  generator on that device: at 1024 px they reach gigabytes, which are not to
  cross from the host.  They are the device's own stream: the CPU's and a
  card's banks for one key differ, and both differ from JAX's.

Every call site of the JAX package maps to one call here, in the same order
and of the same kind, so a test can replace these functions by wrappers over
``jax.random`` and get JAX's draws exactly.  Callers therefore reach them as
``keys.normal(...)``, never by importing the names.
"""
from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1
_MASK32 = (1 << 32) - 1


def _mix(z: int) -> int:
    """SplitMix64's finaliser."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _word(key) -> int:
    hi, lo = (int(v) & _MASK32 for v in key)
    return (hi << 32) | lo


def PRNGKey(seed: int) -> tuple[int, int]:
    """The key of `seed`: its high and low 32 bits."""
    seed = int(seed) & _MASK64
    return (seed >> 32, seed & _MASK32)


def split(key, num: int = 2) -> tuple:
    """`num` child keys of `key`."""
    base = _word(key)
    out = []
    for i in range(num):
        z = _mix(_mix(base ^ 0x5851F42D4C957F2D) + i)
        out.append((z >> 32, z & _MASK32))
    return tuple(out)


def _generator(key, device=None) -> torch.Generator:
    return torch.Generator(device=device or "cpu").manual_seed(_mix(_word(key)))


def normal(key, shape=(), device=None) -> torch.Tensor:
    """Standard normal float32 draws of `shape`.  A scalar (``shape=()``) is
    drawn on the CPU; an array on `device` (the CPU when None), from that
    device's generator."""
    shape = tuple(int(s) for s in shape)
    if not shape:
        return torch.randn((), generator=_generator(key))
    device = torch.device(device or "cpu")
    return torch.randn(shape, generator=_generator(key, device), device=device)


def uniform(key) -> float:
    """One draw from [0, 1), on the CPU."""
    return float(torch.rand((), generator=_generator(key), dtype=torch.float64))


def randint(key, minval: int, maxval: int) -> int:
    """One integer from [minval, maxval), on the CPU."""
    return int(torch.randint(int(minval), int(maxval), (), generator=_generator(key)))


def permutation(key, n: int) -> torch.Tensor:
    """A random permutation of range(n), on the CPU (int64)."""
    return torch.randperm(int(n), generator=_generator(key))


def choice(key, n: int, p) -> int:
    """One index of range(n) drawn with probabilities `p`, on the CPU."""
    cdf = torch.cumsum(torch.as_tensor(p, dtype=torch.float64).reshape(-1)[:n], 0)
    u = float(torch.rand((), generator=_generator(key), dtype=torch.float64)) * float(cdf[-1])
    return min(int(torch.searchsorted(cdf, torch.tensor([u], dtype=torch.float64), right=True)), n - 1)
