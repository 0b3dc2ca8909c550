"""Seeding, counterpart of ``mmr_tpu/core/prng.py``.

:func:`seed_everything` seeds the host's generators (``random``, numpy,
torch's default) from one seed. In place of JAX's keyed ``RngStream``,
:class:`RngStream` hands out explicit ``torch.Generator``s seeded from
(seed, name) or (seed, name, epoch, step): any step's draws can be made
again from the seed alone. The numbers differ from JAX's streams; the same
seed gives the same numbers on every run.
"""

from __future__ import annotations

import random

import numpy as np
import torch

DEFAULT_SEED = 6210   # the reference's seed of record, ModelTraining.py:150
DEFAULT_SPLIT_SEED = 12345   # its split seed, Pre_Process.py:95,143,1123

_MASK = (1 << 64) - 1


def seed_everything(seed: int = DEFAULT_SEED) -> int:
    """Seed ``random``, numpy's global generator and torch's default
    generators; returns the seed."""
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return seed


def _stable_hash(name: str) -> int:
    """FNV-1a of the name, 31 bits (JAX's ``_stable_hash``)."""
    h = 2166136261
    for b in name.encode():
        h = ((h ^ b) * 16777619) & 0x7FFFFFFF
    return h


def _mix(*words: int) -> int:
    """A 63-bit seed from integers: splitmix64 over each in turn."""
    z = 0
    for w in words:
        z = (z + (w & _MASK) + 0x9E3779B97F4A7C15) & _MASK
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        z ^= z >> 31
    return z >> 1


class RngStream:
    """Generators derived from one seed by name, and by (name, epoch,
    step).

    >>> rng = RngStream(seed_everything(0))
    >>> g = rng.step("train", epoch=3, step=17, device="cpu")
    """

    def __init__(self, seed: int):
        self.seed = int(seed)

    def named(self, name: str, device: str | torch.device = "cpu") -> torch.Generator:
        return torch.Generator(device=device).manual_seed(
            _mix(self.seed, _stable_hash(name)))

    def step(self, name: str, epoch: int, step: int,
             device: str | torch.device = "cpu") -> torch.Generator:
        return torch.Generator(device=device).manual_seed(
            _mix(self.seed, _stable_hash(name), epoch, step))
