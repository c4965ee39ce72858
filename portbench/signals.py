"""The one signal generator of the benchmark: a traffic file's ``signal``
object names a kind and its parameters, and every signal is made on the
card (or the given device) from the run's seed, in a few large calls.

Kinds:

* ``burst_noise``: Gaussian noise of standard deviation ``level`` times an
  envelope that is ``loud`` for the part of each ``period_s`` where
  ``sin(2 pi t / period) > duty`` and ``quiet`` elsewhere, clipped to
  +-0.99. With the defaults this is ``chip_smoke.burst_noise`` of the
  repository's card lane.
* ``bursts_pauses``: speech-like stems. Each channel alternates pauses and
  bursts of ``burst_noise``; the burst and pause lengths are one fixed set
  for every seed (evenly spaced over ``burst_s`` and ``pause_s``, enough
  pairs to fill the signal), put in an order of their own for each channel
  and seed, so that every seed gives the same amount of speech and
  silence. A pause is uniform noise at ``floor_dbfs`` peak.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BURST_DEFAULTS = {"level": 0.25, "period_s": 1.0 / 3.0, "duty": 0.6,
                  "loud": 0.8, "quiet": 0.3}
# Samples of the time axis handled at once where a signal needs an index
# tensor as large as itself.
TIME_CHUNK = 1 << 22


def seed_for(seed: int, *path: int) -> int:
    """A 63-bit generator seed from the run's seed and a path of ints (the
    ring entry, a purpose): the same run seed always gives the same."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), *path])
    return int(state.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def burst_noise(channels: int, n: int, sample_rate: int, seed: int, device,
                level=0.25, period_s=1.0 / 3.0, duty=0.6, loud=0.8,
                quiet=0.3) -> torch.Tensor:
    gen = _generator(seed, device)
    x = torch.randn((channels, n), generator=gen, device=device,
                    dtype=torch.float32)
    period = int(sample_rate * period_s)
    t = torch.arange(n, device=device, dtype=torch.int64) % period
    env = torch.where(torch.sin(2 * math.pi * t.to(torch.float64) / period)
                      > duty, loud, quiet).to(torch.float32)
    del t
    x.mul_(level).mul_(env)
    return x.clamp_(-0.99, 0.99)


def bursts_pauses(channels: int, n: int, sample_rate: int, seed: int, device,
                  burst_s=(0.3, 3.0), pause_s=(0.2, 2.0), floor_dbfs=-60.0,
                  **burst) -> torch.Tensor:
    x = burst_noise(channels, n, sample_rate, seed_for(seed, 1), device,
                    **burst)
    pair_s = (sum(burst_s) + sum(pause_s)) / 2.0
    pairs = int(math.ceil(n / sample_rate / pair_s)) + 1
    bursts = np.round(np.linspace(*burst_s, pairs) * sample_rate)
    pauses = np.round(np.linspace(*pause_s, pairs) * sample_rate)
    rng = np.random.default_rng(seed_for(seed, 2))
    lengths = np.empty((channels, 2 * pairs), dtype=np.int64)
    for c in range(channels):
        lengths[c, 0::2] = rng.permutation(pauses)
        lengths[c, 1::2] = rng.permutation(bursts)
    ends = torch.from_numpy(np.cumsum(lengths, axis=1)).to(device)
    floor = 10.0 ** (floor_dbfs / 20.0)
    gen = _generator(seed_for(seed, 3), device)
    for lo in range(0, n, TIME_CHUNK):
        hi = min(n, lo + TIME_CHUNK)
        t = torch.arange(lo, hi, device=device, dtype=torch.int64)
        part = torch.searchsorted(ends, t.expand(channels, -1).contiguous(),
                                  right=True)
        pause = (part % 2) == 0
        fill = torch.rand((channels, hi - lo), generator=gen, device=device,
                          dtype=torch.float32).mul_(2 * floor).sub_(floor)
        x[:, lo:hi] = torch.where(pause, fill, x[:, lo:hi])
    return x


KINDS = {"burst_noise": burst_noise, "bursts_pauses": bursts_pauses}


def make(signal: dict, channels: int, n: int, sample_rate: int, seed: int,
         device) -> torch.Tensor:
    """The (channels, n) float32 signal that ``signal`` (a traffic file's
    object: ``kind`` and its parameters) and ``seed`` give."""
    params = dict(signal)
    kind = params.pop("kind")
    if kind not in KINDS:
        raise ValueError(f"no signal kind {kind!r}; known: {sorted(KINDS)}")
    return KINDS[kind](channels, n, sample_rate, seed, device, **params)
