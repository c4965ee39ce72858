"""The compressor / gate automaton of upstream ``CreateCompressor`` and
``CreateGate``, written from its definition, vectorised over time.

Per channel, from rest: a sample whose input is over the threshold
triggers; the attack ramp ``linspace(1, ratio, attack)`` then runs
``attack - 1`` more samples whatever the input does; after it, an over
sample holds the full ratio and every other sample steps down the release
ramp ``linspace(ratio, 1, release)`` from its start (an over sample
re-starts it). The sample that completes the release returns the machine
to rest, and the one after it is never examined (gain 1). The gain depends
only on the over-threshold mask of the input.

The machine is walked from trigger to release, not sample by sample: a
release completes at the first non-over sample that ends ``release``
non-over samples in a row, counted from the attack's end at the earliest.
"""

from __future__ import annotations

import numpy as np
import torch


def gains(over: torch.Tensor, attack: np.ndarray, release: np.ndarray,
          dtype: torch.dtype) -> torch.Tensor:
    """Each sample's gain for one channel's (T,) boolean mask ``over``."""
    T = over.numel()
    dev = over.device
    x_max, y_max = len(attack), len(release)
    att = torch.as_tensor(attack, dtype=dtype, device=dev)
    rel = torch.as_tensor(release, dtype=dtype, device=dev)
    ratio = att[-1]
    g = torch.ones(T, dtype=dtype, device=dev)
    idx = torch.arange(T, device=dev)
    opos = torch.nonzero(over).flatten()
    last = torch.cummax(torch.where(over, idx, torch.full_like(idx, -1)),
                        0).values
    p = 0
    while True:
        k = int(torch.searchsorted(opos, torch.tensor(p, device=dev)))
        if k >= opos.numel():
            return g
        t0 = int(opos[k])
        a = t0 + x_max                     # the first sample after the attack
        g[t0 + 1:min(a, T)] = att[1:min(a, T) - t0]
        if a >= T:
            return g
        te, lo, width = None, a, max(4 * y_max, 1 << 16)
        while lo < T:
            hi = min(T, lo + width)
            run = idx[lo:hi] - torch.clamp(last[lo:hi], min=a - 1)
            done = (~over[lo:hi]) & (run >= y_max)
            if bool(done.any()):
                te = lo + int(torch.argmax(done.to(torch.int8)))
                break
            lo, width = hi, 2 * width
        end = T if te is None else te + 1
        run = idx[a:end] - torch.clamp(last[a:end], min=a - 1)
        g[a:end] = torch.where(over[a:end], ratio,
                               rel[torch.clamp(run - 1, 0, y_max - 1)])
        if te is None:
            return g
        p = te + 2


def apply(x: torch.Tensor, ctx, threshold_db: float, pre_gain: float,
          attack: np.ndarray, release: np.ndarray) -> torch.Tensor:
    """``x * pre_gain * gains`` with the mask ``|x| > 10^(threshold/20)``
    taken from the unscaled input, channel by channel."""
    thr = 10.0 ** (threshold_db / 20.0)
    att = ctx.rnd(torch.as_tensor(attack, dtype=ctx.work)).cpu().numpy()
    rel = ctx.rnd(torch.as_tensor(release, dtype=ctx.work)).cpu().numpy()
    y = torch.empty_like(x)
    for c in range(x.shape[0]):
        g = gains(x[c].abs() > thr, att, rel, ctx.work)
        y[c] = ctx.rnd(x[c] * pre_gain) * g
    return y
