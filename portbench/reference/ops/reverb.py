"""CreateReverb (upstream ``_EffectReverb.py``, unexported work in
progress there): two early-reflection delay lines summed, wet only (no dry
signal). ``reverb_samples = int(time_in_ms / 1000 * sample_rate)``.

* line 1: 100 loops behind a high-cut at 5,000 Hz;
* line 2: 50 loops behind a high-cut at 150 Hz.

A line runs upstream's FFT filter's high-cut (a Blackman sinc of
``chunk/2 - 1`` taps, one chunk late), then adds ``loops - 1``
shifted copies of the filtered signal: copy k (k = 0 ... loops - 2,
upstream's ``range(loops - 1)``) ``(reverb_samples // loops) * (k + 1)``
samples late, scaled by ``linspace(0.3, 0.01, loops)[k]``, so the ramp's
last entry is unused. The line structure is kept (a convolution, then the
shifted adds); nothing here convolves with the lines' combined response,
which :func:`kernel` gives for the readers' geometry only.

Departures from upstream:

* the whole signal at once, not chunk by chunk: upstream's delay buffer
  carries every copy over the chunks, so the sum is the same;
* a copy's samples that fall past the signal's end are dropped where
  upstream keeps them in its buffer for the next chunk (the output has the
  input's length either way);
* upstream's debug print and its unused white-noise helper are left out.
"""

import numpy as np
import torch

from portbench.reference import firs

LINES = ((100, 5000.0), (50, 150.0))    # (loops, high-cut Hz) of each line


def _highcut(ctx, cutoff_hz: float) -> np.ndarray:
    """Upstream's high-cut as a causal kernel: the sinc one chunk late."""
    taps = firs.chunk_taps(ctx.block_size)
    h = firs.sinc(cutoff_hz, ctx.sample_rate, taps, "blackman")
    return np.concatenate([np.zeros(firs.latency(ctx.block_size)), h])


def _samples(ctx, time_in_ms: float) -> int:
    return int((time_in_ms / 1000) * ctx.sample_rate)


def _line(x, ctx, reverb_samples: int, loops: int, highcut_hz: float):
    f = ctx.rnd(firs.causal_conv(x, _highcut(ctx, highcut_hz), ctx))
    d = reverb_samples // loops
    gains = np.linspace(0.3, 0.01, num=loops)
    T = x.shape[-1]
    y = torch.zeros_like(f)
    for k in range(loops - 1):
        lag = d * (k + 1)
        if lag < T:
            g = ctx.rnd(torch.tensor(float(gains[k]), dtype=ctx.work))
            y[:, lag:] += ctx.rnd(g.to(x.device) * f[:, :T - lag])
    return ctx.rnd(y)


def apply(x, ctx, time_in_ms: float = 1500.0):
    r = _samples(ctx, time_in_ms)
    y = None
    for loops, hz in LINES:
        line = _line(x, ctx, r, loops, hz)
        y = line if y is None else ctx.rnd(y + line)
    return y


def kernel(ctx, time_in_ms: float = 1500.0) -> np.ndarray:
    """The two lines' impulse response summed, float64, its leading zeros
    (the filters' latency and the first copy's lag) kept."""
    r = _samples(ctx, time_in_ms)
    parts = []
    for loops, hz in LINES:
        h = _highcut(ctx, hz)
        d = r // loops
        gains = np.linspace(0.3, 0.01, num=loops)
        k = np.zeros(d * (loops - 1) + len(h))
        for i in range(loops - 1):
            k[d * (i + 1):d * (i + 1) + len(h)] += gains[i] * h
        parts.append(k)
    out = np.zeros(max(len(k) for k in parts))
    for k in parts:
        out[:len(k)] += k
    return out
