"""CreateHighCutFilter: a lowpass, a Blackman windowed sinc of
``chunk/2 - 1`` taps, one chunk late."""

import numpy as np

from portbench.reference import firs


def kernel(ctx, cutoff_hz: float) -> np.ndarray:
    taps = firs.chunk_taps(ctx.block_size)
    h = firs.sinc(cutoff_hz, ctx.sample_rate, taps, "blackman")
    return np.concatenate([np.zeros(firs.latency(ctx.block_size)), h])


def apply(x, ctx, cutoff_hz: float):
    return firs.causal_conv(x, kernel(ctx, cutoff_hz), ctx)
