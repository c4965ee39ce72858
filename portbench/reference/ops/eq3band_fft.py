"""EffectEQ3BandFFT: three Kaiser (beta 6) windowed-sinc bands of
``chunk/2 - 1`` taps, each weighted by its gain less one and added to the
dry signal one chunk late.

* high shelf: the spectral inverse of a lowpass at ``f - f/4``;
* low shelf: a lowpass at ``f + f/4``;
* mid: a lowpass at ``f + f/4`` times a highpass at ``f - f/4``, their
  product in frequency, a convolution of the two in time."""

import numpy as np

from portbench.reference import firs


def kernel(ctx, lowshelf_hz, lowshelf_db, mid_hz, mid_db, highshelf_hz,
           highshelf_db) -> np.ndarray:
    B, fs = ctx.block_size, ctx.sample_rate
    taps = firs.chunk_taps(B)
    high = firs.sinc(highshelf_hz - highshelf_hz / 4, fs, taps, "kaiser6",
                     invert=True)
    low = firs.sinc(lowshelf_hz + lowshelf_hz / 4, fs, taps, "kaiser6")
    mid = np.convolve(firs.sinc(mid_hz + mid_hz / 4, fs, taps, "kaiser6"),
                      firs.sinc(mid_hz - mid_hz / 4, fs, taps, "kaiser6",
                                invert=True))
    wet = np.zeros(len(mid))
    for h, db in ((high, highshelf_db), (low, lowshelf_db), (mid, mid_db)):
        wet[:len(h)] += (10.0 ** (db / 20.0) - 1.0) * h
    lat = firs.latency(B)
    k = np.zeros(max(lat + len(wet), B + 1))
    k[lat:lat + len(wet)] += wet
    k[B] += 1.0                          # the dry path, one chunk late
    return k


def apply(x, ctx, **band):
    return firs.causal_conv(x, kernel(ctx, **band), ctx)
