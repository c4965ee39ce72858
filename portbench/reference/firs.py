"""Windowed-sinc design and causal FFT convolution, float64, for the
reference's filters (upstream ``FFTFilter``: a filter of ``chunk/2 - 1``
taps, its output one chunk late)."""

from __future__ import annotations

import numpy as np
import torch


def sinc(cutoff_hz: float, sample_rate: float, taps: int, window: str,
         invert: bool = False) -> np.ndarray:
    """A windowed sinc of ``taps`` taps, normalised to unit gain at DC;
    ``invert`` turns the lowpass into its spectral inverse (highpass)."""
    n = np.arange(taps)
    h = np.sinc(2.0 * cutoff_hz / sample_rate * (n - (taps - 1) / 2.0))
    if window == "blackman":
        h = h * np.blackman(taps)
    elif window == "kaiser6":
        h = h * np.kaiser(taps, 6.0)
    else:
        raise ValueError(f"no window {window!r}")
    h = h / np.sum(h)
    if invert:
        h = -h
        h[(taps - 1) // 2] += 1.0
    return h


def chunk_taps(block_size: int) -> int:
    """The upstream filter length for a chunk of ``block_size``."""
    return block_size // 2 - 1


def latency(block_size: int) -> int:
    """Samples by which the upstream overlap-add places a filter's taps:
    one chunk less the filter's half length."""
    return block_size - chunk_taps(block_size) // 2


def causal_conv(x: torch.Tensor, kernel: np.ndarray, ctx) -> torch.Tensor:
    """``y[c, t] = sum_k kernel[k] x[c, t - k]`` over (C, T), by FFT in the
    context's work dtype, a few channels at a time."""
    C, T = x.shape
    k = ctx.rnd(torch.as_tensor(kernel, dtype=torch.float64).to(
        device=x.device, dtype=ctx.work))
    n = 1
    while n < T + len(kernel) - 1:
        n *= 2
    spec = torch.fft.rfft(k, n)
    per = max(1, (1 << 27) // n)        # channels a transform
    out = torch.empty((C, T), dtype=ctx.work, device=x.device)
    for lo in range(0, C, per):
        xs = torch.fft.rfft(x[lo:lo + per], n, dim=-1)
        xs.mul_(spec)
        out[lo:lo + per] = torch.fft.irfft(xs, n, dim=-1)[:, :T]
        del xs
    return out
