"""Test-signal generators.

Counterpart of ``pyaudiodsptools_tpu/core/generators.py``: parity with
pyAudioDspTools ``Generators.py`` (sine :5-27, square :30-54, band-limited
white noise :57-92), with one deliberate change: the reference's noise uses
unseeded ``numpy.random`` (Generators.py:84); this one takes a
``torch.Generator`` (the JAX package takes a PRNG key, so the two packages'
random phases differ; their magnitude spectra do not).

The generators take the sample rate explicitly and put their result on
``device``, ``"cuda"`` unless the caller names the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .config import DEFAULT_DEVICE, resolve_device


def sine(frequency: float, n_samples: int, sample_rate: int,
         device=DEFAULT_DEVICE) -> torch.Tensor:
    """Sine wave, float32, amplitude 1.0 (Generators.py:5-27 parity): sin in
    float64 on the host, then float32, so that fixtures are bit-identical to
    the reference's."""
    t = np.arange(n_samples)
    return torch.from_numpy(
        np.sin(2 * np.pi * frequency * t / sample_rate).astype(np.float32)
    ).to(resolve_device(device))


def square(frequency: float, n_samples: int, sample_rate: int,
           device=DEFAULT_DEVICE) -> torch.Tensor:
    """Square wave as sign-of-sine (Generators.py:30-54 parity: strictly
    positive sine -> 1.0, else -1.0)."""
    s = np.sin(2 * np.pi * frequency * np.arange(n_samples) / sample_rate)
    return torch.from_numpy(np.where(s > 0, 1.0, -1.0).astype(np.float32)
                            ).to(resolve_device(device))


def whitenoise(generator: torch.Generator, n_samples: int, sample_rate: int,
               low_hz: float = 20.0, high_hz: float = 20000.0,
               device=DEFAULT_DEVICE) -> torch.Tensor:
    """Band-limited noise via random spectral phases (Generators.py:57-92):
    unit magnitude in [low_hz, high_hz], random phases on the positive
    frequencies (drawn from ``generator``, on its device), conjugate
    symmetry, ifft, x5 amplitude."""
    dev = resolve_device(device)
    freqs = torch.abs(torch.fft.fftfreq(n_samples, 1.0 / sample_rate))
    band = ((freqs >= low_hz) & (freqs <= high_hz)).to(torch.complex64)
    n_pos = (n_samples - 1) // 2
    phases = torch.rand(n_pos, generator=generator,
                        device=generator.device) * (2 * math.pi)
    spec = band.to(dev)
    phasor = torch.polar(torch.ones_like(phases), phases).to(dev)
    spec[1:n_pos + 1] *= phasor
    if n_pos:
        spec[n_samples - n_pos:] = torch.conj(spec[1:n_pos + 1]).flip(0)
    return (torch.fft.ifft(spec).real * 5.0).to(torch.float32)
