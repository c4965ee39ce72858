"""3-band EQ, FFT form (Kaiser-windowed shelving filters via overlap-save).

Counterpart of ``pyaudiodsptools_tpu/ops/eq3band_fft.py``: three
windowed-sinc filters with Kaiser(beta=6) windows -- high shelf = spectrally
inverted lowcut at ``f - f/4``, low shelf = highcut at ``f + f/4``, mid =
lowpass(f+f/4) x highpass(f-f/4) -- combined with the shelf-gain trick
``band*(g-1)`` and mixed with the 1-block-delayed dry signal.

The three band responses collapse at build time into ONE weighted impulse
response, and the delayed dry path is a unit tap at index ``block_size`` --
so the whole EQ is a single FIR executed by ``fft_filter.fir``.
"""

from __future__ import annotations

import numpy as np

from ..core.config import DEFAULT_DEVICE, EngineConfig
from .base import Effect
from .fft_filter import fir, sinc_kernel


def eq3band_fft(cfg: EngineConfig, lowshelf_hz: float, lowshelf_db: float,
                mid_hz: float, mid_db: float, highshelf_hz: float,
                highshelf_db: float, device=DEFAULT_DEVICE) -> Effect:
    B = cfg.block_size
    fs = cfg.sample_rate
    fl = (B // 2) - 1

    # Band kernels, built exactly as the reference does (float64 on host).
    h_highshelf = sinc_kernel(highshelf_hz - highshelf_hz / 4, fs, fl,
                              "kaiser6", invert=True)
    h_lowshelf = sinc_kernel(lowshelf_hz + lowshelf_hz / 4, fs, fl, "kaiser6")
    h_mid_lp = sinc_kernel(mid_hz + mid_hz / 4, fs, fl, "kaiser6")
    h_mid_hp = sinc_kernel(mid_hz - mid_hz / 4, fs, fl, "kaiser6", invert=True)
    # Mid band: spectral product of its low/high pass = a linear convolution
    # in time (support 2fl-1 < B).
    k_mid = np.convolve(h_mid_lp, h_mid_hp)

    def g(db: float) -> float:
        return 10.0 ** (db / 20.0) - 1.0

    k_combined = (g(highshelf_db) * np.concatenate([h_highshelf,
                                                    np.zeros(fl - 1)])
                  + g(lowshelf_db) * np.concatenate([h_lowshelf,
                                                     np.zeros(fl - 1)])
                  + g(mid_db) * k_mid)

    # Effective impulse response: wet kernel at its latency shift plus the
    # 1-block-delayed dry path (unit tap at index B).
    shift = B - fl // 2
    eff_kernel = np.zeros(max(shift + len(k_combined), B + 1))
    eff_kernel[shift: shift + len(k_combined)] += k_combined
    eff_kernel[B] += 1.0
    return fir(eff_kernel, B, name="eq3band_fft", device=device)
