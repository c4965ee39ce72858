"""Mixing, gain, metering, bit-depth conversion and dither.

Counterpart of ``pyaudiodsptools_tpu/core/utility.py``. Parity targets in
pyAudioDspTools ``Utility.py``: ``MixSignals`` :51-72, ``VolumeChange``
:171-194, ``InfodBV`` / ``InfodBV16Bit`` :122-168, ``ConvertdBVTo16Bit`` /
``Convert16BitTodBV`` :75-83, dither :86-105.

Deliberate change: the dithers take an explicit ``torch.Generator`` (the JAX
package takes a PRNG key) instead of the reference's unseeded
``numpy.random.randint``; the two packages' random numbers differ.

A tensor is worked on where it lies; anything else ``torch.as_tensor`` takes
goes to ``device``, ``"cuda"`` unless the caller names the CPU.
"""

from __future__ import annotations

import torch

from .config import DEFAULT_DEVICE, resolve_device


def _tensor(x, device=DEFAULT_DEVICE) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=resolve_device(device))


def mix_signals(*signals, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Sum signals then clip to [-1, 1] (Utility.py:51-72)."""
    mixed = _tensor(signals[0], device)
    for s in signals[1:]:
        mixed = mixed + _tensor(s, mixed.device)
    return torch.clamp(mixed, -1.0, 1.0)


def volume_change(signal, gain_db: float, overflow_protection: bool = True,
                  device=DEFAULT_DEVICE) -> torch.Tensor:
    """Gain in dB, optional clip (Utility.py:171-194)."""
    out = (10.0 ** (gain_db / 20.0)) * _tensor(signal, device)
    if overflow_protection:
        out = torch.clamp(out, -1.0, 1.0)
    return out


def info_dbv(signal, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Mean absolute amplitude in dB re 1.0 (Utility.py:122-144)."""
    return 20.0 * torch.log10(torch.mean(torch.abs(_tensor(signal, device))))


def info_dbv_16bit(signal, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Mean absolute amplitude in dB re 32767 (Utility.py:146-168)."""
    x = _tensor(signal, device)
    return 20.0 * torch.log10(torch.mean(torch.abs(x).to(torch.float32))
                              / 32767.0)


def dbv_to_16bit(signal, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Clip then scale to int16 by 2**15-1, truncating (Utility.py:75-78)."""
    x = torch.clamp(_tensor(signal, device), -1.0, 1.0)
    return (x * (2 ** 15 - 1)).to(torch.int16)


def from_16bit_to_dbv(int_signal, device=DEFAULT_DEVICE) -> torch.Tensor:
    """int16 -> float32 scaled by /32767 (Utility.py:81-83)."""
    return (_tensor(int_signal, device) / 32767.0).to(torch.float32)


def _dither(generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """Rectangular dither in {-1, 0}, drawn on the generator's device and
    moved to the signal's."""
    return torch.randint(-1, 1, tuple(x.shape), generator=generator,
                         device=generator.device).to(x.device)


def dither_16bit_to_8bit(generator: torch.Generator, int_signal,
                         device=DEFAULT_DEVICE) -> torch.Tensor:
    """Rectangular-dither 16->8 bit (Utility.py:86-94): round(x/256) plus
    dither in {-1, 0}, clipped to +-127. Kept int16 like the reference."""
    x = _tensor(int_signal, device)
    out = torch.round(x / 256.0).to(torch.int16)
    out = out + _dither(generator, x).to(torch.int16)
    return torch.clamp(out, -127, 127)


def dither_32bit_to_16bit(generator: torch.Generator, int_signal,
                          device=DEFAULT_DEVICE) -> torch.Tensor:
    """Rectangular-dither 32->16 bit (Utility.py:97-105): round(x/65535) plus
    dither in {-1, 0}, clipped to +-32767, cast int16."""
    x = _tensor(int_signal, device)
    out = torch.round(x / 65535.0).to(torch.int32)
    out = out + _dither(generator, x).to(torch.int32)
    return torch.clamp(out, -32767, 32767).to(torch.int16)
