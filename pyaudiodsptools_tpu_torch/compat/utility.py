"""Reference-compatible host utility functions (numpy in, numpy out).

Counterpart of ``pyaudiodsptools_tpu/compat/utility.py``: the public
functions of pyAudioDspTools ``Utility.py`` and ``Generators.py`` with their
exact semantics, including ``MakeChunks``'s pad-condition quirk
(``core.block.legacy_chunk_sizes``), so that migrated scripts behave the
same. The tensor equivalents are ``core.utility``, ``core.generators`` and
``core.block``. The dithers and the white noise take an optional
``numpy.random.Generator`` where the reference draws unseeded numbers.
"""

from __future__ import annotations

import math

import numpy as np

from ..core import block, wavio
from . import config as _config


# -- chunking ---------------------------------------------------------------

def MakeChunks(float32_array_input):
    sizes = block.legacy_chunk_sizes(len(float32_array_input),
                                     _config.chunk_size)
    pad = len(sizes) * sizes[0] - len(float32_array_input)
    if pad:
        float32_array_input = np.append(float32_array_input,
                                        np.zeros(pad, dtype="float32"))
    return np.split(float32_array_input, len(sizes))


def CombineChunks(float_array_input):
    return np.concatenate([np.asarray(c) for c in float_array_input]).astype(
        np.float32, copy=False)


# -- mixing / gain / metering ----------------------------------------------

def MixSignals(*args):
    mixed = np.zeros(len(args[0]))
    for signal in args:
        mixed = mixed + signal
    return np.clip(mixed, -1.0, 1.0)


def VolumeChange(float_array_input, gain_change_in_db,
                 overflow_protection=True):
    out = (10 ** (gain_change_in_db / 20)) * float_array_input
    if overflow_protection:
        out = np.clip(out, -1.0, 1.0)
    return out


def InfodBV(float_array_input):
    return 20 * math.log10(np.abs(float_array_input).sum()
                           / float_array_input.size)


def InfodBV16Bit(int_array_input):
    amp = (np.abs(int_array_input).sum() / int_array_input.size) / 32767
    return 20 * math.log10(amp)


# -- bit depth / dither -----------------------------------------------------

def ConvertdBVTo16Bit(float_array_input):
    return np.int16(np.clip(float_array_input, -1.0, 1.0) * (2 ** 15 - 1))


def Convert16BitTodBV(int_array_input):
    return np.float32(int_array_input / 32767)


def Dither16BitTo8Bit(int_array_input,
                      rng: np.random.Generator | None = None):
    rng = rng or np.random.default_rng()
    dither = rng.integers(-1, 1, size=int_array_input.size)
    out = np.around(int_array_input / 256, decimals=0).astype("int16")
    return np.clip(out + dither, -127, 127)


def Dither32BitIntTo16BitInt(int_array_input,
                             rng: np.random.Generator | None = None):
    rng = rng or np.random.default_rng()
    dither = rng.integers(-1, 1, size=int_array_input.size)
    out = np.around(int_array_input / 65535, decimals=0).astype("int32")
    return np.clip(out + dither, -32767, 32767).astype("int16")


# -- wav I/O ---------------------------------------------------------------

def MonoWavToNumpyFloat(wav_file_path):
    return wavio.mono_wav_to_float(wav_file_path)


def MonoWavToNumpy16BitInt(wav_file_path):
    return wavio.mono_wav_to_int16(wav_file_path)


def StereoWavToNumpyFloat(wav_file_path):
    return wavio.stereo_wav_to_float(wav_file_path)


def NumpyFloatToWav(wav_file_path, numpy_array):
    wavio.write_wav(wav_file_path, np.asarray(numpy_array),
                    _config.sampling_rate)


# -- generators (Generators.py parity, host-side) ---------------------------

def CreateSinewave(sin_frequency, sin_length_in_samples):
    t = np.arange(sin_length_in_samples)
    return np.float32(np.sin(2 * np.pi * sin_frequency * t
                             / _config.sampling_rate))


def CreateSquarewave(square_frequency, square_length_in_samples):
    s = CreateSinewave(square_frequency, square_length_in_samples)
    return np.where(s > 0, 1.0, -1.0).astype(np.float32)


def CreateWhitenoise(noise_length_in_samples,
                     rng: np.random.Generator | None = None):
    rng = rng or np.random.default_rng()
    n = noise_length_in_samples
    freqs = np.abs(np.fft.fftfreq(n, 1 / _config.sampling_rate))
    f = np.zeros(n, dtype=complex)
    f[(freqs >= 20) & (freqs <= 20000)] = 1
    n_pos = (n - 1) // 2
    phases = rng.random(n_pos) * 2 * np.pi
    f[1:n_pos + 1] *= np.cos(phases) + 1j * np.sin(phases)
    f[-1:-1 - n_pos:-1] = np.conj(f[1:n_pos + 1])
    return np.float32(np.fft.ifft(f).real * 5)
