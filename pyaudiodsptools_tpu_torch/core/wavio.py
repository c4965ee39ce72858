"""Host-side WAV I/O.

Functional parity with the reference's wave-stdlib readers/writers
(pyAudioDspTools ``Utility.py:197-312``): 16-bit PCM in/out,
int16/32768 scaling on read, x32767 on write. Two deliberate fixes over the
reference (SURVEY.md §7 quirks list):

* the reference's write-time range check uses ``numpy.any`` so it only rejects
  arrays where *no* sample is in range (Utility.py:301-303); we clip instead,
* 24-bit reads exist in the reference only as commented-out dead code
  (Utility.py:107-121); we support them properly.

These run on host (numpy). This is the package's own copy of
``pyaudiodsptools_tpu/core/wavio.py``: the two packages import nothing from
each other.
"""

from __future__ import annotations

import wave

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a PCM wav file to float32 in [-1, 1).

    Returns ``(audio, sample_rate)`` with audio shaped ``(n,)`` for mono or
    ``(channels, n)`` for multichannel. Scaling matches the reference readers:
    int16 / 32768 (Utility.py:237), and int24 / 2**23.
    """
    with wave.open(path, "rb") as f:
        n_channels = f.getnchannels()
        sampwidth = f.getsampwidth()
        n_frames = f.getnframes()
        rate = f.getframerate()
        raw = f.readframes(n_frames)

    if sampwidth == 2:
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        as32 = np.zeros((b.shape[0], 4), dtype=np.uint8)
        as32[:, 1:] = b
        data = (as32.view("<i4").ravel() >> 8).astype(np.float32) / float(2**23)
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / float(2**31)
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:  # pragma: no cover
        raise ValueError(f"unsupported sample width: {sampwidth}")

    if n_channels > 1:
        data = data.reshape(-1, n_channels).T
    return data, rate


def mono_wav_to_float(path: str) -> np.ndarray:
    """Reference-parity mono reader (Utility.py:218-238)."""
    audio, _ = read_wav(path)
    if audio.ndim != 1:
        raise ValueError("expected a mono wav file")
    return audio


def stereo_wav_to_float(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Reference-parity stereo reader returning (left, right)
    (Utility.py:241-276)."""
    audio, _ = read_wav(path)
    if audio.ndim != 2 or audio.shape[0] != 2:
        raise ValueError("This function supports only stereo .wav files.")
    return audio[0], audio[1]


def mono_wav_to_int16(path: str) -> np.ndarray:
    """Reference-parity raw int16 reader (Utility.py:197-216)."""
    with wave.open(path, "rb") as f:
        raw = f.readframes(f.getnframes())
    return np.frombuffer(raw, dtype=np.int16)


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Write float audio in [-1, 1] as 16-bit PCM (Utility.py:278-312 parity:
    x32767 scaling). Accepts ``(n,)``, ``(n, 2)`` or ``(2, n)``; values outside
    [-1, 1] are clipped rather than mis-checked like the reference."""
    audio = np.asarray(audio)
    if audio.ndim == 2 and audio.shape[0] <= 8 and audio.shape[0] < audio.shape[1]:
        audio = audio.T  # (channels, n) -> (n, channels)
    n_channels = 1 if audio.ndim == 1 else audio.shape[1]
    audio = np.clip(audio, -1.0, 1.0)
    int_data = (audio * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(n_channels)
        f.setsampwidth(2)
        f.setframerate(int(sample_rate))
        f.writeframes(int_data.tobytes())
