"""Import-gated audio-device adapter: real duplex hardware around the engine.

Counterpart of ``pyaudiodsptools_tpu/runtime/portaudio.py``. The reference's
Example3 drives a PyAudio duplex stream with the effect in the stream
callback (Example3.py:28-46, frames_per_buffer = config.chunk_size, float32
mono). This adapter provides the same surface for ``RealtimeEngine``: the
audio callback only moves samples between the device and the engine's
wait-free SPSC rings (never blocks, never calls into PyTorch), while the
engine's pump thread runs the chain's streaming step on the card -- the
callback thread stays deadline-safe even when a step stalls.

Backends, by preference:
  * ``sounddevice`` (PortAudio via CFFI) -- ``sd.Stream`` duplex callback.
  * ``pyaudio`` -- the reference's own backend, callback mode.

Neither library is a dependency; everything here degrades cleanly:
``available_backend()`` returns None and ``DuplexAudioStream`` raises a
clear RuntimeError, so importing this module is always safe (the adapter
activates wherever a user installs one of the libraries).
"""

from __future__ import annotations

import numpy as np

from .realtime import RealtimeEngine


def _try_import(name: str):
    try:
        return __import__(name)
    except Exception:  # pragma: no cover - depends on host audio stack
        return None


def available_backend() -> str | None:
    """'sounddevice', 'pyaudio', or None — checked in preference order."""
    if _try_import("sounddevice") is not None:
        return "sounddevice"
    if _try_import("pyaudio") is not None:
        return "pyaudio"
    return None


class DuplexAudioStream:
    """Full-duplex mono audio through a RealtimeEngine (Example3 parity).

    >>> eng = RealtimeEngine(chain, cfg)
    >>> with DuplexAudioStream(eng) as stream:
    ...     time.sleep(10)           # audio in -> chain -> audio out
    >>> eng.stats()                  # deadline stats incl. device underruns

    The device block size follows ``cfg.block_size`` like the reference
    (Example3.py:36 ``frames_per_buffer=pyAudioDspTools.chunk_size``).
    Output underruns (engine not keeping up) are padded with silence and
    counted in ``underrun_samples``.
    """

    def __init__(self, engine: RealtimeEngine, device=None,
                 backend: str | None = None):
        self.engine = engine
        self.device = device
        self.backend = backend or available_backend()
        if self.backend is None:
            raise RuntimeError(
                "no audio backend available: install 'sounddevice' "
                "(preferred) or 'pyaudio' to stream from real hardware")
        self.underrun_samples = 0     # output padded with silence (engine late)
        self.overrun_samples = 0      # input dropped (in-ring full)
        self._stream = None

    # -- backend wiring -----------------------------------------------------

    def _push_in(self, samples: np.ndarray) -> None:
        accepted = self.engine.push(samples)
        if accepted < samples.size:
            self.overrun_samples += samples.size - accepted

    def _pull_out(self, frames: int) -> np.ndarray:
        out = self.engine.pull(frames)
        if out.size < frames:
            self.underrun_samples += frames - out.size
            out = np.concatenate(
                [out, np.zeros(frames - out.size, np.float32)])
        return out

    def _start_sounddevice(self):
        import sounddevice as sd

        cfg = self.engine.cfg

        def callback(indata, outdata, frames, time_info, status):
            self._push_in(np.ascontiguousarray(indata[:, 0]))
            outdata[:, 0] = self._pull_out(frames)

        self._stream = sd.Stream(
            samplerate=cfg.sample_rate, blocksize=cfg.block_size,
            channels=1, dtype="float32", device=self.device,
            callback=callback)
        self._stream.start()

    def _start_pyaudio(self):
        import pyaudio

        cfg = self.engine.cfg
        self._pa = pyaudio.PyAudio()

        def callback(in_data, frame_count, time_info, status):
            self._push_in(np.frombuffer(in_data, dtype=np.float32))
            out = self._pull_out(frame_count)
            return (out.tobytes(), pyaudio.paContinue)

        # Mirrors the reference's stream setup (Example3.py:31-38): float32,
        # mono, duplex, frames_per_buffer = block size, callback mode.
        self._stream = self._pa.open(
            format=pyaudio.paFloat32, channels=1, rate=cfg.sample_rate,
            input=True, output=True, frames_per_buffer=cfg.block_size,
            stream_callback=callback,
            **({"input_device_index": self.device,
                "output_device_index": self.device}
               if self.device is not None else {}))
        self._stream.start_stream()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "DuplexAudioStream":
        self.engine.start()
        if self.backend == "sounddevice":
            self._start_sounddevice()
        else:
            self._start_pyaudio()
        return self

    def stop(self) -> None:
        if self._stream is not None:
            if self.backend == "sounddevice":
                self._stream.stop()
                self._stream.close()
            else:
                self._stream.stop_stream()
                self._stream.close()
                self._pa.terminate()
            self._stream = None
        self.engine.stop()

    def __enter__(self) -> "DuplexAudioStream":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
