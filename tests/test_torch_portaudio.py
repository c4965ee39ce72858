"""PyTorch/CUDA port, the audio-device adapter (``runtime/portaudio.py``):
callback wiring and import gating, as ``tests/test_portaudio.py`` holds the
JAX package's.

No audio hardware or PortAudio binding is installed, so the duplex callback
path runs against FAKE ``sounddevice`` and ``pyaudio`` modules whose streams
call back from a clock thread: the adapter code under test is what a real
installation runs. The output must equal the port's StreamProcessor fold
over the same input bit for bit, after the ring's whole-block lag."""

import sys
import threading
import time
import types

import numpy as np
import pytest

import pyaudiodsptools_tpu_torch as pt
from pyaudiodsptools_tpu_torch.runtime import RealtimeEngine, native_lib
from pyaudiodsptools_tpu_torch.runtime import portaudio as pa_mod
from pyaudiodsptools_tpu_torch.runtime.portaudio import (DuplexAudioStream,
                                                         available_backend)

import torch_port_util  # noqa: F401  (the test processes' thread limits)

B = 512
N_BLOCKS = 150


class _Clock:
    """Calls ``deliver(in_block) -> out_block`` once a block from a thread.

    Before each call after the first it waits until the engine has the
    previous block's output ready, which models hardware meeting its
    deadline (the chain's step takes a fraction of the 11.6 ms a block
    lasts; the wait is long so that a loaded test machine does not turn it
    into an underrun): the test holds the WIRING exactly."""

    engine = None  # bound by the test before start()

    def __init__(self, blocksize: int, deliver):
        self.blocksize = blocksize
        self._deliver = deliver
        self._stop = threading.Event()
        self.captured = []
        rng = np.random.default_rng(3)
        self.input = (rng.standard_normal((N_BLOCKS, blocksize)) * 0.25
                      ).astype(np.float32)
        self.i = 0

    def _run(self):
        while not self._stop.is_set() and self.i < N_BLOCKS:
            if self.engine is not None and self.i >= 1:
                deadline = time.monotonic() + 30.0
                while (self.engine.out_ring.available() < self.blocksize
                       and time.monotonic() < deadline):
                    time.sleep(0.0005)
            self.captured.append(self._deliver(self.input[self.i]))
            self.i += 1

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
        assert not self._thread.is_alive()

    def wait(self, timeout: float = 120.0):
        deadline = time.monotonic() + timeout
        while self.i < N_BLOCKS and time.monotonic() < deadline:
            time.sleep(0.01)


class _FakeSoundDeviceStream(_Clock):
    """``sounddevice.Stream``: (indata, outdata, frames, time, status)."""

    def __init__(self, samplerate, blocksize, channels, dtype, device,
                 callback):
        assert channels == 1 and dtype == "float32"

        def deliver(block):
            outdata = np.zeros((blocksize, 1), np.float32)
            callback(block[:, None], outdata, blocksize, None, None)
            return outdata[:, 0].copy()

        super().__init__(blocksize, deliver)

    def close(self):
        pass


class _FakePyAudio:
    """``pyaudio.PyAudio`` in callback mode: (in_data, frames, time, status)
    -> (out bytes, flag)."""

    paFloat32 = 1
    paContinue = 0
    terminated = False

    def open(self, format, channels, rate, input, output, frames_per_buffer,
             stream_callback, **kw):
        assert format == self.paFloat32 and channels == 1
        assert input and output

        def deliver(block):
            out, flag = stream_callback(block.tobytes(), frames_per_buffer,
                                        None, 0)
            assert flag == self.paContinue
            return np.frombuffer(out, dtype=np.float32).copy()

        stream = _Clock(frames_per_buffer, deliver)
        stream.start_stream = stream.start
        stream.stop_stream = stream.stop
        stream.close = lambda: None
        return stream

    def terminate(self):
        type(self).terminated = True


def _fake_sounddevice():
    fake = types.ModuleType("sounddevice")
    fake.Stream = _FakeSoundDeviceStream
    return fake


def _fake_pyaudio():
    fake = types.ModuleType("pyaudio")
    fake.PyAudio = _FakePyAudio
    fake.paFloat32 = _FakePyAudio.paFloat32
    fake.paContinue = _FakePyAudio.paContinue
    return fake


@pytest.fixture
def engine():
    if not native_lib.available():
        pytest.skip("g++ is not available to build the native runtime")
    cfg = pt.EngineConfig(44100, B)
    chain = pt.Chain([pt.ops.lowcut(cfg, 200.0, device="cpu"),
                      pt.ops.softclipper(cfg, 0.4, device="cpu")],
                     device="cpu")
    return RealtimeEngine(chain, cfg), cfg, chain


def _check_bit_equal_after_lag(captured, clock_input, chain, cfg, stream):
    assert len(captured) == N_BLOCKS
    assert stream.overrun_samples == 0
    got = np.concatenate(captured)
    sp = pt.StreamProcessor(chain, cfg)
    want = np.concatenate([sp.process(b) for b in clock_input])
    # the first callback finds no output yet: one block of silence, then
    # every block one callback late
    lag = stream.underrun_samples
    assert lag == cfg.block_size, lag
    np.testing.assert_array_equal(got[:lag], 0.0)
    np.testing.assert_array_equal(got[lag:], want[:got.size - lag])


@pytest.mark.parametrize("backend", ["sounddevice", "pyaudio"])
def test_duplex_stream_with_a_fake_backend(engine, monkeypatch, backend):
    eng, cfg, chain = engine
    if backend == "sounddevice":
        monkeypatch.setitem(sys.modules, "sounddevice", _fake_sounddevice())
    else:
        monkeypatch.setitem(sys.modules, "pyaudio", _fake_pyaudio())
        monkeypatch.setattr(pa_mod, "_try_import",
                            lambda name: sys.modules.get(name)
                            if name == "pyaudio" else None)
    monkeypatch.setattr(_Clock, "engine", eng)
    stream = DuplexAudioStream(eng)
    assert stream.backend == backend
    with stream:
        clock = stream._stream
        clock.wait()
        eng.drain()              # the last pushed block, before the stop
    assert stream._stream is None and eng._thread is None
    if backend == "pyaudio":
        assert _FakePyAudio.terminated
    _check_bit_equal_after_lag(clock.captured, clock.input, chain, cfg,
                               stream)
    assert eng.stats()["blocks"] == N_BLOCKS


def test_sounddevice_is_preferred(monkeypatch):
    monkeypatch.setitem(sys.modules, "sounddevice", _fake_sounddevice())
    monkeypatch.setitem(sys.modules, "pyaudio", _fake_pyaudio())
    assert available_backend() == "sounddevice"
    monkeypatch.setitem(sys.modules, "sounddevice", None)   # import fails
    assert available_backend() == "pyaudio"


def test_no_backend_is_clean_error(engine, monkeypatch):
    monkeypatch.setattr(pa_mod, "_try_import", lambda name: None)
    assert available_backend() is None
    eng, _, _ = engine
    with pytest.raises(RuntimeError, match="sounddevice"):
        DuplexAudioStream(eng)
