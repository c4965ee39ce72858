"""Realtime engine: native ring buffers around the captured chain step.

Counterpart of ``pyaudiodsptools_tpu/runtime/realtime.py``. The reference's
realtime story is a PyAudio duplex stream whose C callback thread calls
device.apply (Example3.py:20-46). Here:

  audio producer ──> NativeRing (in) ──> pump thread: chain step on the card
                                            │
  audio consumer <── NativeRing (out) <─────┘

The pump thread pops fixed blocks, steps them through a
:class:`~..engine.stream.StreamProcessor` (numpy in, numpy out: one copy to
the chain's device, one replay of the step's CUDA graph, one copy back, which
waits for the step), pushes the results, and records deadline stats in the
native layer (blocks, xruns, worst-case ns against the
block_size/sample_rate budget -- the reference documents this budget in
ModuleTests.py:24).

Two things differ from the JAX engine because PyTorch runs on the calling
thread:

* :meth:`RealtimeEngine.start` runs the processor's ``warmup`` on the
  starting thread BEFORE the pump thread starts: every kernel is built and
  loaded there and the step is captured there (``engine/graph.py``), so the
  pump only replays and never meets a build or a capture. The capture itself
  runs in ``capture_error_mode="thread_local"``, so that other threads of the
  process (another engine's pump) cannot invalidate it either;
* the pump sets its own grad mode (``torch.inference_mode``, which is
  thread-local) and its own current CUDA device.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..core.config import EngineConfig
from ..engine.chain import Chain
from ..engine.stream import StreamProcessor
from . import native_lib


class RealtimeEngine:
    """Push/pull streaming around a chain with native SPSC rings. The chain
    runs on its own device: the card unless it was built for the CPU.

    >>> eng = RealtimeEngine(chain, cfg)
    >>> eng.start()
    >>> eng.push(samples)          # producer thread (e.g. audio input)
    >>> out = eng.pull(n)          # consumer thread (e.g. audio output)
    >>> eng.stop(); eng.stats()
    """

    def __init__(self, chain: Chain, cfg: EngineConfig,
                 ring_blocks: int = 64):
        self.cfg = cfg
        self.processor = StreamProcessor(chain, cfg)
        capacity = ring_blocks * cfg.block_size
        self.in_ring = native_lib.NativeRing(capacity)
        self.out_ring = native_lib.NativeRing(capacity)
        deadline_ns = int(1e9 * cfg.block_size / cfg.sample_rate)
        self._stats = native_lib.PumpStats(deadline_ns)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._busy = threading.Event()  # pump holds a popped, unwritten block
        self._error: Exception | None = None
        self.dropped_samples = 0        # output-ring overflow loss (counted)

    def start(self) -> None:
        """Build and load every kernel and capture the step on this thread,
        then start the pump."""
        self.processor.warmup()
        self._stop.clear()
        self._error = None
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the pump; raises what the pump raised, if it failed."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._error is not None:
            raise RuntimeError("the realtime pump failed") from self._error

    def push(self, samples: np.ndarray) -> int:
        """Producer side: enqueue input samples; returns count accepted."""
        return self.in_ring.write(samples)

    def pull(self, n: int) -> np.ndarray:
        """Consumer side: dequeue up to n processed samples."""
        return self.out_ring.read(n)

    def drain(self, timeout: float = 10.0) -> None:
        """Block until all queued input has been processed AND its output
        written to the out ring (a popped block in flight counts as queued),
        or the pump has stopped."""
        deadline = time.monotonic() + timeout
        B = self.cfg.block_size
        while ((self.in_ring.available() >= B or self._busy.is_set())
               and self._thread is not None and self._thread.is_alive()
               and time.monotonic() < deadline):
            time.sleep(0.001)

    def stats(self) -> dict:
        s = self._stats.snapshot()
        s["dropped_samples"] = self.dropped_samples
        return s

    def _pump(self) -> None:
        device = self.processor.chain.device
        try:
            if device.type == "cuda" and device.index is not None:
                torch.cuda.set_device(device)
            with torch.inference_mode():
                self._pump_loop()
        except Exception as exc:  # reported by stop()
            self._error = exc
            self._busy.clear()

    def _pump_loop(self) -> None:
        B = self.cfg.block_size
        while not self._stop.is_set():
            if self.in_ring.available() < B:
                time.sleep(0.0005)
                continue
            self._busy.set()
            block = self.in_ring.read(B)
            t0 = time.perf_counter_ns()
            out = self.processor.process(block)
            elapsed = time.perf_counter_ns() - t0
            self._stats.record(elapsed)
            # A full out ring means the consumer is behind: retry briefly
            # rather than silently dropping; count whatever is still lost so
            # misalignment is observable (stats()['dropped_samples']).
            written = self.out_ring.write(out)
            tries = 0
            while written < len(out) and tries < 200 \
                    and not self._stop.is_set():
                time.sleep(0.0005)
                written += self.out_ring.write(out[written:])
                tries += 1
            if written < len(out):
                self.dropped_samples += len(out) - written
            self._busy.clear()
