"""PyTorch/CUDA port, the realtime runtime (``runtime/native_lib.py``,
``runtime/realtime.py``): the port's own copy of the C++ SPSC ring and
deadline stats, built with g++ into the package's ``_build/``, and the
RealtimeEngine's pump around the port's StreamProcessor, held bit for bit to
the processor's own fold and to the JAX package's engine on the same input.
"""

import threading
import time

import numpy as np
import pytest
import torch

import pyaudiodsptools_tpu as jx
import pyaudiodsptools_tpu_torch as pt
from pyaudiodsptools_tpu.runtime import RealtimeEngine as JxEngine
from pyaudiodsptools_tpu.runtime import native_lib as jx_native
from pyaudiodsptools_tpu_torch.runtime import RealtimeEngine, native_lib

from torch_port_util import snr_db

B = 512


@pytest.fixture
def native():
    """The native library, built if need be; skips where g++ is missing."""
    if not native_lib.available():
        pytest.skip("g++ is not available to build the native runtime")
    return native_lib


def test_library_is_built_into_the_package_build_directory(native):
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "pyaudiodsptools_tpu_torch"
    assert path.name.startswith("libpadt_runtime-")


def test_ring_roundtrip(native):
    ring = native.NativeRing(1024)
    assert ring.capacity == 1024
    data = np.arange(300, dtype=np.float32)
    assert ring.write(data) == 300
    assert ring.available() == 300
    np.testing.assert_array_equal(ring.read(300), data)
    assert ring.available() == 0
    assert native.NativeRing(1000).capacity == 1024     # power of two


def test_ring_wraparound_and_partial(native):
    ring = native.NativeRing(256)
    for it in range(10):  # force index wrap
        data = np.full(200, it, dtype=np.float32)
        assert ring.write(data) == 200
        np.testing.assert_array_equal(ring.read(200), data)
    # overfill: partial write
    assert ring.write(np.ones(1000, dtype=np.float32)) == 256
    assert ring.space() == 0
    # underrun: read_block zero-fills and reports the xrun
    ring.read(256)
    blk, ok = ring.read_block(128)
    assert not ok and np.all(blk == 0.0)
    ring.write(np.arange(128, dtype=np.float32))
    blk, ok = ring.read_block(128)
    assert ok and np.array_equal(blk, np.arange(128, dtype=np.float32))


def test_ring_threaded_spsc(native):
    ring = native.NativeRing(4096)
    n = 200_000
    src = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    received = []

    def producer():
        i = 0
        while i < n:
            i += ring.write(src[i:i + 512])

    def consumer():
        got = 0
        while got < n:
            out = ring.read(512)
            if out.size:
                received.append(out)
                got += out.size

    threads = [threading.Thread(target=producer),
               threading.Thread(target=consumer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    np.testing.assert_array_equal(np.concatenate(received), src)


def test_pump_stats_count_xruns_against_the_deadline(native):
    stats = native.PumpStats(1000)
    for ns in (10, 999, 1000, 1001, 5000):
        stats.record(ns)
    assert stats.snapshot() == {"blocks": 5, "xruns": 2,
                                "mean_ns": (10 + 999 + 1000 + 1001 + 5000)
                                // 5, "worst_ns": 5000}


def _effects(pkg, cfg, **kw):
    return [pkg.ops.lowcut(cfg, 300.0, **kw), pkg.ops.softclipper(cfg, **kw)]


def _signal(n_blocks: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(B * n_blocks) * 0.3).astype(np.float32)


def _through_engine(eng, sig: np.ndarray, chunk: int = 2048,
                    timeout: float = 60.0) -> np.ndarray:
    """Push everything in chunks and pull what is ready until every sample
    is out (the consumer never leaves the output ring unattended, whatever
    the ring sizes), then stop."""
    eng.start()
    outs, got, i = [], 0, 0
    deadline = time.monotonic() + timeout
    try:
        while got < sig.size and time.monotonic() < deadline:
            if i < sig.size:
                i += eng.push(sig[i:i + chunk])
            out = eng.pull(sig.size - got)
            if out.size:
                outs.append(out)
                got += out.size
            else:
                time.sleep(0.0005)
    finally:
        eng.stop()
    return np.concatenate(outs) if outs else np.zeros(0, np.float32)


def _fold(chain, cfg, sig: np.ndarray) -> np.ndarray:
    sp = pt.StreamProcessor(chain, cfg)
    return np.concatenate([sp.process(sig[i:i + cfg.block_size])
                           for i in range(0, sig.size, cfg.block_size)])


def test_engine_equals_the_stream_fold_and_the_jax_engine(native):
    cfg = pt.EngineConfig(44100, B)
    chain = pt.Chain(_effects(pt, cfg, device="cpu"), device="cpu")
    sig = _signal(12)

    out = _through_engine(RealtimeEngine(chain, cfg), sig)
    want = _fold(chain, cfg, sig)
    assert out.size == sig.size
    np.testing.assert_array_equal(out, want)

    jcfg = jx.EngineConfig(44100, B)
    if not jx_native.available():
        pytest.skip("the JAX package's native runtime does not build here")
    jeng = JxEngine(jx.Chain(_effects(jx, jcfg)), jcfg)
    jout = _through_engine(jeng, sig)
    assert jout.size == sig.size
    assert snr_db(jout, out) >= 100.0


def test_engine_stats_and_ring_lag(native):
    cfg = pt.EngineConfig(44100, B)
    chain = pt.Chain(_effects(pt, cfg, device="cpu"), device="cpu")
    eng = RealtimeEngine(chain, cfg, ring_blocks=8)
    assert eng.in_ring.capacity == 8 * B
    sig = _signal(30, seed=2)
    out = _through_engine(eng, sig, chunk=700)   # ragged pushes
    np.testing.assert_array_equal(out, _fold(chain, cfg, sig))
    stats = eng.stats()
    assert stats["blocks"] == 30 and stats["dropped_samples"] == 0
    assert 0 < stats["mean_ns"] <= stats["worst_ns"]


def test_pump_warms_up_on_the_starting_thread_and_steps_in_inference_mode(
        native, monkeypatch):
    cfg = pt.EngineConfig(44100, B)
    chain = pt.Chain(_effects(pt, cfg, device="cpu"), device="cpu")
    eng = RealtimeEngine(chain, cfg)
    seen = {}
    warmup, process = eng.processor.warmup, eng.processor.process

    def traced_warmup():
        seen["warmup"] = threading.current_thread()
        warmup()

    def traced_process(block):
        seen["step"] = (threading.current_thread(),
                        torch.is_inference_mode_enabled())
        return process(block)

    monkeypatch.setattr(eng.processor, "warmup", traced_warmup)
    monkeypatch.setattr(eng.processor, "process", traced_process)
    out = _through_engine(eng, _signal(3, seed=3))
    assert out.size == 3 * B
    assert seen["warmup"] is threading.main_thread()
    assert seen["step"][0] is not threading.main_thread()
    assert seen["step"][1] is True
    assert not torch.is_inference_mode_enabled()


def test_a_failing_step_is_raised_by_stop(native, monkeypatch):
    cfg = pt.EngineConfig(44100, B)
    chain = pt.Chain(_effects(pt, cfg, device="cpu"), device="cpu")
    eng = RealtimeEngine(chain, cfg)

    def broken(block):
        raise ValueError("step failed")

    monkeypatch.setattr(eng.processor, "process", broken)
    eng.start()
    eng.push(_signal(2, seed=4))
    eng.drain(timeout=5.0)
    with pytest.raises(RuntimeError, match="pump failed") as info:
        eng.stop()
    assert isinstance(info.value.__cause__, ValueError)


@pytest.mark.cuda
def test_cuda_engine_equals_the_stream_fold_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    if not native_lib.available():
        pytest.skip("g++ is not available to build the native runtime")
    cfg = pt.EngineConfig(44100, B)
    chain = pt.Chain([pt.ops.lowcut(cfg, 300.0), pt.ops.compressor(cfg),
                      pt.ops.gate(cfg), pt.ops.softclipper(cfg)])
    sig = _signal(64, seed=5)
    out = _through_engine(RealtimeEngine(chain, cfg), sig)
    np.testing.assert_array_equal(out, _fold(chain, cfg, sig))
