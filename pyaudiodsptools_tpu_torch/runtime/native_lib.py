"""ctypes bindings for the native runtime (``native/padt_runtime.cpp``).

Counterpart of ``pyaudiodsptools_tpu/runtime/native_lib.py``. The shared
library is built on first use with ``g++`` into the package's ``_build/``
directory (beside the CUDA kernels' libraries), as
``libpadt_runtime-<hash>.so``, the hash covering the source and the compiler
flags, so an edit rebuilds and the source tree is never written to. A failed
build raises with the compiler's output. :func:`available` is a query (False
where there is no ``g++``), for callers and tests that want to skip; nothing
here swaps in a Python ring.

ctypes releases the interpreter lock for the duration of every call, so a
producer, the pump and a consumer each calling into the rings do not hold
each other up beyond the Python around the calls.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "native" / "padt_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libpadt_runtime-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}.so")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError:
        raise RuntimeError(
            "g++ was not found: the realtime runtime's native library "
            f"({_SRC.name}) is compiled at first use") from None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed:\n$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)


def load():
    """Load (building if needed) the native library; raises on failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.padt_ring_create.restype = ctypes.c_void_p
        lib.padt_ring_create.argtypes = [ctypes.c_size_t]
        lib.padt_ring_destroy.argtypes = [ctypes.c_void_p]
        for f in ("padt_ring_capacity", "padt_ring_available",
                  "padt_ring_space"):
            getattr(lib, f).restype = ctypes.c_size_t
            getattr(lib, f).argtypes = [ctypes.c_void_p]
        for f in ("padt_ring_write", "padt_ring_read",
                  "padt_ring_read_or_silence"):
            getattr(lib, f).restype = ctypes.c_size_t
            getattr(lib, f).argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_size_t,
            ]
        lib.padt_stats_create.restype = ctypes.c_void_p
        lib.padt_stats_create.argtypes = [ctypes.c_uint64]
        lib.padt_stats_destroy.argtypes = [ctypes.c_void_p]
        lib.padt_stats_record.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        for f in ("padt_stats_blocks", "padt_stats_xruns",
                  "padt_stats_total_ns", "padt_stats_worst_ns"):
            getattr(lib, f).restype = ctypes.c_uint64
            getattr(lib, f).argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library builds and loads on this machine."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeRing:
    """Wait-free SPSC float32 ring buffer backed by C++ (capacity rounded up
    to a power of two)."""

    def __init__(self, capacity: int):
        self._lib = load()
        self._ptr = self._lib.padt_ring_create(capacity)
        if not self._ptr:  # pragma: no cover
            raise MemoryError("padt_ring_create failed")

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.padt_ring_destroy(self._ptr)
            self._ptr = None

    @property
    def capacity(self) -> int:
        return self._lib.padt_ring_capacity(self._ptr)

    def available(self) -> int:
        return self._lib.padt_ring_available(self._ptr)

    def space(self) -> int:
        return self._lib.padt_ring_space(self._ptr)

    def write(self, samples: np.ndarray) -> int:
        """Producer side: returns the samples written (fewer when full)."""
        samples = np.ascontiguousarray(samples, dtype=np.float32)
        return self._lib.padt_ring_write(self._ptr, _fptr(samples),
                                         samples.size)

    def read(self, n: int) -> np.ndarray:
        """Consumer side: up to ``n`` samples (fewer when drained)."""
        out = np.empty(n, dtype=np.float32)
        got = self._lib.padt_ring_read(self._ptr, _fptr(out), n)
        return out[:got]

    def read_block(self, n: int) -> tuple[np.ndarray, bool]:
        """Always returns n samples, zero-filled on underrun; second value is
        True when a full block was available (no xrun)."""
        out = np.empty(n, dtype=np.float32)
        got = self._lib.padt_ring_read_or_silence(self._ptr, _fptr(out), n)
        return out, got == n


class PumpStats:
    """Deadline accounting (blocks processed, xruns, mean/worst ns)."""

    def __init__(self, deadline_ns: int):
        self._lib = load()
        self._ptr = self._lib.padt_stats_create(deadline_ns)
        if not self._ptr:  # pragma: no cover
            raise MemoryError("padt_stats_create failed")

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.padt_stats_destroy(self._ptr)
            self._ptr = None

    def record(self, elapsed_ns: int) -> None:
        self._lib.padt_stats_record(self._ptr, elapsed_ns)

    def snapshot(self) -> dict:
        blocks = self._lib.padt_stats_blocks(self._ptr)
        total = self._lib.padt_stats_total_ns(self._ptr)
        return {
            "blocks": blocks,
            "xruns": self._lib.padt_stats_xruns(self._ptr),
            "mean_ns": total // blocks if blocks else 0,
            "worst_ns": self._lib.padt_stats_worst_ns(self._ptr),
        }
