"""What the loops share: the device's clock and the sizes a cell runs."""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def event(device):
    """A recorded CUDA event (None off the card)."""
    if torch.device(device).type != "cuda":
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def elapsed_ms(pairs: list) -> list[float]:
    """Each (start, end) event pair's milliseconds (after a sync)."""
    return [a.elapsed_time(b) for a, b in pairs if a is not None]


def peak_reserved(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_reserved(device))


def free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def host_threads(config: dict) -> None:
    """PyTorch's host threads as the deployment gives them
    (``host_threads`` in the configuration; PyTorch's default without)."""
    if config.get("host_threads"):
        torch.set_num_threads(int(config["host_threads"]))


def samples(config: dict) -> int:
    """A job's length in samples."""
    return int(round(float(config["length_s"]) * int(config["sample_rate"])))


def log(*parts) -> None:
    print("portbench:", *parts, file=sys.stderr, flush=True)


def settle() -> None:
    """End of set-up: collect, then leave what set-up made out of later
    collections, so that a collection in the window walks only what the
    window made."""
    gc.collect()
    gc.freeze()


class Phases:
    """Set-up's phases by the host clock, for the log."""

    def __init__(self, t_start: float):
        self.last = t_start
        self.done = []

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.done.append(f"{name} {now - self.last:.2f} s")
        self.last = now

    def log(self) -> None:
        log("set-up:", ", ".join(self.done))


class Rows:
    """Rows of a fixed width appended block by block into preallocated
    chunks (no allocation a step in the window)."""

    CHUNK = 8192

    def __init__(self, rows: int, width: int, dtype=np.float32):
        self.rows, self.width, self.dtype = rows, width, dtype
        self.chunks = []
        self.n = 0

    def append(self, block: np.ndarray, rows: list[int]) -> None:
        """Append ``block[rows]``, row by row."""
        k = self.n % self.CHUNK
        if k == 0:
            self.chunks.append(np.empty((self.rows, self.CHUNK * self.width),
                                        dtype=self.dtype))
        chunk = self.chunks[-1]
        lo = k * self.width
        for i, r in enumerate(rows):
            chunk[i, lo:lo + self.width] = block[r]
        self.n += 1

    def array(self) -> np.ndarray:
        if not self.chunks:
            return np.empty((self.rows, 0), dtype=self.dtype)
        return np.concatenate(self.chunks, axis=1)[:, :self.n * self.width]
