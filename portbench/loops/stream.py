"""The streaming loop: a realtime callback's blocks, back to back.

A step is ``StreamProcessor.process`` of one (channels, block_size) numpy
block, as an audio callback hands it, until its numpy output is back. The
blocks cycle over a signal of ``signal_seconds`` made from the seed, the
state carried on, from rest at the window's start. The traffic file gives
``block_size``, ``signal_seconds``, ``signal``, ``check`` (one channel
from each of ``groups`` runs of channels, every step) and
``trace_seconds``, the traced share of the window."""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from portbench import check, geometry, port, signals
from portbench.loops import common
from portbench.record import Run
from portbench.trace import Profile

WARM_STEPS = 16


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, process=None) -> tuple[Run, dict]:
    config, traffic = cell.config, cell.traffic
    B = int(traffic["block_size"])
    C = int(config["channels"])
    sr = int(config["sample_rate"])
    nblk = max(1, int(round(float(traffic["signal_seconds"]) * sr / B)))
    phase = common.Phases(t_start)
    chain, cfg = port.chain(config, B, device)
    phase("imports and chain")
    sp = port.pt.StreamProcessor(chain, cfg, batch_shape=(C,))
    sp.warmup()
    if process is None:
        process = sp.process
    else:                                   # a test's broken timed path
        process = functools.partial(process, sp)
    phase("build, load and capture")
    x = signals.make(traffic["signal"], C, nblk * B, sr, seed, device)
    host = x.cpu().numpy()
    del x
    blocks = [np.ascontiguousarray(host[:, k * B:(k + 1) * B])
              for k in range(nblk)]
    phase("signal")
    for k in range(WARM_STEPS):
        process(blocks[k % nblk])
    sp.reset()
    chans = check.sample_channels(C, int(traffic["check"]["groups"]), seed)
    kept = common.Rows(len(chans), B)
    common.settle()
    phase("warm-up")
    phase.log()
    traced_s = traffic.get("trace_seconds") or seconds
    rec = Run(cell=cell.name, loop="stream",
              geometry=geometry.of(config, B, C, B))
    pairs = []
    rec.setup_s = time.perf_counter() - t_start
    steps = 0

    def loop(duration: float, traced: bool) -> float:
        """Steps until ``duration`` seconds have passed; returns them."""
        nonlocal steps
        w0 = time.perf_counter()
        while True:
            e0 = common.event(device) if traced else None
            t0 = time.perf_counter()
            out = process(blocks[steps % nblk])
            t1 = time.perf_counter()
            if traced:
                pairs.append((e0, common.event(device)))
            rec.host_ms.append((t1 - t0) * 1e3)
            kept.append(out, chans)
            steps += 1
            if t1 - w0 >= duration:
                return t1 - w0

    # a traced run traces the first trace_seconds, from the profiler's
    # start, and steps on untraced for the rest of the window
    traced = min(float(traffic.get("trace_seconds") or seconds), seconds) \
        if trace else 0.0
    rec.window_s = 0.0
    if traced:
        prof = Profile(True)
        with prof.window():
            rec.window_s += loop(traced, True)
        rec.traced_units = steps
        rec.device_ms = common.elapsed_ms(pairs)
        rec.profile = prof.summary()
    if seconds > traced:
        rec.window_s += loop(seconds - traced, False)
    rec.units = steps
    rec.samples = steps * C * B
    rec.peak_reserved = common.peak_reserved(device)
    inputs = host[chans]
    del sp, chain, blocks, host
    common.free(device)
    return rec, {"compare": lambda: compare(config, B, nblk, kept, inputs,
                                            chans, device, rec.host_ms)}


def compare(config, B: int, nblk: int, kept: common.Rows, inputs: np.ndarray,
            chans: list, device, host_ms: list) -> dict:
    steps = kept.n
    got = torch.from_numpy(kept.array())
    reps = -(-steps // nblk)
    x = torch.from_numpy(np.tile(inputs, (1, reps))[:, :steps * B]).to(
        device=device, dtype=torch.float64)
    want = check.reference(config, x, B)
    errs = check.rel_errs(got.to(want.device), want)
    worst = int(np.argmax(errs))
    common.log(f"{steps} steps, channels {chans}: rel err",
               ["%.3e" % e for e in errs],
               "; the worst channel's error energy in its worst 0.01 % of"
               " samples: "
               f"{check.error_share(got[worst].to(want.device), want[worst]):.3f};",
               "step ms percentiles 50/90/99/99.9/max",
               ["%.3f" % q for q in np.percentile(
                   host_ms, [50, 90, 99, 99.9, 100])])
    return check.numbers([errs])
