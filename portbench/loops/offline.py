"""The offline loop: one caller renders whole jobs back to back.

A job is ``render(chain, x, cfg)`` of a (channels, length) signal on the
device, complete when its output is synchronised. The signals are a ring
of ``ring`` made from the seed, so consecutive jobs differ and the shape
repeats. The traffic file gives ``block_size``, ``ring``, ``signal`` and
``check`` (``jobs`` sampled from the seed, one channel from each of
``groups`` runs of channels)."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import check, geometry, port, signals
from portbench.loops import common
from portbench.record import Run
from portbench.trace import Profile

# Jobs are sampled for the check from the first WINDOW_SHARE of the jobs
# the warm-up's time predicts for the window.
WINDOW_SHARE = 0.8


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, render=None) -> tuple[Run, dict]:
    config, traffic = cell.config, cell.traffic
    B = int(traffic["block_size"])
    C = int(config["channels"])
    sr = int(config["sample_rate"])
    n = common.samples(config)
    on_card = torch.device(device).type == "cuda"
    phase = common.Phases(t_start)
    chain, cfg = port.chain(config, B, device)
    render = render or port.pt.render
    phase("imports and chain")
    ring = [signals.make(traffic["signal"], C, n, sr,
                         signals.seed_for(seed, k), device)
            for k in range(int(traffic["ring"]))]
    common.sync(device)
    phase("signals")
    # the first render captures; every ring entry, and a replay, before
    # the window
    for k in range(max(2, len(ring))):
        t0 = time.perf_counter()
        out = render(chain, ring[k % len(ring)], cfg)
        common.sync(device)
        warm_s = time.perf_counter() - t0
        del out
    chans = check.sample_channels(C, int(traffic["check"]["groups"]), seed)
    keep = set(check.sample_jobs(
        int(traffic["check"]["jobs"]),
        int(WINDOW_SHARE * seconds / max(warm_s, 1e-6)), seed))
    rec = Run(cell=cell.name, loop="offline",
              geometry=geometry.of(config, B, C, n))
    kept, pairs = {}, []
    common.settle()
    phase("build, load, capture and warm-up")
    phase.log()
    prof = Profile(trace)
    rec.setup_s = time.perf_counter() - t_start
    with prof.window():
        w0 = time.perf_counter()
        i = 0
        while True:
            e0 = common.event(device) if trace else None
            t0 = time.perf_counter()
            out = render(chain, ring[i % len(ring)], cfg)
            t1 = time.perf_counter()
            e1 = common.event(device) if trace else None
            common.sync(device)
            t2 = time.perf_counter()
            rec.host_ms.append((t2 - t0) * 1e3)
            rec.call_ms.append((t1 - t0) * 1e3)
            if trace:
                pairs.append((e0, e1))
                if on_card:
                    rec.walks.append(port.walks_of(chain))
            if i in keep:
                kept[i] = out.reshape(C, -1)[chans, :n].clone()
            del out
            i += 1
            if t2 - w0 >= seconds:
                break
    rec.window_s = t2 - w0
    rec.units = rec.traced_units = i
    rec.samples = i * C * n
    rec.device_ms = common.elapsed_ms(pairs)
    rec.peak_reserved = common.peak_reserved(device)
    if trace:
        rec.profile = prof.summary()
    # the program's state freed before the reference runs
    inputs = {j: ring[j % len(ring)][chans].clone() for j in kept}
    if on_card:
        chain.captured_render().release()
    del ring, chain
    common.free(device)
    return rec, {"compare": lambda: compare(config, B, n, kept, inputs,
                                            chans)}


def compare(config, B: int, n: int, kept: dict, inputs: dict,
            chans: list) -> dict:
    per_job = []
    T = -(-n // B) * B
    for j in sorted(kept):
        x = torch.nn.functional.pad(inputs[j].to(torch.float64), (0, T - n))
        want = check.reference(config, x, B)[:, :n]
        per_job.append(check.rel_errs(kept[j], want))
        worst = int(np.argmax(per_job[-1]))
        common.log(f"job {j} channels {chans}: rel err",
                   ["%.3e" % e for e in per_job[-1]],
                   "; the worst channel's error energy in its worst 0.01 %"
                   " of samples: "
                   f"{check.error_share(kept[j][worst], want[worst]):.3f}")
    return check.numbers(per_job)
