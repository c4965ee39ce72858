"""The sharded loop: one process a card, the same global input on every
rank, ``ShardedRenderer.render`` back to back, the global output back on
every rank.

A job is complete when every rank's output is synchronised; rank 0 ends
the window (a broadcast after each job) so that every rank runs the same
jobs. The traffic file gives ``mesh`` ((channel, time) ranks), and as the
offline loop ``block_size``, ``ring``, ``signal`` and ``check``. Rank 0
checks the sampled channels of the sampled jobs against the reference
once its program is freed; every rank hashes its own copy of them, and a
rank whose copy differs from rank 0's counts in ``ranks_differing``.
Every rank reports the JAX modules it holds once its window has closed
(``run.forbidden_modules``); the launcher passes them on, and the run
then prints no result.

The ranks are started with ``spawn`` after the launcher, which touches no
card, has read the cell; each writes its record to a file in a directory
of the run's ``TMPDIR``, which the launcher reads and removes."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import socket
import tempfile
import time

import torch

from portbench import check, geometry, signals
from portbench.loops import common
from portbench.record import Run

RANK_TIMEOUT_S = 330.0
WINDOW_SHARE = 0.8
DIFFERING = "ranks_differing"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def default_render(renderer, x):
    return renderer.render(x)


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, render=None) -> tuple[Run, dict]:
    import torch.multiprocessing as mp

    c, t = (int(v) for v in cell.traffic["mesh"])
    world = c * t
    wall_start = time.time() - (time.perf_counter() - t_start)
    out_dir = tempfile.mkdtemp(prefix="portbench-ranks-")
    try:
        ctx = mp.get_context("spawn")
        port_no = free_port()
        procs = [ctx.Process(target=rank_main, args=(
            rank, world, port_no, cell, seed, seconds, trace, device,
            wall_start, out_dir, render or default_render))
            for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(10)
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        if bad:
            raise RuntimeError(f"ranks failed (rank, exit code): {bad}")
        ranks = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    lead = ranks[0]
    rec = Run(cell=cell.name, loop="sharded",
              device_name=lead["device_name"],
              setup_s=lead["window_start"] - wall_start,
              window_s=lead["window_s"], units=lead["units"],
              traced_units=lead["units"], samples=lead["samples"],
              host_ms=lead["host_ms"], device_ms=lead["device_ms"],
              peak_reserved=max(r["peak_reserved"] for r in ranks),
              geometry=lead["geometry"], profile=lead["profile"],
              ranks=[{"device_ms_mean": (sum(r["device_ms"])
                                         / len(r["device_ms"])
                                         if r["device_ms"] else None),
                      "profile": r["profile"]} for r in ranks])
    numbers = dict(lead["numbers"])
    numbers[DIFFERING] = sum(1 for r in ranks[1:]
                             if r["digests"] != lead["digests"])
    forbidden = [f"{name} (rank {k})" for k, r in enumerate(ranks)
                 for name in r["forbidden"]]
    return rec, {"compare": lambda: numbers, "forbidden": forbidden}


def rank_main(rank: int, world: int, port_no: int, cell, seed: int,
              seconds: float, trace: bool, device, wall_start: float,
              out_dir: str, render) -> None:
    import torch.distributed as tdist

    from portbench import port
    from portbench.run import forbidden_modules
    from portbench.trace import Profile
    from pyaudiodsptools_tpu_torch.parallel import (ShardedRenderer, dist,
                                                    make_mesh)

    config, traffic = cell.config, cell.traffic
    common.host_threads(config)
    phase = common.Phases(time.perf_counter() - (time.time() - wall_start))
    on_card = torch.device(device).type == "cuda"
    dist.init_distributed(f"localhost:{port_no}", num_processes=world,
                          process_id=rank,
                          backend="nccl" if on_card else "gloo")
    dev = torch.device("cuda", rank) if on_card else torch.device("cpu")
    c, t = (int(v) for v in traffic["mesh"])
    B = int(traffic["block_size"])
    C = int(config["channels"])
    sr = int(config["sample_rate"])
    n = common.samples(config)
    mesh = make_mesh(c, t, device=dev)
    chain, cfg = port.chain(config, B, dev)
    rend = ShardedRenderer(chain, cfg, mesh)
    phase("imports, mesh and chain")
    ring = [signals.make(traffic["signal"], C, n, sr,
                         signals.seed_for(seed, k), dev)
            for k in range(int(traffic["ring"]))]
    common.sync(dev)
    phase("signals")
    # the first render captures; every ring entry, and a replay, before
    # the window
    for k in range(max(2, len(ring))):
        t0 = time.perf_counter()
        out = render(rend, ring[k % len(ring)])
        common.sync(dev)
        warm = torch.tensor([time.perf_counter() - t0], dtype=torch.float64,
                            device=dev)
        del out
    tdist.broadcast(warm, 0)             # every rank samples the same jobs
    keep = set(check.sample_jobs(
        int(traffic["check"]["jobs"]),
        int(WINDOW_SHARE * seconds / max(float(warm), 1e-6)), seed))
    chans = check.sample_channels(C, int(traffic["check"]["groups"]), seed)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    host_ms, pairs, kept = [], [], {}
    prof = Profile(trace)
    common.settle()
    tdist.barrier()
    phase("build, load, capture and warm-up")
    if rank == 0:
        phase.log()
    window_start = time.time()
    with prof.window():
        w0 = time.perf_counter()
        i = 0
        while True:
            e0 = common.event(dev) if trace else None
            t0 = time.perf_counter()
            out = render(rend, ring[i % len(ring)])
            e1 = common.event(dev) if trace else None
            common.sync(dev)
            t2 = time.perf_counter()
            host_ms.append((t2 - t0) * 1e3)
            if trace:
                pairs.append((e0, e1))
            if i in keep:
                kept[i] = out[chans, :n].clone()
            del out
            i += 1
            flag.fill_(int(rank == 0 and t2 - w0 >= seconds))
            tdist.broadcast(flag, 0)
            if int(flag.item()):
                break
    res = {"device_name": (torch.cuda.get_device_name(dev) if on_card
                           else "cpu"),
           "window_start": window_start, "window_s": t2 - w0, "units": i,
           "samples": i * C * n, "host_ms": host_ms,
           "device_ms": common.elapsed_ms(pairs),
           "peak_reserved": common.peak_reserved(dev),
           "geometry": geometry.of(config, B, C, n),
           "profile": prof.summary() if trace else None,
           "digests": {str(j): hashlib.sha256(
               kept[j].cpu().numpy().tobytes()).hexdigest()
               for j in sorted(kept)}}
    inputs = {j: ring[j % len(ring)][chans].clone() for j in kept}
    if on_card:
        rend.captured.release()
    del rend, chain, ring
    common.free(dev)
    tdist.barrier()
    if rank == 0:
        from portbench.loops.offline import compare
        t0 = time.perf_counter()
        res["numbers"] = compare(config, B, n, kept, inputs, chans)
        common.log(f"reference {time.perf_counter() - t0:.1f} s")
    tdist.barrier()
    tdist.destroy_process_group()
    res["forbidden"] = forbidden_modules()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
