#!/usr/bin/env python3
"""The sharded render over four cards of one host: one process a card, NCCL.

    python3 chip_cards.py            # needs four NVIDIA GPUs (written for H100)

``chip_smoke.py`` drives ``parallel/`` on one card (ranks sharing it over
gloo); this script runs it where NCCL can: four ranks spawned after the
kernels are built, each on its own card (``dist.init_distributed`` picks
NCCL and the rank's card), chain8 and the undecayed-EQ chain of
``chip_smoke.py``'s ``parallel`` phase at 64 ch x 30 s, B=4096, on meshes
(4, 1), (1, 4) and (2, 2). Every rank prints one JSON line: its single-card
render time, and per mesh and chain the time of a global render
(``ShardedRenderer.render``: the shard plus the all-gather over NCCL) and of
``render_shard`` alone (host clock, median of 5 after one untimed call), and
the global output's dB to the single-card render. Any rank's failure fails
the run.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402

SHAPES = [(4, 1), (1, 4), (2, 2)]
RANKS = 4
TIMEOUT_S = 400


def rank_main(rank, world, port, out_dir):
    import torch
    from pyaudiodsptools_tpu_torch.parallel import (ShardedRenderer, dist,
                                                    make_mesh)
    dist.init_distributed(f"localhost:{port}", num_processes=world,
                          process_id=rank)
    backend = torch.distributed.get_backend()
    n = int(cs.SECONDS * cs.SAMPLE_RATE)
    signal = cs.burst_noise(cs.CHANNELS, n, 0)
    cfg, chains = cs.parallel_chains()
    res = {"rank": rank, "backend": backend,
           "device": str(torch.cuda.current_device())}
    single = {}
    for name, chain in chains.items():
        single[name] = cs.host_ms(lambda: cs.pt.render(chain, signal, cfg),
                                  runs=5)
        res[f"single_{name}_ms"] = single[name][1]
    for c, t in SHAPES:
        mesh = make_mesh(c, t)
        r = {}
        for name, chain in chains.items():
            rend = ShardedRenderer(chain, cfg, mesh)
            torch.distributed.barrier()
            out, ms = cs.host_ms(lambda: rend.render(signal), runs=5)
            want = single[name][0]
            got = out[:, :want.shape[-1]]
            local = cs.host_ms(lambda: rend.render_shard(rend.shard(
                cs.pt.block.make_blocks(torch.nn.functional.pad(
                    signal, (0, (-n) % (t * cfg.block_size))),
                    cfg.block_size))), runs=5)[1]
            r[name] = {"ms_global": ms, "ms_shard_only": local,
                       "db": cs.db_json(cs.snr_db_cuda(want, got)),
                       "bit_equal": bool(torch.equal(want, got))}
        res[f"{c}x{t}"] = r
    with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def main():
    import torch
    import torch.multiprocessing as mp
    if torch.cuda.device_count() < RANKS:
        sys.exit(f"chip_cards.py needs {RANKS} NVIDIA GPUs, found "
                 f"{torch.cuda.device_count()}")
    paths = cs._build.build_all()
    for name in paths:
        cs._build.load(name)
    print("cards", torch.cuda.device_count(),
          [torch.cuda.get_device_name(i)
           for i in range(torch.cuda.device_count())], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout, flush=True)
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(rank_main, args=(RANKS, cs.free_port(), d),
                                 nprocs=RANKS, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + TIMEOUT_S
        try:
            while not ctx.join(timeout=5.0):
                if time.monotonic() > deadline:
                    raise RuntimeError("ranks timed out")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=10)
        for r in range(RANKS):
            with open(os.path.join(d, f"r{r}.json")) as f:
                print(json.dumps(json.load(f)), flush=True)


if __name__ == "__main__":
    main()
