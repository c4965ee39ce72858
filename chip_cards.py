#!/usr/bin/env python3
"""The sharded render over four cards of one host: one process a card, NCCL.

    python3 chip_cards.py [--json PATH]   # needs four NVIDIA GPUs (H100)

``chip_smoke.py`` drives ``parallel/`` on one card (ranks sharing it over
gloo); this script runs it where NCCL can: four ranks spawned after the
kernels are built, each on its own card (``dist.init_distributed`` picks
NCCL and the rank's card), chain8 and the undecayed-EQ chain of
``chip_smoke.py``'s ``parallel`` phase at 64 ch x 30 s, B=4096, on meshes
(4, 1), (1, 4) and (2, 2).

First, on a (1, 4) mesh, NCCL's exchanges captured: a shift, an all-reduce
and an all-gather over the time ranks in one CUDA graph, bit-equal to the
eager calls (asserted), and inside a conditional while node (reported: CUDA
refused it on the H100, which is why dynspec's rounds are unrolled;
``chip_smoke.capture_checks``). Then, per mesh and chain, the captured
sharded render (ONE CUDA graph a rank: every exchange and dynspec's
``n_time`` rounds inside it) against the eager ``render_shard`` + ``gather``
(``chip_smoke.captured_vs_eager``): bit-equal on every rank, a repeated
replay too, the same launches kernel by kernel (but the unrolled rounds'
serial walks, ``n_time`` a stage) and the same dynspec rounds, globally and
for the shard alone (the rank program without the final all-gather); and
the global output's dB to the single-card render. It times nothing: the
benchmark's cell ``chain8_256ch.sharded_4x1`` times the four cards. Every
rank prints a JSON line a mesh; with ``--json`` all ranks' results and the
cards' ``nvidia-smi`` lines are written to PATH; any rank's failed check
fails the run.
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
TIMEOUT_S = 420


def exchanges_capture(mesh) -> dict:
    """A shift, an all-reduce and an all-gather over the time ranks of
    ``mesh``, captured (``chip_smoke.capture_checks``)."""
    import torch
    t = mesh.shape["time"]
    acc = torch.arange(4096, dtype=torch.float64, device=mesh.device) \
        + mesh.index("time")
    came = acc.clone()
    gathered = torch.empty((t, 4096), dtype=torch.float64,
                           device=mesh.device)

    def body():
        mesh.shift_into(acc, came, "time")
        acc.add_(came)
        mesh.all_reduce_(acc, "sum", "time")
        mesh.all_gather_into(acc, gathered, "time")
        acc.add_(gathered[t - 1], alpha=-0.5)

    return cs.capture_checks(body, [acc, came, gathered])


def rank_main(rank, world, port, out_dir):
    import torch
    from pyaudiodsptools_tpu_torch.parallel import (ShardedRenderer, dist,
                                                    make_mesh)
    from pyaudiodsptools_tpu_torch.parallel.sharding import shard_steps
    dist.init_distributed(f"localhost:{port}", num_processes=world,
                          process_id=rank)
    backend = torch.distributed.get_backend()
    n = int(cs.SECONDS * cs.SAMPLE_RATE)
    signal = cs.bench_signals.burst_noise(cs.CHANNELS, n, cs.SAMPLE_RATE, 0,
                                          "cuda")
    cfg, chains = cs.parallel_chains()
    res = {"rank": rank, "backend": backend,
           "device": str(torch.cuda.current_device()),
           "dynspec_route": cs.DYNSPEC_ROUTE}
    res["nccl_capture_1x4"] = exchanges_capture(make_mesh(1, 4))
    print(json.dumps({"rank": rank, **res}), flush=True)
    single = {}
    for name, chain in chains.items():
        single[name] = cs.pt.render(chain, signal, cfg)
        chain.captured_render().release()
    for c, t in SHAPES:
        mesh = make_mesh(c, t)
        r = {"capturable": mesh.capturable}
        for name, chain in chains.items():
            rend = ShardedRenderer(chain, cfg, mesh)
            torch.distributed.barrier()
            r[name], got = cs.captured_vs_eager(rend, signal, n)
            want = single[name]
            got = got.reshape(cs.CHANNELS, -1)[:, :want.shape[-1]]
            r[name].update({"db": cs.db_json(cs.snr_db_cuda(want, got)),
                            "single_bit_equal": bool(torch.equal(want, got))})
            del got
            rend.captured.release()
            torch.distributed.barrier()
            r[name]["shard_only"], _ = cs.captured_vs_eager(
                rend, signal, n,
                steps=lambda b, capturable, where, chain=chain, mesh=mesh:
                shard_steps(chain, mesh, b, capturable, where))
            rend.captured.release()
        res[f"{c}x{t}"] = r
        print(json.dumps({"rank": rank, f"{c}x{t}": r}), flush=True)
    with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def check(results: list) -> None:
    for res in results:
        assert res["backend"] == "nccl", res["backend"]
        assert res["nccl_capture_1x4"]["graph"].get("bit_equal"), res
        for c, t in SHAPES:
            r = res[f"{c}x{t}"]
            assert r["capturable"], r
            for name, bar in (("chain8", cs.CHAIN8_DB_PLAIN),
                              ("eq_chain", cs.CHAIN_DB_PLAIN)):
                key = f"{c}x{t}"
                cs.check_captured(key, name, r[name])
                cs.check_captured(key, name, r[name]["shard_only"])
                assert r[name]["pieces"] == 1, r[name]
                assert r[name]["single_bit_equal"] or r[name]["db"] >= bar, \
                    (key, name, r[name]["db"])


def main():
    import argparse
    import torch
    import torch.multiprocessing as mp
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="write every rank's results here")
    args = ap.parse_args()
    if torch.cuda.device_count() < RANKS:
        sys.exit(f"chip_cards.py needs {RANKS} NVIDIA GPUs, found "
                 f"{torch.cuda.device_count()}")
    paths = cs._build.build_all()
    for name in paths:
        cs._build.load(name)
    print("cards", torch.cuda.device_count(),
          [torch.cuda.get_device_name(i)
           for i in range(torch.cuda.device_count())], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print("\n".join(smi), flush=True)
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
        results = []
        for r in range(RANKS):
            with open(os.path.join(d, f"r{r}.json")) as f:
                results.append(json.load(f))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"nvidia_smi": smi, "ranks": results}, f)
    check(results)
    print("\n".join(smi), flush=True)
    print("chip_cards: every check passed", flush=True)


if __name__ == "__main__":
    main()
