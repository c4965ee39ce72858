"""Time ``render`` of two checkouts of this package in turns on one card.

    python3 pyaudiodsptools_tpu_torch/render_turns.py --trees OLD NEW \\
        [--out FILE]

Each tree is the root of a checkout (the directory that holds its
``pyaudiodsptools_tpu_torch``); both must have ``render``, ``Chain`` and the
command line. The script builds both trees' kernels first, then runs the
turns OLD, NEW, NEW, OLD. A turn is:

* one fresh process of the tree (``--worker``) that renders chain8 (the
  flagship 8-effect chain of ``chip_smoke.py``) at each workload of
  ``WORKLOADS`` on a fresh chain: the first ``render`` of that shape (what a
  caller who renders once pays: a captured render's warm-up and capture, if
  the tree captures), then ``render`` repeated at the same shape (the
  median of chained calls, each ended by a synchronisation), and the
  high-water of PyTorch's reserved memory over what was held before;
* the command line (``python -m pyaudiodsptools_tpu_torch``) rendering a
  wav file of ``CLI_SHAPE`` through chain8 at each block size, timed by the
  wall clock from the process's start to its end.

Signals are noise bursts made on the card from a seed. Prints one JSON
object a turn and, last, the card's name and power limit and every turn's
numbers in one object (also written to ``--out``). Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import wave

SAMPLE_RATE = 44100
# (channels, seconds, block size, repeated renders): few channels and short
# signals, where a render is a few dozen launches of small kernels, up to
# the main path's 64 channels x 30 s.
WORKLOADS = ((1, 1.0, 512, 50), (2, 10.0, 512, 20), (2, 10.0, 4096, 20),
             (8, 3.0, 512, 20), (64, 30.0, 4096, 10))
# The command line's input: channels, seconds; rendered at each block size.
CLI_SHAPE = (2, 10.0)
CLI_BLOCK_SIZES = (4096, 512)

CHAIN8 = [{"op": "lowcut", "cutoff_hz": 120.0},
          {"op": "highcut", "cutoff_hz": 12000.0},
          {"op": "eq3band_fft", "lowshelf_hz": 250.0, "lowshelf_db": 2.0,
           "mid_hz": 1500.0, "mid_db": -1.5, "highshelf_hz": 6000.0,
           "highshelf_db": 2.5},
          {"op": "compressor", "threshold_db": -18.0, "ratio": 0.6,
           "attack_ms": 3.1, "release_ms": 30.1},
          {"op": "gate", "threshold_db": -45.0, "depth": 0.1,
           "attack_ms": 3.1, "release_ms": 200.1},
          {"op": "delay", "time_in_ms": 150.0, "feedback_loops": 2},
          {"op": "tremolo", "depth": 0.3, "lfo_hz": 5.0},
          {"op": "softclipper", "drive": 0.44}]


def _signal(torch, channels: int, n: int, seed: int):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    noise = 0.25 * torch.randn((channels, n), generator=gen, device="cuda")
    t = torch.arange(n, device="cuda", dtype=torch.float32)
    burst = (torch.sin(2 * torch.pi * t / (SAMPLE_RATE // 3)) > 0.6
             ).to(torch.float32) * 0.5 + 0.3
    return torch.clip(noise * burst, -0.99, 0.99)


def worker() -> dict:
    """One turn's renders in this process, with the package of the current
    directory."""
    t_start = time.perf_counter()
    sys.path[0] = os.getcwd()       # the tree's package, not this file's
    import torch

    import pyaudiodsptools_tpu_torch as pt
    from pyaudiodsptools_tpu_torch.__main__ import build_chain

    def chain8(B):
        cfg = pt.EngineConfig(SAMPLE_RATE, B)
        return cfg, build_chain(cfg, CHAIN8, device="cuda")

    # kernels loaded, CUDA and cuFFT initialised, on a chain of its own
    for B in sorted({w[2] for w in WORKLOADS}):
        cfg, chain = chain8(B)
        pt.render(chain, _signal(torch, 1, 2 * B, 0), cfg)
    torch.cuda.synchronize()
    ready_s = time.perf_counter() - t_start
    rows = []
    for i, (C, seconds, B, repeats) in enumerate(WORKLOADS):
        cfg, chain = chain8(B)
        x = _signal(torch, C, int(seconds * SAMPLE_RATE), seed=i + 1)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        y = pt.render(chain, x, cfg)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        times, o = [], x
        for _ in range(repeats):
            t0 = time.perf_counter()
            o = pt.render(chain, o, cfg, trim=True)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(y).all())
        rows.append({"channels": C, "seconds": seconds, "block_size": B,
                     "first_render_ms": first_ms,
                     "repeated_render_ms_median": statistics.median(times),
                     "repeated_render_ms_min": min(times),
                     "repeats": repeats,
                     "reserved_high_water_mib":
                         (torch.cuda.max_memory_reserved() - base) / 2**20})
        del chain, x, y, o
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return {"ready_s": ready_s, "workloads": rows}


def _write_wav(path: str, channels: int, seconds: float, seed: int) -> None:
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(seconds * SAMPLE_RATE)
    t = np.arange(n)
    burst = (np.sin(2 * np.pi * t / (SAMPLE_RATE // 3)) > 0.6) * 0.5 + 0.3
    x = np.clip(rng.standard_normal((channels, n)) * 0.25 * burst, -0.99,
                0.99)
    pcm = (x.T * 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(pcm.tobytes())


def _run(cmd: list, cwd: str, timeout: float) -> str:
    res = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                         timeout=timeout)
    if res.returncode != 0:
        raise RuntimeError(f"{cmd} in {cwd} failed ({res.returncode}):\n"
                           f"{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
    return res.stdout


def _build(trees: list[str]) -> None:
    code = ("import sys; sys.path.insert(0, '.'); "
            "from pyaudiodsptools_tpu_torch.kernels import _build; "
            "_build.build_all()")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=t)
             for t in trees]
    for t, p in zip(trees, procs):
        if p.wait(timeout=900) != 0:
            raise RuntimeError(f"building the kernels of {t} failed")


def turn(tree: str, wav: str, workdir: str) -> dict:
    out = _run([sys.executable, os.path.abspath(__file__), "--worker"],
               tree, 900)
    r = json.loads(out.strip().splitlines()[-1])
    r["cli_ms"] = {}
    for B in CLI_BLOCK_SIZES:
        t0 = time.perf_counter()
        _run([sys.executable, "-m", "pyaudiodsptools_tpu_torch", wav,
              os.path.join(workdir, f"out_{B}.wav"), "--chain",
              json.dumps(CHAIN8), "--block-size", str(B)], tree, 600)
        r["cli_ms"][str(B)] = (time.perf_counter() - t0) * 1e3
    return r


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker()), flush=True)
        return
    if not args.trees:
        ap.error("--trees OLD NEW is required")
    trees = [os.path.abspath(t) for t in args.trees]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    _build(trees)
    turns = []
    with tempfile.TemporaryDirectory(dir=trees[1]) as workdir:
        wav = os.path.join(workdir, "in.wav")
        _write_wav(wav, *CLI_SHAPE, seed=0)
        for name, tree in (("old", trees[0]), ("new", trees[1]),
                           ("new", trees[1]), ("old", trees[0])):
            r = {"tree": name, **turn(tree, wav, workdir)}
            print(json.dumps(r), flush=True)
            turns.append(r)
    result = {"nvidia_smi": smi, "trees": {"old": trees[0],
                                           "new": trees[1]},
              "cli_shape": list(CLI_SHAPE), "turns": turns}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(smi)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
