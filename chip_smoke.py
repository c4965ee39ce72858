#!/usr/bin/env python3
"""Card lane of the PyTorch/CUDA port: build, check and time its kernels on
one GPU.

    python3 chip_smoke.py            # needs one NVIDIA GPU (written for H100)

It checks every path of the port on the card and times its kernels, one by
one, for PERF.md's table of kernels. It times no whole render, step, chunk
or pump: the benchmark's cells (``portbench/run.py``, ``BENCHMARK.json``)
time the system. chain8 is the benchmark's configuration
(``portbench/configs/chain8.json``, built by ``portbench.port.chain``) and
every signal is ``portbench.signals.burst_noise``, made on the card from
``--seed``: the lane and the cells run one chain. In order; every phase
prints one JSON object per line, and any failed check raises (exit code !=
0, no result line):

1. ``device``  the card's name and power limit as ``nvidia-smi`` gives them,
   and the torch / CUDA versions.
2. ``build``   compiles ``pyaudiodsptools_tpu_torch/csrc/*.cu`` with ``nvcc``
   for sm_90a (one process per source, started together).
3. ``kernel_cases``  each hand-written kernel against its plain PyTorch
   version (and the convs against a float64 oracle) on small cases that cover
   the edges: odd window counts, ragged lengths, rows off a 16-byte boundary,
   every version of the segmented conv a window takes (one block, a cluster
   of two or four; the clusters bit-equal to one block); for the tail,
   re-zeroing before the signal start, rings that wrap (small tiles) in runs
   that walk the halo first, rings in device memory (a halo of 88,200), 65
   taps, the one-stage plans of a lone waveshaper; pack and unpack on
   ragged lengths and 1, 3, 64, 80, 96 and 128 channels, on shapes whose
   unpack tiles take the box path (TMA), the masked path or both, and a tm
   whose pointer is off 16 bytes (exact, every element written into an
   output filled with NaN); the two dynamics walks, which read (C, T) as it
   lies, on several signals and cascades (exit states equal, 0 mismatching
   samples), at both copy widths and ragged last segments, and the whole
   speculative stage against the plain one-segment (serial) walk;
   ``convpairs_cases``: the circular convolution at every power of two from
   16 to 65,536 and 1, 2, 5 and 64 rows in every version a window takes
   (bit-equal), and its step entry point bit-equal to it on the same
   window; ``serial_walk_cases``: the serial walk equal to its plain
   version and to the audio walk at one segment, also on the signals a
   stream meets at the step's two shapes, with the rounds its fixpoint loop
   took.
4. ``main_path``  chain8 over 64 ch x 30 s at block size 4096 then 512
   through ``render``, which replays the chain's captured render (a CUDA
   graph a blocks shape, the dynamics fixpoint a conditional while node),
   every kernel's launch count set to 0 just before and read just after
   (the conv, the two walks, the tail; pack and unpack 0). The outputs are
   held against the same render with ``use_kernels=False`` on the card and,
   for two channels, against a float64 numpy oracle of the whole chain over
   an excerpt.
5. ``stream_path``  chain8 streamed block by block through
   ``StreamProcessor`` (its step captured in ``warmup()``) at 4096 (323
   steps) and 512 (2,584 steps): one ``conv_pairs`` and one ``serial_walk``
   launch a step; held to the offline render stage by stage and whole, the
   plain-version stream, the oracle; a checkpoint resumed bit-equal;
   ``render_segmented`` and ``render_resumable`` bit-equal.
   ``compiled_step``: the captured step bit-equal to the eager
   ``Chain.step`` fold, its launches a step, the replay loop under
   ``torch.cuda.set_sync_debug_mode("error")``, a checkpoint resumed.
   ``compiled_render``: the settle step against its plain version; the
   captured render bit-equal to the eager ``Chain.render_blocks`` and to
   main_path's output, the device's walk count equal to the eager loop's
   read-backs, one replay's launches, renders under the sync debug mode; a
   burst then silence (many walks in the while node); two shapes live;
   ``render`` over five lengths keeping one graph; reverb, EQ and an
   undecayed-EQ chain captured; ``render_segmented`` /
   ``render_resumable`` against the eager fold. ``stream_kernels``: rows
   7-8, the two streaming kernels at the step's shapes, queued behind a
   spin and inside a CUDA graph of 64 calls (``in_graph_ms``), both
   versions of the circular convolution by window and by batch, and the
   serial walk's sweep over segment lengths. ``long_windows``: a lowcut and
   chain8 streamed at B = 16,384, a 40,000-tap FIR offline through its
   partitions, and streams past the largest window (a 65,000-tap FIR at
   4,096, a lowcut at 65,536, chain8 at 32,768), each held to its offline
   render, one step of each to its plain version.
5b. the later slices' paths, each with the counts set to 0 just before it
   and read just after: ``reverb`` (reverb(1500) offline at both block
   sizes through ``render``, its combined kernel in 4-5 segconv partitions,
   held to the plain version and a float64 oracle; streamed at B=512 for
   1,000 blocks, bit-equal to the eager fold); ``eq3band`` (the FIR-ised
   offline and the float64 recurrence, streamed, all held to a float64
   per-sample recursion); ``compat`` (the reference's chunk loop on one mono
   channel, bit-equal to the eager loop and held to the same effects'
   ``Chain`` render; then the CLI once); ``runtime`` (chain8 mono at B=512
   through ``RealtimeEngine``, unpaced and paced through
   ``DuplexAudioStream`` with a fake ``sounddevice``, bit-equal to the
   ``StreamProcessor`` fold; the step's two kernels at (1, 512) queued);
   ``parallel`` (chain8 and an undecayed-EQ chain through
   ``ShardedRenderer``: one rank on NCCL, then two and four ranks sharing
   the card over gloo; each mesh's captured program bit-equal to the eager
   one with the same launches, rounds and walks, held to the single-card
   render; the round kernel and its if-node gate; NCCL captured; the
   kernels at a (1, 2) shard's shapes); ``lone_maps`` (each lone
   waveshaper's one-stage tail launch held to its plain ``offline``, the
   kernel queued); ``profiling`` (chain8 through
   ``profiling.annotate_chain`` under ``profiling.trace``: each
   ``effect.<name>.*`` scope's launches equal to the counters', its device
   ms against the roofline's cost).
6. ``kernel_timing``  each kernel at the main-path shapes: time (CUDA events,
   median of 5 after a warm-up, and ``queued_ms``, launches queued behind a
   spin) beside its plain version, a library yardstick where there is one,
   and its bound and each time's share of each roofline
   (``pyaudiodsptools_tpu_torch/roofline.py``); pack and unpack, which no
   path launches, at the geometry they had on the main path, with a plain
   copy of the same bytes beside them. Also the planner's sweeps: the
   dynamics stage by segment count, the segmented conv by window and version
   (``segconv_versions``), reverb(1500)'s FIR partitions (``reverb_parts``)
   and the tail by runs of tiles per channel.
   With ``--profile``, a ``profile`` phase follows: ``torch.profiler`` over a
   few captured renders and a window of streaming steps (graph replays and
   eager steps), device time by kernel name.
7. the ``{"kernels": [...]}`` summary line (all eight), and as the LAST line
   ``{"ok": true, "device": {...}}``.

Tolerances, with their reasons, are the constants below.
"""

from __future__ import annotations

import argparse
import bisect
import functools
import glob
import gzip
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch
import torch.multiprocessing as mp

import pyaudiodsptools_tpu_torch as pt
from pyaudiodsptools_tpu_torch.kernels import (_build, convpairs,
                                               dynamics as kdyn, graph_cond,
                                               relayout, segconv, tail)
from pyaudiodsptools_tpu_torch import compat, profiling, roofline as rl
from pyaudiodsptools_tpu_torch.engine import graph as pt_graph
from pyaudiodsptools_tpu_torch.__main__ import main as cli_main
from pyaudiodsptools_tpu_torch.ops import dynamics as ops_dynamics, fft_filter
from pyaudiodsptools_tpu_torch.ops.eq3band import offline as eq_recurrence
from pyaudiodsptools_tpu_torch.ops.reverb import offline_fir
from pyaudiodsptools_tpu_torch.ops.tremolo import TremoloParams, gain_row
from pyaudiodsptools_tpu_torch.parallel import (ShardedRenderer,
                                                dist as pdist, make_mesh)
from pyaudiodsptools_tpu_torch.parallel import dynspec as pdynspec
from pyaudiodsptools_tpu_torch.parallel import sharding as psharding
from pyaudiodsptools_tpu_torch.parallel.mesh import play
from pyaudiodsptools_tpu_torch.runtime import (DuplexAudioStream,
                                               RealtimeEngine,
                                               native_lib as runtime_native)

from portbench import port as bench_port, signals as bench_signals

SAMPLE_RATE = 44100
BLOCK_SIZES = (4096, 512)
# The main path's size: the flagship render, full width and full length.
CHANNELS = 64
SECONDS = 30.0
# chain8, the flagship 8-effect chain: the benchmark's configuration.
with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "portbench", "configs", "chain8.json")) as _f:
    CHAIN8 = json.load(_f)
# Steps of the plain-version stream (its dynamics walk is a Python loop over
# the block's samples), by block size.
PLAIN_STREAM_STEPS = {512: 32, 4096: 4}
# Rows of the batch that fills the card for the circular convolution: the
# offline render's window batch at block size 4096 (64 channels x 162
# windows of 16,384).
FULL_BATCH_ROWS = 10368
# Streaming bars: the streamed FIR stage runs another window than the offline
# one (last bits differ): 110 dB, as between the conv kernel and its plain
# version. Downstream a last-bit difference can flip a mask bit of the
# compressor or the gate, so the whole streamed chain is held to the offline
# kernel render at the bar of the whole plain render (CHAIN8_DB_PLAIN), while
# the dynamics stage alone, streamed and offline on the SAME input, is held
# to equality.
STREAM_FIR_DB = 110.0

# Bars. The conv kernel is an fp32 FFT with float64-built twiddles: it and
# the cuFFT-backed plain version both sit near 130 dB of the float64 oracle,
# so 110 dB between them and 95 dB to the oracle (the JAX package's own bar
# for its conv kernel) leave room only for rounding, not for a wrong index.
CONV_DB_PLAIN = 110.0
CONV_DB_ORACLE = 95.0
# The tail kernel rounds taps and gains exactly as the member ops do; its
# divisions and its pow/sin may differ from PyTorch's by an ulp (PyTorch
# multiplies by a scalar's reciprocal where the kernel divides).
TAIL_DB_PLAIN = 110.0
# A bitcrusher turns an ulp into a whole 1/64 step, so plans that end in one
# are compared by the fraction of samples that differ: exactly 0 where only
# taps, gains or nothing precede it, and rare where a division or a pow does.
CRUSH_FRACTION_AFTER_ROUNDING_STAGE = 1e-3
# Whole chain on the card: kernels against plain versions, and against a
# float64 oracle (the JAX package's bar for its kernel-backed chain).
CHAIN_DB_PLAIN = 100.0
CHAIN_DB_ORACLE = 90.0
# With the dynamics pair in the chain the plain render is no longer one
# rounding away: the conv kernel and the cuFFT plain version differ in the
# last bits, and where a sample lies within that of a threshold the
# compressor's or the gate's mask bit flips and a ramp restarts or runs on
# (both renders are right for their own conv output). A few dozen such
# samples in 85 million put the whole-chain figure near 100 dB, so the plain
# render is held to the JAX package's bar for its kernel-backed chain, and
# the 100 dB bar goes to the plain versions of the stages AFTER the conv run
# on the kernel render's own conv output, where no mask can flip.
CHAIN8_DB_PLAIN = 90.0
# pack, unpack and the two dynamics walks are held to EQUALITY with their
# plain versions: they move or select values, convert ints exactly, and round
# each product and sum on its own exactly as the plain versions do.

# chain8's float64 oracle walks the two automatons sample by sample in Python,
# so it covers an excerpt: the first 32 blocks of 4096 (2.97 s) of 2 channels.
ORACLE_EXCERPT = 32 * 4096
# Calls captured in one CUDA graph to time rows 7 and 8 without the launch
# rate (graph_ms).
GRAPH_STEPS = 64
# Segment counts of the planner's sweep (kernel_timing).
SWEEP_SEGMENTS = (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def snr_db(golden, ours) -> float:
    golden = np.asarray(golden, dtype=np.float64)
    ours = np.asarray(ours, dtype=np.float64)
    assert golden.shape == ours.shape, (golden.shape, ours.shape)
    err = float(np.sum((golden - ours) ** 2))
    if err == 0.0:
        return float("inf")
    return 10.0 * np.log10(float(np.sum(golden ** 2)) / err)


def snr_db_cuda(golden: torch.Tensor, ours: torch.Tensor) -> float:
    g = golden.double()
    err = float(((g - ours.double()) ** 2).sum())
    if err == 0.0:
        return float("inf")
    return 10.0 * np.log10(float((g ** 2).sum()) / err)


def db_json(x: float):
    """dB for a JSON line; null stands for infinity, i.e. bit-equal."""
    return None if x == float("inf") else round(x, 2)


def time_ms(fn, runs: int = 5) -> float:
    """Median CUDA-event time of ``fn`` over ``runs`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def once_ms(fn):
    """(result, ms) of ONE call of ``fn``, CUDA events around it: for the
    plain walks, Python loops over time that take seconds, whose one
    correctness run is also their timed run."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    result = fn()
    b.record()
    torch.cuda.synchronize()
    return result, a.elapsed_time(b)


def fft_conv64(x: np.ndarray, kernel: np.ndarray, shift: int = 0) -> np.ndarray:
    """float64 oracle: ``y[c, m] = conv(x[c], kernel)[m - shift]``."""
    C, T = x.shape
    L = 1
    while L < T + len(kernel):
        L *= 2
    y = np.fft.irfft(np.fft.rfft(x.astype(np.float64), L, axis=-1)
                     * np.fft.rfft(kernel, L), L, axis=-1)[:, :T]
    if shift:
        y = np.concatenate([np.zeros((C, shift)), y[:, :T - shift]], axis=1)
    return y


# ---------------------------------------------------------------------------
# the chain and the signal


def chain8(B: int):
    """(cfg, Chain) of chain8 at block size B on the card."""
    chain, cfg = bench_port.chain(CHAIN8, B, "cuda")
    assert [e.name for e in chain.exec_effects] == CHAIN8_NAMES
    return cfg, chain


CHAIN8_NAMES = ["fir_cascade:lowcut+highcut+eq3band_fft",
                "dynamics_cascade:compressor+gate",
                "tail:delay+tremolo+softclipper"]


def automaton_gains64(over, attack_env, release_env) -> np.ndarray:
    """The compressor / gate automaton of the reference, one channel, walked
    sample by sample in Python from REST: the four-field machine (mode, x, y,
    skip) as ops/dynamics.py's docstring derives it, gains read from the
    ramps' tables as float64. ``over`` is the over-threshold mask."""
    att = [float(v) for v in attack_env]
    rel = [float(v) for v in release_env]
    x_max, y_max, ratio = len(att), len(rel), att[-1]
    REST, ATTACK, HOLD, RELEASE = range(4)
    mode, x, y, skip = REST, 0, 0, False
    gains = np.ones(len(over))
    for i, o in enumerate(over.tolist()):
        if skip:                      # the sample after a completed release
            skip = False
            continue
        if mode == REST:
            if o:                     # gain att[0] == 1.0 on the trigger
                mode, x = (HOLD if x_max == 1 else ATTACK), 1
            continue
        if mode == ATTACK:            # advances whatever the mask says
            gains[i] = att[x]
            x += 1
            if x >= x_max:
                mode = HOLD
            continue
        if o:                         # HOLD stays, RELEASE re-triggers
            gains[i] = ratio
            mode, x, y = HOLD, x_max, 0
            continue
        gains[i] = rel[y]             # first or next release sample
        mode, x, y = RELEASE, 0, y + 1
        if y >= y_max:
            mode, y, skip = REST, 0, True
    return gains


def chain_oracle(x: np.ndarray, effects, block_size: int) -> np.ndarray:
    """A whole chain in float64 numpy, from the ops' definitions: causal FIRs
    (the filters' float64 impulse responses), the compressor and gate
    automatons (mask from the unscaled input, gains from
    :func:`automaton_gains64`), the delay's taps, the tremolo's LFO table
    walked block by block (freeze quirk included), the soft clipper."""
    C, T = x.shape
    y = x.astype(np.float64)
    for e in effects:
        p = e.params
        if e.name in ("lowcut", "highcut", "eq3band_fft"):
            y = fft_conv64(y, e.lti_kernel)
        elif e.name in ("compressor", "gate"):
            gains = np.stack([
                automaton_gains64(np.abs(y[c]) > float(p.threshold),
                                  p.attack_env.numpy(), p.release_env.numpy())
                for c in range(C)])
            y = y * float(p.pre_gain) * gains
        elif e.name == "delay":
            acc = y.copy()
            for k in range(p.feedback_loops):
                d = p.time_in_samples * (k + 1)
                if d < T:
                    acc[:, d:] += float(p.ramp[k]) * y[:, :T - d]
            y = acc
        elif e.name == "tremolo":
            L = p.lfo_length
            depth = float(p.depth)
            lfo = (np.sin(float(p.omega) * np.arange(L)) / 2 + 0.5) * depth \
                + (1 - depth)
            phase, avail, gains = 0, L, np.empty(T)
            for b in range(T // block_size):
                gains[b * block_size:(b + 1) * block_size] = \
                    lfo[(phase + np.arange(block_size)) % L]
                if avail < block_size:
                    avail += L * (-(-(block_size - avail) // L))
                if avail != block_size:
                    phase, avail = (phase + block_size) % L, avail - block_size
            y = y * gains
        elif e.name == "softclipper":
            a = np.minimum(np.abs(y), 1.0)
            a = -np.abs(a - 1.0) ** float(p.drive) + 1.0
            y = np.where(y < 0, -a, a)
        else:
            raise ValueError(f"the oracle does not know {e.name!r}")
    return y


# ---------------------------------------------------------------------------
# phase 3: small cases


def conv_cases() -> dict:
    """(n, halo, klen, shift, C, T): the three cases of the CPU tests at
    B=2048 through the port's planner, windows that exercise the smallest
    sizes, the extra radix-2 pass and ragged last windows, and the clusters'
    own windows (odd window counts, T not a multiple of 4, so rows start off
    a 16-byte boundary). Every case runs in each version its window takes
    (one block, a cluster of two, of four): each is held to the plain
    version and to the float64 oracle, and where one block takes the window
    too, each cluster is held to it bit for bit."""
    rng = np.random.default_rng(7)
    results = []
    cases = []
    for C, nb, klen, shift in ((3, 25, 4000, 1371), (1, 6, 1, 0),
                               (2, 48, 4096, 2048)):
        halo, seg = fft_filter.plan_segments(klen)
        cases.append((halo + seg, halo, klen, shift, C, nb * 2048))
    # every window size from 16 up: the pass schedule differs with log2(n)
    cases += [(16, 4, 5, 3, 2, 100), (32, 8, 9, 0, 2, 77),
              (64, 16, 17, 1, 2, 300), (128, 32, 20, 0, 2, 1000),
              (256, 64, 65, 7, 3, 1111), (512, 128, 100, 0, 2, 2000),
              (1024, 128, 100, 37, 5, 5000), (2048, 256, 257, 0, 3, 7001),
              (4096, 2048, 2049, 11, 2, 4096 * 3 + 5),
              (8192, 1024, 1017, 1155, 4, 20000),
              (16384, 8192, 8185, 9219, 2, 16384 * 3 + 1),
              # the clusters' windows: 5 windows, ragged
              (32768, 8192, 8185, 9219, 3, 24576 * 4 + 3),
              (65536, 8192, 8185, 9219, 3, 57344 * 4 + 5),
              (65536, 1024, 1017, 1155, 2, 64512 * 2 + 7)]
    for n, halo, klen, shift, C, T in cases:
        k = rng.standard_normal(klen) * 0.1
        plan = segconv.make_plan(k, halo, n - halo, shift, "cuda")
        x = rng.standard_normal((C, T)).astype(np.float32)
        xd = torch.from_numpy(x).cuda()
        outs = {}
        for blocks in segconv.versions(n):
            before = segconv.launch_count
            outs[blocks] = segconv.segmented_conv(xd, plan) \
                if blocks == plan.blocks else segconv._launch(xd, plan, blocks)
            torch.cuda.synchronize()
            assert segconv.launch_count == before + 1
        before = segconv.launch_count
        plain = segconv.segmented_conv(xd, plan, use_kernels=False)
        torch.cuda.synchronize()
        assert segconv.launch_count == before
        oracle = fft_conv64(x, k, shift)
        r = {"n": n, "halo": halo, "taps": klen, "shift": shift, "C": C,
             "T": T, "plan_blocks": plan.blocks, "versions": {}}
        for blocks, got in outs.items():
            assert bool(torch.isfinite(got).all()), (r, blocks)
            assert not bool(got[:, :shift].any()), "output delay is not silence"
            r["versions"][str(blocks)] = {
                "db_plain": db_json(snr_db_cuda(plain, got)),
                "db_oracle": db_json(snr_db(oracle, got.cpu().numpy())),
                "bit_equal_to_one_block": (
                    bool(torch.equal(got, outs[1])) if 1 in outs else None)}
        dbs = [snr_db_cuda(plain, got) for got in outs.values()]
        dbo = [snr_db(oracle, got.cpu().numpy()) for got in outs.values()]
        r["db_plain"], r["db_oracle"] = db_json(min(dbs)), db_json(min(dbo))
        results.append(r)
        assert min(dbs) >= CONV_DB_PLAIN, r
        assert min(dbo) >= CONV_DB_ORACLE, r
        assert all(v["bit_equal_to_one_block"] is not False
                   for v in r["versions"].values()), r
    return {"phase": "kernel_cases", "name": "segconv",
            "replaces": "pyaudiodsptools_tpu/kernels/pallas_conv.py:segmented_conv_fused",
            "cases": results,
            "clusters_bit_equal_to_one_block": True,
            "min_snr_db": min(r["db_plain"] for r in results),
            "min_snr_db_oracle": min(r["db_oracle"] for r in results)}


TAIL_PLANS = {
    "delay+tremolo+softclipper": [
        ("delay", (150.0, 2), {}), ("tremolo", (0.3, 5.0), {}),
        ("softclipper", (0.44,), {})],
    "saturator+delay+tremolo+softclipper": [
        ("saturator", (), {}), ("delay", (150.0, 2), {}),
        ("tremolo", (0.3, 5.0), {}), ("softclipper", (0.44,), {})],
    "harddistortion+wet_delay": [
        ("harddistortion", (), {}), ("delay", (40.0, 2), {"wet": True})],
    "delay+delay": [("delay", (30.0, 2), {}), ("delay", (7.0, 3), {})],
    "soft_saturator+harddistortion+delay": [
        ("saturator", (-18.0, 1.5, "soft"), {}), ("harddistortion", (), {}),
        ("delay", (9.0, 3), {})],
    # halo 44,100: one block an SM, its rings in shared memory
    "long_delay+softclipper": [
        ("delay", (500.0, 2), {}), ("softclipper", (0.44,), {})],
    # halo 88,200: rings in device memory
    "1000ms_delay+tremolo+softclipper": [
        ("delay", (1000.0, 2), {}), ("tremolo", (0.3, 5.0), {}),
        ("softclipper", (0.44,), {})],
    # 65 taps, halo 28,665
    "65_taps+softclipper": [
        ("delay", (10.0, 65), {}), ("softclipper", (0.44,), {})],
    # 2,100 taps: a stage table too large for shared memory, read from
    # device memory
    "2100_taps+softclipper": [
        ("delay", (0.1, 2100), {}), ("softclipper", (0.44,), {})],
    # no taps stage: one ring of two tiles
    "tremolo+softclipper": [("tremolo", (0.3, 5.0), {}),
                            ("softclipper", (0.44,), {})],
    # exact plans: nothing that rounds differently precedes the bitcrusher
    "bitcrusher+delay": [("bitcrusher", (), {}), ("delay", (9.0, 2), {})],
    "delay+tremolo+bitcrusher": [
        ("delay", (9.0, 3), {}), ("tremolo", (0.3, 5.0), {}),
        ("bitcrusher", (), {})],
    # a division / a pow before the bitcrusher: rare whole-step differences
    "saturator+bitcrusher": [("saturator", (), {}), ("bitcrusher", (), {})],
    "softclipper+bitcrusher": [("softclipper", (0.44,), {}),
                               ("bitcrusher", (), {})],
    # one-stage plans: a lone waveshaper's offline
    "softclipper": [("softclipper", (0.44,), {})],
    "saturator": [("saturator", (), {})],
    "soft_saturator": [("saturator", (-18.0, 1.5, "soft"), {})],
    "harddistortion": [("harddistortion", (), {})],
    "bitcrusher": [("bitcrusher", (), {})],
}
EXACT_PLANS = ("bitcrusher+delay", "delay+tremolo+bitcrusher", "bitcrusher")
LONE_MAP_PLANS = ("softclipper", "saturator", "soft_saturator",
                  "harddistortion", "bitcrusher")


def tail_members(cfg, plan: str):
    return [getattr(pt.ops, op)(cfg, *args, **kw, device="cuda")
            for op, args, kw in TAIL_PLANS[plan]]


def tail_cases() -> dict:
    """Every plan of TAIL_PLANS at 1 and 3 channels through the fused
    effect (one launch each); at 3 channels also a tile of 256 samples so
    that the rings wrap hundreds of times, in 7 runs a channel (runs that
    walk the halo first), and a length that is not a multiple of 4 (rows
    off a 16-byte boundary, a ragged last chunk). All held to the plain
    version: TAIL_DB_PLAIN, or the bitcrusher plans' exactness rule. A
    one-stage plan's lone effect is also run through its own ``offline``
    (one launch), bit-equal to the fused effect of one member."""
    cfg = pt.EngineConfig(SAMPLE_RATE, 512)
    rng = np.random.default_rng(11)
    results = []

    def check(r, plan, want, got):
        assert bool(torch.isfinite(got).all()), r
        if "bitcrusher" in plan:
            frac = float((got != want).float().mean())
            r["mismatch_fraction"] = frac
            results.append(r)
            bar = 0.0 if plan in EXACT_PLANS \
                else CRUSH_FRACTION_AFTER_ROUNDING_STAGE
            assert frac <= bar, r
        else:
            r["db_plain"] = db_json(snr_db_cuda(want, got))
            results.append(r)
            assert snr_db_cuda(want, got) >= TAIL_DB_PLAIN, r

    halos = {}
    for plan in TAIL_PLANS:
        members = tail_members(cfg, plan)
        fused = tail.fused_tail(members)
        stages, _, _, D = tail._plan_stages(members)
        kplan = tail.make_plan(stages, D, fused.params, "cuda")
        halos[plan] = {"halo": D, "tile": kplan.tile,
                       "rings_in_shared_memory": kplan.ring_smem,
                       "table_in_shared_memory": kplan.table_smem,
                       "blocks_per_sm": kplan.blocks_per_sm,
                       "taps": sum(len(s[1]) for s in stages
                                   if s[0] == "taps")}
        # 140 blocks of 512 = 71,680 samples: several tiles and runs at
        # every plan's halo, the last tile ragged; 400 past a 1 s echo's two
        nb = 400 if D > 60000 else 140
        for C in (1, 3):
            x = (rng.standard_normal((C, nb, 512)) * 0.6).astype(np.float32)
            x[0, 0, :6] = [1.4, -1.4, 0.0, 2.2, -0.79, 0.81]
            xd = torch.from_numpy(x[0] if C == 1 else x).cuda()
            before = tail.launch_count
            got = fused.offline(fused.params, xd)
            torch.cuda.synchronize()
            assert tail.launch_count == before + 1, plan
            want = fused.offline(fused.params, xd, use_kernels=False)
            torch.cuda.synchronize()
            assert tail.launch_count == before + 1
            check({"plan": plan, "C": C, "T": nb * 512}, plan, want, got)
            if len(members) == 1:
                (e,) = members
                lone = e.offline(e.params, xd)
                torch.cuda.synchronize()
                assert tail.launch_count == before + 2, plan
                assert torch.equal(lone, got), plan
            if C == 1:
                continue
            # small tiles: the rings wrap; 7 runs a channel
            small = tail.make_plan(stages, D, fused.params, "cuda", tile=256)
            gains = [gain_row(p, nb, 512, xd.device) for p in fused.params
                     if isinstance(p, TremoloParams)]
            got = tail.tail_kernel(small, xd.reshape(C, -1),
                                   torch.stack(gains) if gains else None,
                                   runs=7).reshape(xd.shape)
            check({"plan": plan, "C": C, "T": nb * 512, "tile": 256,
                   "runs": 7, "rings_in_shared_memory": small.ring_smem},
                  plan, want, got)
            # T % 4 == 3: rows start off a 16-byte boundary
            T = nb * 512 - 5
            xr = xd.reshape(C, -1)[:, :T].contiguous().reshape(C, 1, T)
            got = fused.offline(fused.params, xr)
            want = fused.offline(fused.params, xr, use_kernels=False)
            check({"plan": plan, "C": C, "T": T}, plan, want, got)
    # streaming state is born on the effect's device
    assert tail_members(cfg, "long_delay+softclipper")[0].state(
        (2,))["buffer"].is_cuda
    dbs = [r["db_plain"] for r in results if r.get("db_plain") is not None]
    return {"phase": "kernel_cases", "name": "tail",
            "replaces": "pyaudiodsptools_tpu/kernels/tail_pallas.py:tail_kernel",
            "plans": halos, "cases": results, "min_snr_db": min(dbs),
            "max_mismatch_fraction": max(
                r.get("mismatch_fraction", 0.0) for r in results)}


# relayout_cases' shapes beside the first design's (1, 3 and 64 channels,
# ragged and odd lengths): (C, T, segments, tm one float off a 16-byte
# boundary, the path an unpack's tiles take: "box", "masked" or "both")
RELAYOUT_SHAPES = [
    (C, T, segments, False,
     "box" if C == 64 and T == 65536 else "masked")
    for C in (1, 3, 64)
    for T, segments in ((50037, 7), (65536, 64), (4097, 1), (1000, 999))] + [
    # the box path with a ragged last segment and L = 720 (no multiple of
    # the tile's 128 rows); one segment; two tiles a segment
    (64, 5036, 7, False, "box"), (64, 4096, 1, False, "box"),
    (128, 2000, 4, False, "box"),
    # lane tiles that straddle two segments beside box tiles; pad lanes
    (96, 5036, 7, False, "both"), (80, 3000, 3, False, "both"),
    # an aligned geometry whose tm is off 16 bytes: all masked
    (64, 5036, 7, True, "masked")]


def offset_view(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` one float into its allocation: contiguous, its
    pointer off 16 bytes."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return flat[1:].view(t.shape).copy_(t)


def relayout_cases() -> dict:
    """pack and unpack against their plain versions: exact equality, pad
    lanes and ragged rows zero, on shapes whose unpack tiles take the box
    path (TMA), the masked path, or both, with the launcher's count of
    tiles on each path; then each kernel launched into an output filled with
    NaN (not through the wrappers, so not counted): every element of tm and
    every sample of y written."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    results = []
    for C, T, segments, off, path in RELAYOUT_SHAPES:
        x = torch.randn((C, T), generator=gen, device="cuda")
        G, L, Rp = relayout.geometry(C, T, segments)
        before = (relayout.pack_launch_count, relayout.unpack_launch_count)
        tm = relayout.pack(x, G, L, Rp)
        tm_in = offset_view(tm) if off else tm
        back = relayout.unpack(tm_in, C, T, G, L)
        torch.cuda.synchronize()
        assert (relayout.pack_launch_count, relayout.unpack_launch_count) \
            == (before[0] + 1, before[1] + 1)
        want = relayout.pack(x, G, L, Rp, use_kernels=False)
        box, masked = relayout.box_tiles(tm_in, back, C, T, G, L)
        nan_tm = torch.full_like(tm, float("nan"))
        relayout._launch("pack", x, nan_tm, C, T, G, L, Rp)
        nan_y = torch.full_like(x, float("nan"))
        relayout._launch("unpack", tm_in, nan_y, C, T, G, L, Rp)
        torch.cuda.synchronize()
        r = {"C": C, "T": T, "G": G, "L": L, "Rp": Rp,
             "tm_off_16_bytes": off,
             "unpack_tiles": {"box": box, "masked": masked},
             "pack_equal": torch.equal(tm, want),
             "unpack_equal": torch.equal(
                 back, relayout.unpack(want, C, T, G, L,
                                       use_kernels=False)),
             "roundtrip_equal": torch.equal(back, x),
             "pack_writes_every_element": torch.equal(nan_tm, want),
             "unpack_writes_every_sample": torch.equal(nan_y, x),
             "pad_lanes_zero": not bool(tm[:, C * G:].any()),
             "ragged_rows_zero": not bool(
                 tm[T - (G - 1) * L:, (G - 1) * C:].any())}
        assert (relayout.pack_launch_count, relayout.unpack_launch_count) \
            == (before[0] + 1, before[1] + 1)
        assert {"box": masked == 0 < box, "masked": box == 0 < masked,
                "both": box > 0 and masked > 0}[path], r
        results.append(r)
        assert all(v for k, v in r.items()
                   if k.endswith(("equal", "zero", "element", "sample"))), r
    ran = {p: sum(r["unpack_tiles"][p] > 0 for r in results)
           for p in ("box", "masked")}
    assert ran["box"] > 0 and ran["masked"] > 0, ran
    return {"phase": "kernel_cases", "name": "relayout (pack, unpack)",
            "replaces": "pyaudiodsptools_tpu/kernels/relayout.py:"
                        "time_major_pack, time_major_unpack",
            "cases": results, "all_exact": True,
            "unpack_launches_by_path": ran}


def dynamics_signals() -> dict:
    """The signals of the CPU tests: bursty noise, an alternation around the
    thresholds, silence (all three synchronise within a segment: two walks;
    4,000 samples), and short bursts followed by silence (12,000 samples,
    longer than the gate's release of 8,824), where the release spans many
    segments and the loop must hand states on walk after walk; and a loud
    level with silent gaps one sample shorter than, as long as and one sample
    longer than the short-release ops' releases (88 and 132 samples), so
    that a release completes right before a loud sample: the skipped
    sample."""
    rng = np.random.default_rng(42)
    n = 4000
    decay = np.zeros((2, 12000), np.float32)
    decay[:, 100:400] = 0.5
    decay[1, 9500:9600] = -0.5
    return {
        "decay": decay,
        "gaps": gap_signal(),
        "bursty": (rng.standard_normal((2, n)) * 0.3
                   * (rng.random((2, n)) > 0.5)).astype(np.float32),
        "alternating": np.tile([0.9, 1e-4], n // 2)[None, :].repeat(
            2, 0).astype(np.float32),
        "silence": np.zeros((2, n), np.float32),
    }


def gap_signal() -> np.ndarray:
    pieces = []
    for gap in (87, 88, 89, 131, 132, 133, 300):
        pieces += [np.full(300, 0.5, np.float32), np.zeros(gap, np.float32)]
    row = np.concatenate(pieces + [np.full(300, 0.5, np.float32)])
    return np.stack([row, -row])


def dynamics_cases() -> dict:
    """The two walks, which read (C, T) as it lies, against their plain
    versions (exit states equal, 0 mismatching samples) from REST and from
    random legal entry states, and the whole speculative stage (kernels, 16
    segments) against the plain stage: for the flagship cascade on every
    signal, for the one-sample attack and for the short releases on the gap
    signal, the plain ONE-segment walk, which is the serial simulation;
    elsewhere the plain stage at the same segmentation. Then the walks'
    geometries (``tile_cases``): both copy widths (16 bytes where T and L
    are multiples of 4, else 4), ragged last segments, several blocks with
    a short last one. (The plain walks are Python loops over the rows,
    about 0.3 ms a row and op on a card, which is why the cases are no
    larger.)"""
    cfg = pt.EngineConfig(SAMPLE_RATE, 512)
    o = pt.ops
    comp = o.compressor(cfg, -18.0, 0.6, 3.1, 30.1, device="cuda")
    gate = o.gate(cfg, -45.0, 0.1, 3.1, 200.1, device="cuda")
    short = o.compressor(cfg, -20.0, 0.5, 1000.0 / 44100.0, 2.0,
                         device="cuda")             # x_max == 1
    assert short.params.x_max == 1
    short_release = [o.compressor(cfg, -20.0, 0.5, 3.1, 2.0, device="cuda"),
                     o.gate(cfg, -45.0, 0.1, 3.1, 3.0, device="cuda")]
    assert [e.params.y_max for e in short_release] == [88, 132]
    cascades = {"compressor": [comp], "gate": [gate],
                "cascade": [comp, gate], "short_attack": [short],
                "short_release": short_release,
                "cascade_of_4": [gate, short, comp, gate]}
    rng = np.random.default_rng(17)
    results = []
    for cname, members in cascades.items():
        params = [e.params for e in members]
        scalars = [kdyn.op_scalars(p) for p in params]
        for sname, sig in dynamics_signals().items():
            if cname in ("cascade_of_4", "short_release") \
                    and sname in ("decay", "silence"):
                continue
            x = torch.from_numpy(sig).cuda()
            G, L, _ = relayout.geometry(2, x.shape[1], 16)
            random_entry = torch.from_numpy(np.stack([
                rng.integers(-1, sc[7], 2 * G) for sc in scalars]
            ).astype(np.int32)).cuda()
            r = {"ops": cname, "signal": sname, "T": x.shape[1], "G": G,
                 "L": L}
            for ename, entry in (("rest", torch.zeros_like(random_entry)),
                                 ("random", random_entry)):
                before = (kdyn.state_walk_launch_count,
                          kdyn.audio_walk_launch_count)
                z_state = kdyn.state_walk(scalars, x, G, L, entry)
                out, z = kdyn.audio_walk(scalars, x, G, L, entry)
                torch.cuda.synchronize()
                assert (kdyn.state_walk_launch_count,
                        kdyn.audio_walk_launch_count) == \
                    (before[0] + 1, before[1] + 1)
                p_out, p_z = kdyn.audio_walk(scalars, x, G, L, entry,
                                             use_kernels=False)
                equal = torch.equal(z, p_z) and torch.equal(z_state, z)
                if ename == "rest":
                    equal = equal and torch.equal(z_state, kdyn.state_walk(
                        scalars, x, G, L, entry, use_kernels=False))
                assert (kdyn.state_walk_launch_count,
                        kdyn.audio_walk_launch_count) == \
                    (before[0] + 1, before[1] + 1)
                r[f"{ename}_exit_states_equal"] = bool(equal)
                r[f"{ename}_mismatching_samples"] = int((out != p_out).sum())
            # the whole stage
            got, r["walks"] = stage_walks(
                lambda: kdyn.dynamics_offline(params, x, segments=16))
            assert bool(torch.isfinite(got).all())
            serial = cname == "cascade" or (cname, sname) in (
                ("short_attack", "bursty"), ("short_release", "gaps"))
            plain = kdyn.dynamics_offline(params, x, use_kernels=False,
                                          segments=1 if serial else 16)
            r["stage_held_to"] = "plain serial walk (1 segment)" if serial \
                else "plain stage (16 segments)"
            r["stage_mismatching_samples"] = int((got != plain).sum())
            results.append(r)
            assert r["rest_exit_states_equal"] and r["random_exit_states_equal"], r
            assert r["rest_mismatching_samples"] == 0, r
            assert r["random_mismatching_samples"] == 0, r
            assert r["stage_mismatching_samples"] == 0, r
            assert 2 <= r["walks"] <= G + 2, r
            if sname == "decay" and cname in ("gate", "cascade"):
                # a release that outlasts a segment costs a walk per segment
                assert r["walks"] >= 8, r
    # ragged length, 3 channels, the planner's own segment count; the fused
    # effect through blocks
    fused = kdyn.fused_dynamics([comp, gate])
    x = torch.from_numpy((rng.standard_normal((3, 97, 512)) * 0.3
                          * (rng.random((3, 97, 512)) > 0.6)
                          ).astype(np.float32)).cuda()
    got = fused.offline(fused.params, x)
    want = fused.offline(fused.params, x, use_kernels=False)
    planner_equal = torch.equal(got, want)
    assert planner_equal
    # streaming state is born on the effect's device
    assert all(v.is_cuda for st in fused.state((2,)) for v in st.values())
    return {"phase": "kernel_cases", "name": "dynamics (state_walk, audio_walk)",
            "replaces": "pyaudiodsptools_tpu/kernels/dynamics_pallas.py:"
                        "_spec_state_kernel, _spec_kernel",
            "cases": results, "tile_cases": walk_tile_cases(comp, gate),
            "max_mismatching_samples": 0, "all_exit_states_equal": True,
            "fused_effect_planner_segments_equal_plain": planner_equal}


# (C, T, segments): the 4-byte copies (T or L not a multiple of 4) with a
# ragged last segment and 21 rows in one block; the 16-byte copies over 128
# blocks, L a multiple of the tile, and ragged (T = 65,532, 256 segments of
# 256); C*G = 150 rows, a block of 128 and one of 22.
WALK_TILE_SHAPES = ((3, 5037, 7), (64, 65536, 256), (64, 65532, 256),
                    (3, 2999, 50))


def walk_tile_cases(comp, gate) -> list:
    """The two walks against their plain versions at WALK_TILE_SHAPES, the
    cascade from random legal entry states: 0 mismatching samples (a sample
    stored into another segment's place would show), exit states equal."""
    scalars = [kdyn.op_scalars(e.params) for e in (comp, gate)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(37)
    rng = np.random.default_rng(37)
    results = []
    for C, T, segments in WALK_TILE_SHAPES:
        G, L, _ = relayout.geometry(C, T, segments)
        x = 0.3 * torch.randn((C, T), generator=gen, device="cuda") \
            * (torch.rand((C, T), generator=gen, device="cuda") > 0.5)
        entry = torch.from_numpy(np.stack([
            rng.integers(-1, sc[7], C * G) for sc in scalars]
        ).astype(np.int32)).cuda()
        out, z = kdyn.audio_walk(scalars, x, G, L, entry)
        z_state = kdyn.state_walk(scalars, x, G, L, entry)
        p_out, p_z = kdyn.audio_walk(scalars, x, G, L, entry,
                                     use_kernels=False)
        r = {"C": C, "T": T, "G": G, "L": L, "rows": C * G,
             "copy_bytes": 16 if T % 4 == 0 and L % 4 == 0 else 4,
             "mismatching_samples": int((out != p_out).sum()),
             "exit_states_equal": torch.equal(z, p_z)
             and torch.equal(z_state, p_z)}
        results.append(r)
        assert r["mismatching_samples"] == 0 and r["exit_states_equal"], r
    return results


def convpairs_cases() -> dict:
    """The circular convolution against its plain version and a float64
    oracle: every power of two from 16 to 65,536 (every pass schedule, and
    the windows no thread block holds), 1, 2, 5 and 64 rows (a lone row, a
    pair, an odd last row, the step's batch), in every version the window
    takes (one block, a cluster of two or of four), the versions bit-equal
    where more than one takes the window; and rows passed as a strided view
    of a longer history."""
    rng = np.random.default_rng(19)
    results = []
    n = segconv.MIN_WINDOW
    while n <= convpairs.MAX_WINDOW:
        kernel = rng.standard_normal(min(n, 1 + n // 2)) * 0.1
        plan = convpairs.make_plan(kernel, n, "cuda")
        for R in (1, 2, 5, 64):
            x = rng.standard_normal((R, n)).astype(np.float32)
            xd = torch.from_numpy(x).cuda()
            before = convpairs.launch_count
            got = convpairs.conv_pairs(xd, plan)
            torch.cuda.synchronize()
            assert convpairs.launch_count == before + 1
            plain = convpairs.conv_pairs(xd, plan, use_kernels=False)
            assert convpairs.launch_count == before + 1
            oracle = np.fft.irfft(np.fft.rfft(x.astype(np.float64), axis=-1)
                                  * np.fft.rfft(kernel, n), n, axis=-1)
            others = [b for b in convpairs.versions(n)
                      if b != convpairs.blocks_for(n, R)]
            r = {"n": n, "R": R, "taps": len(kernel),
                 "blocks": convpairs.blocks_for(n, R),
                 "db_plain": db_json(snr_db_cuda(plain, got)),
                 "db_oracle": db_json(snr_db(oracle, got.cpu().numpy())),
                 "versions_bit_equal": {
                     str(b): torch.equal(convpairs._launch(xd, plan, b), got)
                     for b in others}}
            results.append(r)
            assert bool(torch.isfinite(got).all())
            assert snr_db_cuda(plain, got) >= CONV_DB_PLAIN, r
            assert snr_db(oracle, got.cpu().numpy()) >= CONV_DB_ORACLE, r
            assert all(r["versions_bit_equal"].values()), r
        n *= 2
    joined = torch.randn((5, 1155 + 2048), device="cuda")
    plan = convpairs.make_plan(rng.standard_normal(1017) * 0.1, 2048, "cuda")
    strided_equal = torch.equal(
        convpairs.conv_pairs(joined[:, :2048], plan),
        convpairs.conv_pairs(joined[:, :2048].contiguous(), plan))
    assert strided_equal
    step_results, step_min_db = convpairs_step_cases(rng)
    for bad in (2 * convpairs.MAX_WINDOW, 3072):
        try:
            convpairs.make_plan(np.ones(3), bad, "cuda")
        except ValueError as e:
            assert str(bad) in str(e)
        else:
            raise AssertionError(f"a window of {bad} samples was accepted")
    return {"phase": "convpairs_cases", "name": "conv_pairs",
            "replaces": "pyaudiodsptools_tpu/kernels/pallas_conv.py:"
                        "conv_pairs_fused",
            "cases": results, "strided_rows_equal": strided_equal,
            "step_cases": step_results,
            "step_all_bit_equal_to_conv_pairs": True,
            "step_min_snr_db": db_json(step_min_db),
            "min_snr_db": min(r["db_plain"] for r in results),
            "min_snr_db_oracle": min(r["db_oracle"] for r in results)}


def convpairs_step_cases(rng) -> tuple[list, float]:
    """The step entry point at every power of two the kernel takes, 1, 5 and
    64 rows (a lone row, an odd last row, the step's batch), with the window
    wholly in the history (the flagship geometries: n = 4 B, lead > 2 B),
    across history and block, and with no lead: the output BIT-EQUAL to
    ``conv_pairs`` on the same window (every version of the kernel the
    window takes: one block, a cluster of two or of four), the next history
    equal to the shifted concatenation, the old history untouched, the block
    a slice of a longer signal; and CONV_DB_PLAIN to the step's plain
    version. Returns the cases and the least dB to the plain version."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(41)
    results, min_db = [], float("inf")
    n = segconv.MIN_WINDOW
    while n <= convpairs.MAX_WINDOW:
        kernel = rng.standard_normal(min(n, 1 + n // 2)) * 0.1
        plan = convpairs.make_plan(kernel, n, "cuda")
        for R in (1, 5, 64):
            for B, lead in ((max(n // 4, 1), 9 * n // 16 + 3), (n // 2, 5),
                            (n, 0)):
                H = lead + n - B
                hist = torch.randn((R, H), generator=gen, device="cuda")
                signal = torch.randn((R, 3 * B + 1), generator=gen,
                                     device="cuda")
                block = signal[:, B:2 * B]
                kept = hist.clone()
                before = convpairs.launch_count
                out, new_hist = convpairs.conv_pairs_step(hist, block, plan,
                                                          lead)
                torch.cuda.synchronize()
                assert convpairs.launch_count == before + 1
                cat = torch.cat([hist, block], dim=-1)
                window = cat[:, :n].contiguous()
                r = {"n": n, "R": R, "B": B, "lead": lead,
                     "equal_conv_pairs": torch.equal(
                         out, convpairs.conv_pairs(window, plan)[:, n - B:]),
                     "next_history_equal": torch.equal(new_hist, cat[:, B:]),
                     "old_history_untouched": torch.equal(hist, kept)}
                versions = []
                for blocks in convpairs.versions(n):
                    versions.append(convpairs._launch(window, plan, blocks))
                    o2, h2 = convpairs._launch_step(hist, block, plan, blocks)
                    versions.append(torch.nn.functional.pad(o2, (n - B, 0)))
                    r["next_history_equal"] &= torch.equal(h2, cat[:, B:])
                r["versions_equal"] = all(
                    torch.equal(v[:, n - B:], out) for v in versions)
                plain, plain_hist = convpairs.conv_pairs_step(
                    hist, block, plan, lead, use_kernels=False)
                db = snr_db_cuda(plain, out)
                min_db = min(min_db, db)
                r["db_plain"] = db_json(db)
                results.append(r)
                assert torch.equal(plain_hist, new_hist), r
                assert r["equal_conv_pairs"] and r["next_history_equal"] \
                    and r["old_history_untouched"] and r["versions_equal"], r
                assert db >= CONV_DB_PLAIN, r
        n *= 2
    return results, min_db


# (ops, T, C): every T in {1, 512, 1500, 4096} and every C in {1, 3, 64} for
# the single ops and the cascade of two; the cascade of four stops at 1,500
# samples (its plain version is a Python loop: 4 ops x T rows x about 0.3 ms).
SERIAL_CASES = [
    ("compressor", 1, 1), ("compressor", 512, 3), ("compressor", 1500, 64),
    ("compressor", 4096, 1),
    ("gate", 1, 3), ("gate", 512, 64), ("gate", 1500, 1), ("gate", 4096, 3),
    ("cascade", 1, 64), ("cascade", 512, 1), ("cascade", 1500, 3),
    ("cascade", 4096, 64),
    ("cascade_of_4", 1, 1), ("cascade_of_4", 512, 64),
    ("cascade_of_4", 1500, 3),
]


def stream_signals(C: int, T: int) -> dict:
    """name -> (x (2 T,) per channel as a (C, 2 T) tensor: the block BEFORE
    the measured one and the measured one). The measured block is walked from
    the state the block before leaves behind, as a stream would."""
    noise = bench_signals.burst_noise(
        C, 3 * SAMPLE_RATE, SAMPLE_RATE, 29, "cuda")[
            :, SAMPLE_RATE:SAMPLE_RATE + 2 * T].contiguous()
    loud_then_silent = torch.zeros((C, 2 * T), device="cuda")
    loud_then_silent[:, :T] = 0.5
    dies_away = torch.zeros((C, 2 * T), device="cuda")
    dies_away[:, T:T + T // 8] = 0.5
    alternating = torch.from_numpy(np.tile(
        np.asarray([0.9, 1e-4], np.float32), (C, T))).cuda()
    return {
        # the main path's input: both ops re-trigger all the time
        "noise_bursts": noise,
        # a burst in the block before, silence in this one: the gate's
        # release (8,824 samples) spans this block and the next
        "burst_then_silence": loud_then_silent,
        # silence, then a sound that dies away inside the measured block
        "dies_away_inside_the_block": dies_away,
        # the JAX package's tests/test_fusion.py signal, from REST (its first
        # block: the attack is handed on a segment a round) ...
        "alternating_from_rest": alternating[:, T:],
        # ... and carried
        "alternating": alternating,
    }


PLAIN_AT_FULL_LENGTH = ("noise_bursts", "burst_then_silence",
                        "alternating_from_rest")


def serial_walk_signal_cases(members) -> list:
    """The serial walk on the signals a stream meets, at the step's two
    shapes: equal to the audio walk at one segment and to its plain version
    (samples and exit states; the plain version at 4,096 samples on the
    signals of PLAIN_AT_FULL_LENGTH), with the rounds of its fixpoint loop
    (the most any channel took)."""
    params = [e.params for e in members]
    scalars = [kdyn.op_scalars(p) for p in params]
    results = []
    for T in (512, 4096):
        for name, x2 in stream_signals(CHANNELS, T).items():
            entry = torch.zeros((len(scalars), CHANNELS), dtype=torch.int32,
                                device="cuda")
            if x2.shape[1] == 2 * T:
                _, entry = kdyn.serial_walk(scalars, x2[:, :T].contiguous(),
                                            entry)
            x = x2[:, -T:].contiguous()
            out, z, rounds = kdyn._launch_serial(scalars, x, entry,
                                                 want_rounds=True)
            a_out, a_z = kdyn.audio_walk(scalars, x, 1, T, entry)
            # the plain version is a Python loop over the T rows (seconds at
            # 4,096): there it is run on the three signals named first, and
            # the other two are held to the audio walk alone
            if T <= 512 or name in PLAIN_AT_FULL_LENGTH:
                p_out, p_z = kdyn.serial_walk(scalars, x, entry,
                                              use_kernels=False)
            else:
                p_out, p_z = a_out, a_z
            lseg, segments, threads = kdyn.serial_geometry(T)
            r = {"signal": name, "C": CHANNELS, "T": T,
                 "segment": 1 << lseg, "segments": segments,
                 "threads": threads,
                 "entry_modes": sorted(set(
                     kdyn.decode_state(params[-1], entry[-1])["mode"]
                     .cpu().tolist())),
                 "rounds": int(rounds.max()),
                 "held_to_plain": T <= 512 or name in PLAIN_AT_FULL_LENGTH,
                 "mismatching_samples": int((out != p_out).sum()),
                 "exit_states_equal": torch.equal(z, p_z),
                 "equal_audio_walk_one_segment":
                     torch.equal(out, a_out) and torch.equal(z, a_z)}
            results.append(r)
            assert r["mismatching_samples"] == 0 and r["exit_states_equal"] \
                and r["equal_audio_walk_one_segment"], r
            assert 1 <= r["rounds"] <= segments, r
            if name == "burst_then_silence":
                assert r["rounds"] == 1, r     # the closed-form guess is exact
    return results


def serial_walk_cases() -> dict:
    """The serial walk against its plain version (0 mismatching samples, exit
    states equal) and against the audio walk at one segment on the same data
    (the same device functions: equal bits). Channel c takes row c of the
    dynamics signals above (burst-then-silence and the gap signal included),
    repeated to T samples; its entry state is REST or a random legal state,
    alternately."""
    cfg = pt.EngineConfig(SAMPLE_RATE, 512)
    o = pt.ops
    comp = o.compressor(cfg, -18.0, 0.6, 3.1, 30.1, device="cuda")
    gate = o.gate(cfg, -45.0, 0.1, 3.1, 200.1, device="cuda")
    short = o.compressor(cfg, -20.0, 0.5, 1000.0 / 44100.0, 2.0,
                         device="cuda")             # x_max == 1
    cascades = {"compressor": [comp], "gate": [gate],
                "cascade": [comp, gate],
                "cascade_of_4": [gate, short, comp, gate]}
    rows = [row for sig in dynamics_signals().values() for row in sig]
    rng = np.random.default_rng(23)
    results = []
    for k, (cname, T, C) in enumerate(SERIAL_CASES):
        params = [e.params for e in cascades[cname]]
        scalars = [kdyn.op_scalars(p) for p in params]
        x = np.stack([np.resize(rows[(c + k) % len(rows)], T)
                      for c in range(C)]).astype(np.float32)
        entry = np.stack([rng.integers(-1, sc[7], C) for sc in scalars])
        entry[:, (np.arange(C) + k) % 2 == 0] = 0          # REST
        xd = torch.from_numpy(x).cuda()
        ed = torch.from_numpy(entry.astype(np.int32)).cuda()
        before = kdyn.serial_walk_launch_count
        out, z = kdyn.serial_walk(scalars, xd, ed)
        torch.cuda.synchronize()
        assert kdyn.serial_walk_launch_count == before + 1
        p_out, p_z = kdyn.serial_walk(scalars, xd, ed, use_kernels=False)
        assert kdyn.serial_walk_launch_count == before + 1
        a_out, a_z = kdyn.audio_walk(scalars, xd, 1, T, ed)
        r = {"ops": cname, "T": T, "C": C,
             "entries_rest": int((entry[0] == 0).sum()),
             "mismatching_samples": int((out != p_out).sum()),
             "exit_states_equal": torch.equal(z, p_z),
             "mismatching_samples_vs_audio_walk": int((out != a_out).sum()),
             "exit_states_equal_audio_walk": torch.equal(z, a_z)}
        results.append(r)
        assert bool(torch.isfinite(out).all())
        assert r["mismatching_samples"] == 0 and r["exit_states_equal"], r
        assert r["mismatching_samples_vs_audio_walk"] == 0 \
            and r["exit_states_equal_audio_walk"], r
    signal_results = serial_walk_signal_cases(cascades["cascade"])
    # the effects' own steps: a cascade step is one launch and equals the
    # members' steps one after the other, states included
    fused = kdyn.fused_dynamics([comp, gate])
    x = torch.from_numpy(np.stack([np.resize(r, 1500) for r in rows[:3]])
                         ).cuda()
    before = kdyn.serial_walk_launch_count
    st, out = fused.step(fused.params, fused.state((3,)), x)
    assert kdyn.serial_walk_launch_count == before + 1
    mid_st, mid = comp.step(comp.params, comp.state((3,)), x)
    end_st, want = gate.step(gate.params, gate.state((3,)), mid)
    step_equal = torch.equal(out, want) and all(
        torch.equal(st[j][f], own[f]) for j, own in enumerate((mid_st, end_st))
        for f in ("mode", "x", "y", "skip"))
    assert step_equal
    assert all(v.is_cuda for part in st for v in part.values())
    return {"phase": "serial_walk_cases", "name": "serial_walk",
            "replaces": "pyaudiodsptools_tpu/kernels/dynamics_pallas.py:"
                        "dynamics_pallas",
            "cases": results, "max_mismatching_samples": 0,
            "all_exit_states_equal": True,
            "signals": signal_results,
            "cascade_step_equals_op_after_op_steps": step_equal}


# ---------------------------------------------------------------------------
# phases 4-6: the main paths


VERSION_NAMES = {1: "one_block", 2: "cluster_of_two", 4: "cluster_of_four"}

# name -> (source under csrc/, "file:line" of the TPU kernel it replaces)
KERNELS = {
    "segconv": ("segconv.cu", "pallas_conv.py:926"),
    "tail": ("tail.cu", "tail_pallas.py:281"),
    "pack": ("relayout.cu", "relayout.py:283"),
    "state_walk": ("dynamics.cu", "dynamics_pallas.py:358"),
    "audio_walk": ("dynamics.cu", "dynamics_pallas.py:323"),
    "unpack": ("relayout.cu", "relayout.py:316"),
    "serial_walk": ("dynamics.cu", "dynamics_pallas.py:162"),
    "conv_pairs": ("convpairs.cu", "pallas_conv.py:448"),
}
# the kernels of the streaming path; the others are the offline render's,
# but for pack and unpack, which no main path launches since the offline
# walks read (C, T) as it lies (they stay, held by relayout_cases and timed
# in kernel_timing)
STREAM_KERNELS = ("serial_walk", "conv_pairs")
OFF_PATH_KERNELS = ("pack", "unpack")


def launch_counts() -> dict:
    return {"segconv": segconv.launch_count, "tail": tail.launch_count,
            "pack": relayout.pack_launch_count,
            "state_walk": kdyn.state_walk_launch_count,
            "audio_walk": kdyn.audio_walk_launch_count,
            "unpack": relayout.unpack_launch_count,
            "serial_walk": kdyn.serial_walk_launch_count,
            "conv_pairs": convpairs.launch_count}


def zero_launch_counts() -> None:
    segconv.launch_count = 0
    tail.launch_count = 0
    relayout.pack_launch_count = 0
    relayout.unpack_launch_count = 0
    kdyn.state_walk_launch_count = 0
    kdyn.audio_walk_launch_count = 0
    kdyn.serial_walk_launch_count = 0
    kdyn.settle_launch_count = 0
    kdyn.round_launch_count = 0
    convpairs.launch_count = 0


def check_render(chain, cfg, signal, out, n: int, keep_oracle: dict) -> dict:
    """Hold chain8's render to the plain render on the card (CHAIN8_DB_PLAIN),
    to the plain versions of the stages after the conv run on the kernel's
    conv output and, for the first and last channel, to the float64 oracle
    (over the first ORACLE_EXCERPT samples: every effect is causal, so a
    prefix of the output depends on the same prefix of the input only).
    ``keep_oracle`` receives the oracle excerpt under the block size, for
    the streaming path to be held to as well."""
    C, B = signal.shape[0], cfg.block_size
    T = out.shape[-1]
    assert out.shape == (C, -(-n // B) * B) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    counts = launch_counts()
    plain = pt.render(chain, signal, cfg, use_kernels=False)
    torch.cuda.synchronize()
    assert launch_counts() == counts, "a plain render launched a kernel"
    db_plain = snr_db_cuda(plain, out)
    del plain
    blocks = pt.block.make_blocks(signal, B)
    fir_e, rest = chain.exec_effects[0], chain.exec_effects[1:]
    after = fir_e.offline(fir_e.params, blocks)     # the conv kernel again
    for e in rest:
        after = e.offline(e.params, after, use_kernels=False)
    db_after_conv = snr_db_cuda(after.reshape(C, T), out)
    del after, blocks
    pick = [0, C - 1]
    m = ORACLE_EXCERPT
    assert m % B == 0 and m <= T
    x2 = torch.nn.functional.pad(signal[pick], (0, T - n))[:, :m].cpu().numpy()
    oracle = chain_oracle(x2, chain.effects, B)
    keep_oracle[B] = oracle
    db_oracle = snr_db(oracle, out[pick, :m].cpu().numpy())
    r = {"db_plain": db_json(db_plain),
         "db_plain_after_conv": db_json(db_after_conv),
         "db_oracle_2ch": db_json(db_oracle),
         "oracle_samples": m, "peak": float(out.abs().max())}
    assert db_plain >= CHAIN8_DB_PLAIN, r
    assert db_after_conv >= CHAIN_DB_PLAIN, r
    assert db_oracle >= CHAIN_DB_ORACLE, r
    assert 0.0 < r["peak"] <= 1.0, r
    return r


def bound(cost: dict) -> dict:
    """``roofline.bound`` of a cost on this card (ms)."""
    return rl.bound(cost, rl.peaks_for_device())


def roofline_row(cost: dict, **times) -> dict:
    """A kernel row's bound and, for each of its times (``ms``, ``plain_ms``,
    ``library_ms``; None where there is none), ``roofline.classify`` against
    the same cost: the function's work, whichever implementation ran."""
    pk = rl.peaks_for_device()
    return {**rl.bound(cost, pk),
            "roofline": {k: rl.classify(t * 1e-3, cost, pk)
                         for k, t in times.items() if t is not None}}


def time_segconv(x, fir_e, by_B: dict, B: int) -> torch.Tensor:
    """The segmented conv at the main-path shape; returns its output. Beside
    it ``segconv_versions``: the same convolution with every window the
    planner could give this halo, in every version the window takes, timed
    twice in turns (first ascending, then descending)."""
    C, T = x.shape
    (plan,) = fir_e.params.plans          # one window takes the kernel
    y_kernel = segconv.segmented_conv(x, plan)
    y_plain = segconv.segmented_conv(x, plan, use_kernels=False)
    torch.cuda.synchronize()
    max_err = float((y_kernel - y_plain).abs().max())
    db_plain = snr_db_cuda(y_plain, y_kernel)
    pick = [0, C - 1]
    stripped = fir_e.lti_kernel[plan.shift:]
    db_oracle = snr_db(
        fft_conv64(x[pick].cpu().numpy(), stripped, plan.shift),
        y_kernel[pick].cpu().numpy())
    assert db_plain >= CONV_DB_PLAIN and db_oracle >= CONV_DB_ORACLE, \
        (B, db_plain, db_oracle)
    del y_plain
    ms = time_ms(lambda: segconv.segmented_conv(x, plan))
    # the launches queued behind a spin: the kernel's device time, without
    # the host's time of a wrapper call between the events (rows 5-8 have it)
    queued = queued_ms(lambda: segconv.segmented_conv(x, plan),
                       RELAYOUT_QUEUED_RUNS)
    plain_ms = time_ms(
        lambda: segconv.segmented_conv(x, plan, use_kernels=False))
    # library yardstick: the batched cuFFT convolution at this geometry,
    # on windows gathered beforehand
    n_seg = -(-T // plan.seg)
    windows = torch.nn.functional.pad(
        x, (plan.halo + plan.shift, n_seg * plan.seg - T)
    ).unfold(-1, plan.n, plan.seg)[:, :n_seg].contiguous()
    library_ms = time_ms(lambda: torch.fft.irfft(
        torch.fft.rfft(windows, dim=-1) * plan.spectrum_rfft,
        n=plan.n, dim=-1))
    del windows
    versions = {}
    n = max(fft_filter.MIN_WINDOW, 2 * plan.halo)
    cands = []
    while n <= segconv.MAX_WINDOW:
        p = segconv.make_plan(stripped, plan.halo, n - plan.halo, plan.shift,
                              "cuda")
        cands += [(p, blocks) for blocks in segconv.versions(n)]
        n *= 2
    for p, blocks in cands:
        y = segconv._launch(x, p, blocks)
        db = snr_db_cuda(y_kernel, y)
        del y
        assert db >= CONV_DB_PLAIN, (p.n, blocks, db)
        versions[f"{p.n}/{blocks}"] = {
            "n": p.n, "blocks": blocks, "seg": p.seg,
            "chosen": (p.n, blocks) == (plan.n, plan.blocks),
            "db_to_chosen": db_json(db), "ms": []}
    for p, blocks in cands + cands[::-1]:
        versions[f"{p.n}/{blocks}"]["ms"].append(
            time_ms(lambda: segconv._launch(x, p, blocks)))
    by_B[B] = {
        "n": plan.n, "blocks": plan.blocks, "halo": plan.halo,
        "seg": plan.seg, "taps": plan.kernel_len, "shift": plan.shift,
        "C": C, "T": T,
        "db_plain": db_json(db_plain), "db_oracle_2ch": db_json(db_oracle),
        "max_abs_err": max_err, "ms": ms, "queued_ms": queued,
        "plain_ms": plain_ms, "library_ms": library_ms,
        **roofline_row(rl.conv_cost_from_params(C, T, fir_e.params), ms=ms,
                       plain_ms=plain_ms, library_ms=library_ms),
        # what this design must move: the signal n/seg times in, once out
        "bound_with_window_overlap_ms": bound(rl.simple_cost(
            C, T, plan.n / plan.seg, 1.0))["bound_ms"],
        "segconv_versions": versions,
    }
    return y_kernel


# rows 1-6's launches queued behind one spin (each 0.25-1.3 ms on the
# device, a few tens of microseconds of the host's)
RELAYOUT_QUEUED_RUNS = 20


def time_reverb_parts(x) -> dict:
    """reverb(1500)'s FIR partitions (its combined kernel, 4 x 16,385 taps
    at a window of 32,768 over a cluster of two, then 1,285 at 16,384 in
    one block) at the main-path shape, one launch each: the first partition
    writing the output, the second and the last adding into it (the
    accumulate mode), each held to its plain version and timed by events
    and queued. Beside each time, its blocks in waves of one block an SM
    (a block holds 16,384 points: one fits an SM), the time a block
    (``us_per_block``: the queued time over the waves) and the bound's:
    the cost model of ``roofline.conv_cost`` at the plan's window, 4 C T
    bytes more in the accumulate mode (the output read back), as the
    benchmark's ``kernel.segconv_parts.roofline_pct`` costs a partition."""
    C, T = x.shape
    cfg = pt.EngineConfig(SAMPLE_RATE, BLOCK_SIZES[0])
    plans = pt.ops.reverb(cfg, REVERB_MS, device="cuda").params.full.plans
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    base = torch.randn(C, T, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(19))
    rows = {}
    for name, k, acc in (("part0", 0, False), ("part1", 1, True),
                         (f"part{len(plans) - 1}", len(plans) - 1, True)):
        plan = plans[k]
        y = base.clone() if acc else None

        def launch(plan=plan, y=y):
            return segconv._launch(x, plan, into=y)

        want = segconv.segmented_conv_plain(x, plan)
        if acc:
            got = base.clone()
            segconv._launch(x, plan, into=got)
            want += base
        else:
            got = launch()
        db = snr_db_cuda(want, got)
        assert db >= CONV_DB_PLAIN, (name, db)
        del got, want
        ms = time_ms(launch)
        queued = queued_ms(launch, RELAYOUT_QUEUED_RUNS)
        cost = rl.conv_cost(C, T, plan.n, plan.seg)
        if acc:
            cost = {**cost, "bytes": cost["bytes"] + 4 * C * T}
        b = bound(cost)
        waves = C * -(-(-(-T // plan.seg)) // 2) * plan.blocks / sms
        rows[name] = {
            "taps": plan.kernel_len, "n": plan.n, "halo": plan.halo,
            "seg": plan.seg, "blocks_a_pair": plan.blocks,
            "accumulate": acc, "db_plain": db_json(db), "ms": ms,
            "queued_ms": queued, "waves": waves,
            "us_per_block": queued * 1e3 / waves,
            "bound_us_per_block": b["bound_ms"] * 1e3 / waves,
            "roofline_pct": 100.0 * b["bound_ms"] / queued, **b}
        del y
    del base
    return {"C": C, "T": T, "sms": sms, "by_partition": rows}


def time_dynamics(x, dyn_e, timing: dict, B: int) -> torch.Tensor:
    """The two walks at the shapes and on the data the main path gives them
    (the conv stage's output as it lies, the planner's segments, the entries
    the loop passes); beside them pack and unpack, which the main path no
    longer launches, at the geometry they had on it. Returns the stage's
    output."""
    C, T = x.shape
    scalars = [kdyn.op_scalars(p) for p in dyn_e.params]
    n_ops = len(scalars)
    G, L, Rp = relayout.geometry(C, T, kdyn.plan_segments(C, T))
    R = C * G
    geom = {"C": C, "T": T, "G": G, "L": L, "lanes": R}
    # the time-major layout's share of the signal's bytes (its padded lanes)
    tm_passes = L * Rp / (C * T)
    not_on_path = "not launched by the main path since the walks read " \
                  "(C, T); timed at the geometry it had there"

    tm = relayout.pack(x, G, L, Rp)
    tm_plain = relayout.pack(x, G, L, Rp, use_kernels=False)
    assert torch.equal(tm, tm_plain), "pack differs from its plain version"
    err = float((tm - tm_plain).abs().max())
    del tm_plain
    lib_in = x if G * L == T else torch.nn.functional.pad(x, (0, G * L - T))
    t = {"ms": time_ms(lambda: relayout.pack(x, G, L, Rp)),
         "plain_ms": time_ms(
             lambda: relayout.pack(x, G, L, Rp, use_kernels=False)),
         # one PyTorch call: the strided copy (on a length padded beforehand
         # where the last segment is ragged)
         "library_ms": time_ms(
             lambda: lib_in.reshape(C, G, L).permute(2, 1, 0).contiguous()),
         # the card's practical ceiling for the same bytes: a plain copy
         "copy_ms": time_ms(lambda: torch.empty_like(x).copy_(x)),
         # the kernel and the copy with their launches queued behind a spin:
         # device time without the host's pace between the events
         "queued_ms": queued_ms(lambda: relayout.pack(x, G, L, Rp),
                                RELAYOUT_QUEUED_RUNS),
         "copy_queued_ms": queued_ms(lambda: torch.empty_like(x).copy_(x),
                                     RELAYOUT_QUEUED_RUNS)}
    timing["pack"][B] = {
        **geom, "Rp": Rp, "max_abs_err": err, "note": not_on_path, **t,
        **roofline_row(rl.simple_cost(C, T, 1.0, tm_passes), **t)}
    del lib_in
    y = relayout.unpack(tm, C, T, G, L)
    y_plain = relayout.unpack(tm, C, T, G, L, use_kernels=False)
    assert torch.equal(y, y_plain), "unpack differs from its plain version"
    assert torch.equal(y, x)
    err = float((y - y_plain).abs().max())
    del y, y_plain
    tm_off = offset_view(tm)
    t = {"ms": time_ms(lambda: relayout.unpack(tm, C, T, G, L)),
         "plain_ms": time_ms(
             lambda: relayout.unpack(tm, C, T, G, L, use_kernels=False)),
         "library_ms": time_ms(
             lambda: tm[:, :C * G].reshape(L, G, C).permute(2, 1, 0)
             .contiguous()),
         "copy_ms": time_ms(lambda: torch.empty_like(tm).copy_(tm)),
         "queued_ms": queued_ms(lambda: relayout.unpack(tm, C, T, G, L),
                                RELAYOUT_QUEUED_RUNS),
         "copy_queued_ms": queued_ms(lambda: torch.empty_like(tm).copy_(tm),
                                     RELAYOUT_QUEUED_RUNS),
         # the masked path on the same geometry (tm one float off 16 bytes),
         # queued as the line above
         "masked_path_queued_ms": queued_ms(
             lambda: relayout.unpack(tm_off, C, T, G, L),
             RELAYOUT_QUEUED_RUNS)}
    assert torch.equal(relayout.unpack(tm_off, C, T, G, L), x)
    timing["unpack"][B] = {
        **geom, "Rp": Rp, "max_abs_err": err, "note": not_on_path,
        "tiles": dict(zip(("box", "masked"),
                          relayout.box_tiles(tm, x, C, T, G, L))),
        "tiles_tm_off": dict(zip(("box", "masked"), relayout.box_tiles(
            tm_off, x, C, T, G, L))), **t,
        **roofline_row(rl.simple_cost(C, T, tm_passes, 1.0), **t)}
    assert timing["unpack"][B]["tiles"]["masked"] == 0
    assert timing["unpack"][B]["tiles_tm_off"]["box"] == 0
    del tm, tm_off

    # the loop's first two walks: the state walk from REST, then the audio
    # walk from its shifted exits
    e0 = torch.zeros((n_ops, R), dtype=torch.int32, device=x.device)
    z1 = kdyn.state_walk(scalars, x, G, L, e0)
    z1_plain, state_plain_ms = once_ms(
        lambda: kdyn.state_walk(scalars, x, G, L, e0, use_kernels=False))
    assert torch.equal(z1, z1_plain), "state walk: exit states differ"
    ms = time_ms(lambda: kdyn.state_walk(scalars, x, G, L, e0))
    timing["state_walk"][B] = {
        **geom, "n_ops": n_ops, "exit_states_equal": True,
        "max_abs_err": float((z1 - z1_plain).abs().max()),
        "ms": ms, "queued_ms": queued_ms(
            lambda: kdyn.state_walk(scalars, x, G, L, e0),
            RELAYOUT_QUEUED_RUNS),
        "plain_ms": state_plain_ms,
        "plain_ran_with": f"G={G}, a Python loop over L={L} rows, its one "
                          "correctness run timed",
        "library_ms": None,
        **roofline_row(rl.dynamics_cost(C, T, n_ops, audio=False, lanes=R),
                       ms=ms, plain_ms=state_plain_ms)}
    e1 = torch.zeros_like(z1)
    e1[:, C:R] = z1[:, :R - C]
    del z1, z1_plain
    out, z2 = kdyn.audio_walk(scalars, x, G, L, e1)
    (out_plain, z2_plain), audio_plain_ms = once_ms(
        lambda: kdyn.audio_walk(scalars, x, G, L, e1, use_kernels=False))
    mismatching = int((out != out_plain).sum())
    assert torch.equal(z2, z2_plain), "audio walk: exit states differ"
    assert mismatching == 0, f"audio walk: {mismatching} samples differ"
    err = float((out - out_plain).abs().max())
    del out_plain, z2_plain, out
    ms = time_ms(lambda: kdyn.audio_walk(scalars, x, G, L, e1))
    timing["audio_walk"][B] = {
        **geom, "n_ops": n_ops, "exit_states_equal": True,
        "mismatching_samples": mismatching, "max_abs_err": err,
        "ms": ms, "queued_ms": queued_ms(
            lambda: kdyn.audio_walk(scalars, x, G, L, e1),
            RELAYOUT_QUEUED_RUNS),
        "plain_ms": audio_plain_ms,
        "plain_ran_with": f"G={G}, a Python loop over L={L} rows, its one "
                          "correctness run timed",
        "library_ms": None,
        **roofline_row(rl.dynamics_cost(C, T, n_ops, audio=True, lanes=R),
                       ms=ms, plain_ms=audio_plain_ms)}
    # what the loop returns, whether or not it needed a third walk
    return kdyn.dynamics_offline(list(dyn_e.params), x)


def stage_walks(fn):
    """(result, walks) of one call of a dynamics stage."""
    w0 = kdyn.state_walk_launch_count + kdyn.audio_walk_launch_count
    result = fn()
    torch.cuda.synchronize()
    return result, (kdyn.state_walk_launch_count
                    + kdyn.audio_walk_launch_count - w0)


def check_dynamics_stage(x, dyn_e, y_dyn) -> dict:
    """The fused effect's whole ``offline`` (the walks to the fixpoint on
    (C, T) as it lies, with one read-back each) on the conv stage's output,
    against the loop's own result and the plain stage."""
    C, T = x.shape
    blocks = x.reshape(C, 1, T)
    got, walks = stage_walks(lambda: dyn_e.offline(dyn_e.params, blocks))
    assert torch.equal(got.reshape(C, T), y_dyn)
    plain = dyn_e.offline(dyn_e.params, blocks, use_kernels=False)
    mismatching = int((got != plain).sum())
    assert mismatching == 0, f"dynamics stage: {mismatching} samples differ"
    return {"segments": kdyn.plan_segments(C, T), "walks": walks,
            "mismatching_samples_vs_plain": mismatching}


def sweep_segments(x, dyn_e, want) -> list:
    """The whole dynamics stage for a range of segment counts: the result
    does not depend on the count (checked), the time and the walks do."""
    params = list(dyn_e.params)
    rows = []
    for segments in SWEEP_SEGMENTS:
        got, walks = stage_walks(
            lambda: kdyn.dynamics_offline(params, x, segments=segments))
        if want is None:
            want = got
        assert torch.equal(got, want), f"segments={segments} changes the result"
        del got
        G, L, _ = relayout.geometry(x.shape[0], x.shape[1], segments)
        rows.append({"G": G, "L": L, "lanes": x.shape[0] * G, "walks": walks,
                     "ms": time_ms(lambda: kdyn.dynamics_offline(
                         params, x, segments=segments), runs=3)})
    return rows


# Tiles of the tail's geometry sweep.
TAIL_TILES = (4096, 2048, 1024)


def time_tail(x, chain, tail_e, by_B: dict, B: int) -> None:
    """The fused tail, fed what the dynamics stage feeds it. Beside it, each
    equal to the planner's choice and timed twice in turns: the kernel by
    tile at the runs the planner gives each; by runs of tiles per channel
    at the planner's geometry, up to one tile a run (every block reads its
    tile's halo: the schedule before the walk along time). Then the run's
    stage prefixes, for what each stage adds."""
    C, T = x.shape
    members = tail_e.params
    stages, _, _, D = tail._plan_stages(chain.effects[5:])
    plan = tail.make_plan(stages, D, members, x.device)
    nb = T // B
    gains = torch.stack([gain_row(p, nb, B, x.device) for p in members
                         if isinstance(p, TremoloParams)])
    blocks = x.reshape(C, nb, B)
    t_kernel = tail.tail_kernel(plan, x, gains)
    t_plain = tail_e.offline(members, blocks, use_kernels=False).reshape(C, T)
    torch.cuda.synchronize()
    t_err = float((t_kernel - t_plain).abs().max())
    t_db = snr_db_cuda(t_plain, t_kernel)
    assert t_db >= TAIL_DB_PLAIN, (B, t_db)
    del t_plain
    sms = tail._sm_count(x.device)
    runs = tail.runs_for(plan, C, T, sms)
    n_tiles = -(-T // plan.tile)
    cases = {f"runs={r}": (plan, r) for r in
             sorted({1, 2, runs, 2 * runs, 16, 64, n_tiles})}
    for S in TAIL_TILES:
        p = tail.make_plan(stages, D, members, x.device, tile=S)
        cases[f"tile={S}"] = (p, tail.runs_for(p, C, T, sms))
    # what the stages cost: the run's prefixes (the delay alone, then with
    # the tremolo) at their own geometry
    prefixes = {}
    for k in range(1, len(stages)):
        sub = stages[:k]
        p = tail.make_plan(sub, sum(max(st[1], default=0) for st in sub
                                    if st[0] == "taps"), members[:k], x.device)
        g = gains if any(st[0] == "gain" for st in sub) else None
        prefixes["+".join(st[1] if st[0] == "map" else st[0] for st in sub)] \
            = time_ms(lambda: tail.tail_kernel(p, x, g))
    for name, (p, r) in cases.items():
        assert torch.equal(tail.tail_kernel(p, x, gains, runs=r), t_kernel), \
            f"{name} changes the result"
    del t_kernel
    ms = {name: [] for name in cases}
    for name in list(cases) + list(cases)[::-1]:
        p, r = cases[name]
        ms[name].append(time_ms(lambda: tail.tail_kernel(p, x, gains, runs=r)))
    t = {"ms": time_ms(lambda: tail.tail_kernel(plan, x, gains)),
         "plain_ms": time_ms(
             lambda: tail_e.offline(members, blocks, use_kernels=False))}
    queued = queued_ms(lambda: tail.tail_kernel(plan, x, gains),
                       RELAYOUT_QUEUED_RUNS)
    by_B[B] = {
        "halo": D, "tile": plan.tile, "runs": runs,
        "n_tiles": n_tiles, "warm_tiles": plan.warm_tiles,
        "ring_floats": plan.ring_floats,
        "rings_in_shared_memory": plan.ring_smem,
        "blocks_per_sm": plan.blocks_per_sm, "C": C, "T": T,
        "db_plain": db_json(t_db), "max_abs_err": t_err, **t,
        "queued_ms": queued,
        "library_ms": None,
        **roofline_row(rl.tail_cost(C, T, stages, gains.numel()), **t),
        "one_tile_a_run_ms": ms[f"runs={n_tiles}"],
        "sweep_ms": {name: {"tile": p.tile, "runs": r,
                            "blocks_per_sm": p.blocks_per_sm, "ms": ms[name]}
                     for name, (p, r) in cases.items()},
        "stage_prefix_ms": prefixes,
        # what one read and one write of the signal take here: the bytes
        # side of the bound as the card reaches it
        "copy_ms": time_ms(lambda: x.clone()),
    }


# ---------------------------------------------------------------------------
# phase 5: the streaming path


def stream_run(chain, cfg, x: torch.Tensor, as_numpy: bool = False,
               save_at: int | None = None, save_path: str | None = None):
    """Stream x (C, T) block by block through a fresh, warmed-up
    StreamProcessor, every launch count set to 0 just before the first block
    and read just after the last. Returns (outputs, the counts). With
    ``as_numpy`` the blocks go in and come out as numpy arrays; otherwise
    nothing waits until the end. ``save_at`` writes a checkpoint before that
    step."""
    C, T = x.shape
    B = cfg.block_size
    sp = pt.StreamProcessor(chain, cfg, (C,))
    sp.warmup()
    src = x.cpu().numpy() if as_numpy else x
    outs = []
    torch.cuda.synchronize()
    zero_launch_counts()
    for i in range(T // B):
        if i == save_at:
            sp.save_state(save_path)
        outs.append(sp.process(src[:, i * B:(i + 1) * B]))
    counts = launch_counts()
    torch.cuda.synchronize()
    return outs, counts


def eager_run(chain, cfg, x: torch.Tensor, as_numpy: bool = False):
    """The eager ``Chain.step`` folded over x (C, T), counted as
    :func:`stream_run` counts the processor (the same returns): what a
    ``StreamProcessor`` did before the step was captured. One step on
    silence first, discarded, as ``warmup`` did; with ``as_numpy`` a block
    goes to the card and its output comes back as numpy, one copy each
    way."""
    C, T = x.shape
    B = cfg.block_size
    state = chain.init_state((C,))
    chain.step(state, torch.zeros((C, B), device="cuda"))
    src = x.cpu().numpy() if as_numpy else x
    outs = []
    torch.cuda.synchronize()
    zero_launch_counts()
    for i in range(T // B):
        blk = src[:, i * B:(i + 1) * B]
        if as_numpy:
            blk = torch.from_numpy(np.ascontiguousarray(blk)).cuda()
        state, y = chain.step(state, blk)
        outs.append(y.cpu().numpy() if as_numpy else y)
    counts = launch_counts()
    torch.cuda.synchronize()
    return outs, counts


def graph_ms(fn, steps: int = GRAPH_STEPS, replays: int = 5) -> float:
    """Device time of one call of ``fn`` when ``steps`` calls are captured
    in one CUDA graph and the graph is replayed: no host launch between the
    calls, so the launch rate does not show (measurement only: the launch
    counters are put back after the capture)."""
    fn()
    torch.cuda.synchronize()
    saved = [getattr(m, a) for m, a in pt_graph.LAUNCH_COUNTERS]
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(steps):
            fn()
    for (m, a), v in zip(pt_graph.LAUNCH_COUNTERS, saved):
        setattr(m, a, v)
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (replays * steps)


def plain_chain_step(chain, scalars, state, block):
    """One step of chain8 through the plain versions of the two streaming
    kernels (the tail's members have no kernel in their steps)."""
    fir_e, dyn_e, tail_e = chain.exec_effects
    s_fir, s_dyn, s_tail = state
    s_fir, block = fft_filter.fir_step(fir_e.params, s_fir, block,
                                       use_kernels=False)
    s_dyn, block = kdyn.cascade_step(scalars, dyn_e.params, s_dyn, block,
                                     use_kernels=False)
    s_tail, block = tail_e.step(tail_e.params, s_tail, block)
    return (s_fir, s_dyn, s_tail), block


def fold_steps(effect, x: torch.Tensor, B: int, step=None) -> torch.Tensor:
    """One effect's step (or ``step``, another function of the same
    arguments) folded over the blocks of x (C, T)."""
    step = effect.step if step is None else step
    state = effect.state((x.shape[0],))
    outs = []
    for i in range(x.shape[1] // B):
        state, y = step(effect.params, state, x[:, i * B:(i + 1) * B])
        outs.append(y)
    return torch.cat(outs, dim=-1)


def stream_path(chain, cfg, signal, n: int, offline_out: torch.Tensor,
                oracle: np.ndarray, workdir: str) -> tuple[dict, dict]:
    """Drive and check the streaming main path at one block size. Returns
    (checks, launch counts of the counted run)."""
    C, B = signal.shape[0], cfg.block_size
    T = -(-n // B) * B
    nb = T // B
    x = torch.nn.functional.pad(signal, (0, T - n)).contiguous()
    fir_e, dyn_e, tail_e = chain.exec_effects

    # the counted run: tensors in and out, nothing waits
    outs, counts = stream_run(chain, cfg, x)
    # one circular convolution and one serial walk a step, nothing else
    assert all(v == (nb if k in STREAM_KERNELS else 0)
               for k, v in counts.items()), counts
    streamed = torch.cat(outs, dim=-1)
    del outs
    assert streamed.shape == (C, T) and streamed.dtype == torch.float32
    assert bool(torch.isfinite(streamed).all())
    r = {"steps": nb, "launches": counts,
         "window": fir_e.params.stream.n, "lead": fir_e.params.lead,
         "history_samples": fft_filter.history_len(fir_e.params),
         "peak": float(streamed.abs().max())}

    # against the offline kernel render, whole and stage by stage
    r["db_offline"] = db_json(snr_db_cuda(offline_out, streamed))
    blocks = x.reshape(C, nb, B)
    y_conv = fir_e.offline(fir_e.params, blocks).reshape(C, T)
    r["db_fir_stage"] = db_json(snr_db_cuda(y_conv, fold_steps(fir_e, x, B)))
    dyn_off = dyn_e.offline(dyn_e.params, y_conv.reshape(C, nb, B))
    dyn_stream = fold_steps(dyn_e, y_conv, B)
    r["dynamics_stage_mismatching_samples"] = int(
        (dyn_stream != dyn_off.reshape(C, T)).sum())
    del y_conv, dyn_off, dyn_stream, blocks

    # against the plain-version stream over a short excerpt
    k = PLAIN_STREAM_STEPS[B]
    scalars = [kdyn.op_scalars(p) for p in dyn_e.params]
    state = chain.init_state((C,))
    plain = []
    before = launch_counts()
    for i in range(k):
        state, y = plain_chain_step(chain, scalars, state,
                                    x[:, i * B:(i + 1) * B])
        plain.append(y)
    assert launch_counts() == before, "a plain step launched a kernel"
    r["plain_stream_steps"] = k
    r["db_plain_stream"] = db_json(snr_db_cuda(torch.cat(plain, dim=-1),
                                               streamed[:, :k * B]))
    del plain, state

    # against the float64 oracle excerpt (first and last channel)
    m = oracle.shape[1]
    r["db_oracle_2ch"] = db_json(snr_db(
        oracle, streamed[[0, C - 1], :m].cpu().numpy()))
    r["oracle_samples"] = m

    # numpy in and out, with a checkpoint written in mid-stream ...
    half = nb // 2
    ckpt = os.path.join(workdir, f"stream_{B}.npz")
    outs_np, _ = stream_run(chain, cfg, x, as_numpy=True, save_at=half,
                            save_path=ckpt)
    r["numpy_stream_equal"] = bool(np.array_equal(
        np.concatenate(outs_np, axis=-1), streamed.cpu().numpy()))
    del outs_np
    # ... which a fresh processor loads and continues from, bit-equal
    sp = pt.StreamProcessor(chain, cfg, (C,))
    sp.load_state(ckpt)
    resumed = torch.cat([sp.process(x[:, i * B:(i + 1) * B])
                         for i in range(half, nb)], dim=-1)
    r["checkpoint_resume_equal"] = torch.equal(resumed, streamed[:, half * B:])
    r["checkpoint_bytes"] = os.path.getsize(ckpt)
    del resumed, sp

    # the segmented render IS the streamed fold
    seg = pt.render_segmented(chain, signal, cfg, segment_blocks=512)
    r["render_segmented_equal"] = torch.equal(seg, streamed)
    del seg

    # the resumable render with a stop injected after two segments of four
    if B == BLOCK_SIZES[0]:
        ck_dir = os.path.join(workdir, f"resumable_{B}")
        blocks = x.reshape(C, nb, B)
        per = -(-nb // 4)
        try:
            pt.render_resumable(chain, blocks, ck_dir, segment_blocks=per,
                                stop_after=2)
        except RuntimeError as e:
            assert "injected fault" in str(e)
        else:
            raise AssertionError("the injected stop did not stop the render")
        with open(os.path.join(ck_dir, "meta.json")) as f:
            assert json.load(f)["segment"] == 2
        res = pt.render_resumable(chain, blocks, ck_dir, segment_blocks=per)
        r["render_resumable_equal"] = torch.equal(res.reshape(C, T), streamed)
        assert r["render_resumable_equal"], r
        del res, blocks

    assert snr_db_cuda(offline_out, streamed) >= CHAIN8_DB_PLAIN, r
    assert r["db_fir_stage"] >= STREAM_FIR_DB, r
    assert r["dynamics_stage_mismatching_samples"] == 0, r
    assert r["db_plain_stream"] is None \
        or r["db_plain_stream"] >= CHAIN8_DB_PLAIN, r
    assert r["db_oracle_2ch"] >= CHAIN_DB_ORACLE, r
    assert r["numpy_stream_equal"] and r["checkpoint_resume_equal"] \
        and r["render_segmented_equal"], r
    assert 0.0 < r["peak"] <= 1.0, r
    return r, counts


def compiled_step_phase(chains: dict, signal: torch.Tensor, n: int,
                        oracles: dict, workdir: str, smi: str) -> dict:
    """The captured step (``Chain.captured_step``, through
    ``StreamProcessor``) against the eager ``Chain.step`` fold, chain8 at
    64 ch x 30 s, B=4096 and 512: bit-equal over the whole stream; the dB
    to the float64 oracle excerpt; one ``conv_pairs`` and one
    ``serial_walk`` launch counted a step; the whole replay loop (tensors in
    and out) under ``torch.cuda.set_sync_debug_mode("error")``; a checkpoint
    in mid-stream resumed bit-equal in a fresh processor."""
    C = signal.shape[0]
    by_B, counts_by_run = {}, {}
    for B in BLOCK_SIZES:
        cfg, chain = chains[B]
        T = -(-n // B) * B
        nb = T // B
        x = torch.nn.functional.pad(signal, (0, T - n)).contiguous()
        expect = {k: (nb if k in STREAM_KERNELS else 0) for k in KERNELS}
        sp = pt.StreamProcessor(chain, cfg, (C,))
        sp.warmup()
        per_step = sp._captured.launches_per_step((C, B))
        outs, g_counts = stream_run(chain, cfg, x)
        graph_out = torch.cat(outs, dim=-1)
        outs, e_counts = eager_run(chain, cfg, x)
        bit_equal = torch.equal(graph_out, torch.cat(outs, dim=-1))
        del outs
        m = oracles[B].shape[1]
        db_oracle = snr_db(oracles[B],
                           graph_out[[0, C - 1], :m].cpu().numpy())

        # the replay loop may not synchronise
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            synced = [sp.process(x[:, i * B:(i + 1) * B]) for i in range(nb)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        no_sync_equal = torch.equal(torch.cat(synced, dim=-1), graph_out)
        del synced

        # checkpoint in mid-stream, resumed in a fresh processor
        half = nb // 2
        sp.reset()
        for i in range(half):
            sp.process(x[:, i * B:(i + 1) * B])
        ckpt = os.path.join(workdir, f"compiled_{B}.npz")
        sp.save_state(ckpt)
        sp2 = pt.StreamProcessor(chain, cfg, (C,))
        sp2.load_state(ckpt)
        resumed = torch.cat([sp2.process(x[:, i * B:(i + 1) * B])
                             for i in range(half, nb)], dim=-1)
        resume_equal = torch.equal(resumed, graph_out[:, half * B:])
        del resumed, graph_out
        r = {"steps": nb, "bit_equal_to_eager_fold": bit_equal,
             "db_oracle_2ch": db_json(db_oracle), "oracle_samples": m,
             "launches_graph": g_counts, "launches_eager": e_counts,
             "captured_launches_per_step": per_step,
             "no_sync_replay_loop_equal": no_sync_equal,
             "checkpoint_resume_equal": resume_equal}
        assert bit_equal and no_sync_equal and resume_equal, r
        assert g_counts == expect and e_counts == expect, r
        assert per_step == {"convpairs.launch_count": 1,
                            "dynamics.serial_walk_launch_count": 1}, r
        assert db_oracle >= CHAIN_DB_ORACLE, r
        by_B[str(B)] = r
        counts_by_run[f"graph_{B}"] = g_counts
        del x
    return {"phase": "compiled_step", "chain": "chain8", "channels": C,
            "seconds_of_audio": SECONDS, "by_block_size": by_B,
            "launch_counts": counts_by_run, "nvidia_smi": smi}


# The gate's release of the long-release variant of chain8 in the
# compiled_render phase: 88,200 samples, 17 segments of the planner's 5,168
# at 64 ch x 30 s, so a burst followed by silence hands the gate's state on
# across them, one segment a walk.
LONG_RELEASE_MS = 2000.0
# Seconds of noise bursts before the silence of that signal.
BURST_SECONDS = 1.0
# Blocks (B=512) of the excerpt render_segmented folds there, and per segment.
SEGMENTED_BLOCKS = 256
SEGMENTED_PER = 48
# The excerpt of that signal (its first channels and seconds: 1 s of bursts,
# 3 s of silence) whose dynamics pair the plain render walks: its walks are
# Python loops over a segment's samples (86 segments of 2,052 here).
PLAIN_WALK_CHANNELS = 2
PLAIN_WALK_SAMPLES = 4 * SAMPLE_RATE


def render_lengths(chain, cfg, signal: torch.Tensor, n: int) -> dict:
    """``render`` of one chain over signals of several lengths (the full
    one, a third, the full one again, two thirds, the full one): the chain
    keeps one graph, so after each render (and ``empty_cache``) the card
    holds what the graph of that length holds, not the graphs of every
    length met. MiB reserved over what was held before."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    lengths = (n, n // 3, n, 2 * n // 3, n)
    held, kept = [], []
    for m in lengths:
        y = pt.render(chain, signal[:, :m], cfg)
        del y
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held.append((torch.cuda.memory_reserved() - base) / 2**20)
        kept.append(len(chain.captured_render().shapes()))
    r = {"lengths": list(lengths), "reserved_mib_after_each": held,
         "graphs_kept_after_each": kept}
    assert kept == [1] * len(lengths), r
    # slack for the small caches a length adds (the tremolo's schedule)
    assert max(held[2], held[4]) <= held[0] + 16.0, r
    assert held[1] < held[0] and held[3] < held[0], r
    return r


def settle_cases(C: int, T: int) -> dict:
    """The settle step (no TPU kernel: the fixpoint's shift, comparison and
    count) on the card against ``settle_plain`` on copies of the same
    inputs, at chain8's entries at C x T ((2, C*G) int32): entries that have
    settled and entries that have not, after the state walk and after an
    audio walk, the entries and all four flags exactly. Then the kernel in a
    while node of its own, its exits changed every walk (the entries never
    settle) or left alone, against the host's loop over the plain version:
    the same walks, the bound G + 2 and the unsettled count."""
    G, _, _ = relayout.geometry(C, T, kdyn.plan_segments(C, T))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    cases = []
    for settled in (False, True):
        z = torch.randint(-1, 30000, (2, C * G), generator=gen,
                          device="cuda", dtype=torch.int32)
        e = torch.randint(-1, 30000, (2, C * G), generator=gen,
                          device="cuda", dtype=torch.int32)
        if settled:
            e[:, C:] = z[:, :-C]
            e[:, :C] = 0
        for mode in (kdyn.AFTER_STATE_WALK, kdyn.AFTER_AUDIO_WALK):
            flags = torch.tensor([5, 9, 4, 2], dtype=torch.int32,
                                 device="cuda")
            want_e, want_f = e.clone(), flags.clone()
            kdyn.settle_plain(z, want_e, want_f, C, mode)
            got_e, got_f = e.clone(), flags.clone()
            kdyn.settle(z, got_e, got_f, C, mode)
            case = {"settled": settled, "mode": mode,
                    "entries_equal": torch.equal(got_e, want_e),
                    "flags": got_f.tolist(), "plain_flags": want_f.tolist()}
            assert case["entries_equal"] \
                and case["flags"] == case["plain_flags"] \
                and case["flags"][kdyn.FLAG_DONE] == int(settled), case
            cases.append(case)
    loops = []
    limit = G + 2
    for moving in (True, False):
        z0 = torch.randint(0, 30000, (2, C * G), generator=gen,
                           device="cuda", dtype=torch.int32)
        z, e = z0.clone(), torch.zeros_like(z0)
        f = torch.zeros(4, dtype=torch.int32, device="cuda")
        kdyn.settle_plain(z, e, f, C, kdyn.AFTER_STATE_WALK)
        unsettled = 0
        while True:
            if moving:
                z.add_(1)
            kdyn.settle_plain(z, e, f, C, kdyn.AFTER_AUDIO_WALK)
            done, walks = f[:2].tolist()
            if done:
                break
            if walks >= limit:
                unsettled = 1
                break
        want = f.tolist()[:3] + [unsettled]
        zc, ec = z0.clone(), torch.zeros_like(z0)
        fc = torch.zeros(4, dtype=torch.int32, device="cuda")
        graph_cond.body_stream(torch.device("cuda"))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            kdyn.settle(zc, ec, fc, C, kdyn.AFTER_STATE_WALK)
            with graph_cond.while_node("cuda") as handle:
                if moving:
                    zc.add_(1)
                kdyn.settle(zc, ec, fc, C, kdyn.IN_WHILE_NODE, limit, handle)
        fc.zero_()
        zc.copy_(z0)
        graph.replay()
        loop = {"exits_change_every_walk": moving, "limit": limit,
                "flags": fc.tolist(), "host_loop_flags": want,
                "entries_equal": torch.equal(ec, e)}
        assert loop["flags"] == want and loop["entries_equal"], loop
        loops.append(loop)
        del graph
    return {"entries_shape": [2, C * G], "C": C, "G": G, "cases": cases,
            "while_node_loops": loops}


def plain_walks_case(pair, cfg, burst: torch.Tensor) -> dict:
    """chain8's dynamics pair (``pair``, its compressor and gate) on a burst
    followed by silence (the first channels of the main signal's burst): the
    captured render against the plain render (``use_kernels=False``: every
    walk and settle step a plain version, read back once a walk) on the same
    input, the output and the walk count exactly."""
    chain = pt.Chain(pair, device="cuda")
    blocks = pt.block.make_blocks(burst, cfg.block_size)
    with graph_cond.fixpoints() as found:
        plain = chain.render_blocks(blocks, use_kernels=False)
    plain_walks = [int(f[kdyn.FLAG_WALKS]) for f in found]
    captured = chain.captured_render()
    got = captured(blocks)
    walks = captured.walks()[tuple(blocks.shape)]
    r = {"blocks_shape": list(blocks.shape), "walks": walks,
         "plain_walks": plain_walks, "bit_equal_to_plain":
             torch.equal(got, plain)}
    assert r["bit_equal_to_plain"] and walks == plain_walks, r
    assert walks[0] > 2, r
    captured.release()
    return r


def compiled_render_phase(chains: dict, signal: torch.Tensor, n: int,
                          main_outputs: dict, oracles: dict, workdir: str,
                          smi: str) -> dict:
    """The settle step against its plain version (``settle_cases``), then
    the captured render (``Chain.captured_render``, what ``render``
    replays) against the eager ``Chain.render_blocks``, chain8 at 64 ch x
    30 s, B=4096 and 512: bit-equal to the eager render and to main_path's
    output, the same dB to the oracle, the same dynamics walks (the device's
    count against the eager loop's read-backs), the launches a replay
    counted from 0, three renders under
    ``torch.cuda.set_sync_debug_mode("error")``. Then: a burst followed by
    silence through chain8 and through a variant whose gate releases over
    2 s (many walks inside the while node), bit-equal to eager, and the
    dynamics pair on its excerpt against the plain render, walks included
    (``plain_walks_case``); two shapes of one chain live at once, an earlier
    output valid after later renders; ``render`` over five lengths keeping
    one graph (``render_lengths``); reverb(1500), the FIR-ised EQ and an
    undecayed-EQ chain bit-equal to their eager renders;
    ``render_segmented`` and ``render_resumable`` (through the captured
    step) bit-equal to the eager ``Chain.step`` fold."""
    C = signal.shape[0]
    by_B, counts_by_run = {}, {}
    shape = render_shape(signal, BLOCK_SIZES[0])
    settle = settle_cases(C, shape[-2] * shape[-1])
    for B in BLOCK_SIZES:
        cfg, chain = chains[B]
        captured = chain.captured_render()
        shape = render_shape(signal, B)
        w0 = kdyn.state_walk_launch_count + kdyn.audio_walk_launch_count
        eager = eager_render(chain, signal, cfg)
        torch.cuda.synchronize()
        eager_walks = kdyn.state_walk_launch_count \
            + kdyn.audio_walk_launch_count - w0
        captured.walks()            # earlier replays' walks counted first
        (got, device_walks), counts = counted(
            lambda: (pt.render(chain, signal, cfg), captured.walks()[shape]))
        settles = kdyn.settle_launch_count
        bit_equal = torch.equal(got, eager)
        main_equal = torch.equal(got, main_outputs[B])
        del eager
        m = oracles[B].shape[1]
        db_oracle = snr_db(oracles[B], got[[0, C - 1], :m].cpu().numpy())

        # the replay loop may not synchronise
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            synced = [pt.render(chain, signal, cfg) for _ in range(3)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        no_sync_equal = all(torch.equal(o, got) for o in synced)
        del synced
        captured.walks()
        r = {"blocks_shape": list(shape), "bit_equal_to_eager": bit_equal,
             "bit_equal_to_main_path": main_equal,
             "db_oracle_2ch": db_json(db_oracle), "oracle_samples": m,
             "dynamics_walks": {"graph_device_count": device_walks,
                                "eager_read_backs": eager_walks},
             "launches_one_replay": counts,
             "settle_step_launches_one_replay": settles,
             "launches_per_replay_outside_while_nodes":
                 captured.launches_per_replay(shape),
             "no_sync_replay_loop_equal": no_sync_equal}
        assert bit_equal and main_equal and no_sync_equal, r
        assert sum(device_walks) == eager_walks, r
        assert counts["audio_walk"] == eager_walks - 1 \
            and counts["state_walk"] == 1 and counts["segconv"] == 1 \
            and counts["tail"] == 1 and settles == eager_walks, r
        assert db_oracle >= CHAIN_DB_ORACLE, r
        by_B[str(B)] = r
        counts_by_run[f"graph_{B}"] = counts
        del got

    # a burst followed by silence: many walks inside the while node
    B = BLOCK_SIZES[0]
    cfg, chain = chains[B]
    burst = signal.clone()
    burst[:, int(BURST_SECONDS * SAMPLE_RATE):] = 0.0
    effects = list(chain.effects)
    effects[4] = pt.ops.gate(cfg, -45.0, 0.1, 3.1, LONG_RELEASE_MS,
                             device="cuda")
    long_release = pt.Chain(effects, device="cuda")
    burst_runs = {}
    for name, ch in (("chain8", chain),
                     (f"chain8, gate release {LONG_RELEASE_MS:.0f} ms",
                      long_release)):
        w0 = kdyn.state_walk_launch_count + kdyn.audio_walk_launch_count
        want = eager_render(ch, burst, cfg)
        torch.cuda.synchronize()
        eager_walks = kdyn.state_walk_launch_count \
            + kdyn.audio_walk_launch_count - w0
        prepare_render(ch, burst, cfg)
        ch.captured_render().walks()
        (got, device_walks), counts = counted(
            lambda: (pt.render(ch, burst, cfg),
                     ch.captured_render().walks()[render_shape(burst, B)]))
        burst_runs[name] = {"walks": device_walks,
                            "eager_walks": eager_walks,
                            "bit_equal_to_eager": torch.equal(got, want),
                            "launches": counts}
        assert burst_runs[name]["bit_equal_to_eager"] \
            and sum(device_walks) == eager_walks \
            and counts["audio_walk"] == eager_walks - 1, burst_runs
        counts_by_run[f"burst_{name}"] = counts
        del want, got
    burst_runs["dynamics_pair_against_the_plain_render"] = plain_walks_case(
        chain.effects[3:5], cfg,
        burst[:PLAIN_WALK_CHANNELS, :PLAIN_WALK_SAMPLES].contiguous())
    assert sum(burst_runs["chain8"]["walks"]) >= 2
    assert sum(burst_runs[f"chain8, gate release {LONG_RELEASE_MS:.0f} ms"][
        "walks"]) > 8, burst_runs
    long_release.captured_render().release()
    del long_release, burst

    # two shapes of one chain live at once (its captured render called on
    # blocks keeps one graph a shape); an earlier output stays valid
    B = 512
    cfg, chain = chains[B]
    captured = chain.captured_render()
    full = pt.block.make_blocks(signal, B)
    short = pt.block.make_blocks(signal[:, :n // 3], B)
    y_full = captured(full)
    keep = y_full.clone()
    y_short = captured(short)
    captured(full * 0.5)
    captured(short * 0.5)
    live = captured.walks()
    two_shapes = {
        "shapes": [list(k) for k in live],
        "earlier_output_valid": torch.equal(y_full, keep),
        "short_bit_equal_to_eager": torch.equal(
            y_short, chain.render_blocks(short))}
    assert len(live) == 2 and two_shapes["earlier_output_valid"] \
        and two_shapes["short_bit_equal_to_eager"], two_shapes
    del y_full, keep, y_short, full, short
    captured.release()
    two_shapes["render_of_many_lengths"] = render_lengths(chain, cfg, signal,
                                                          n)
    captured.walks()

    # the later paths' chains through the captured render
    others = {}
    for name, B, make in (
            (f"reverb({REVERB_MS:.0f})", 4096,
             lambda c: [pt.ops.reverb(c, REVERB_MS, device="cuda")]),
            ("eq3band (FIR-ised)", 512,
             lambda c: [pt.ops.eq3band(c, *EQ_ARGS, device="cuda")]),
            (EQ_CHAIN + " (float64 recurrence)", 4096,
             lambda c: eq_chain_effects(c, "cuda"))):
        cfg = pt.EngineConfig(SAMPLE_RATE, B)
        ch = pt.Chain(make(cfg), device="cuda")
        want = eager_render(ch, signal, cfg)
        prepare_render(ch, signal, cfg)
        got, counts = counted(lambda: pt.render(ch, signal, cfg))
        others[name] = {"B": B, "bit_equal_to_eager": torch.equal(got, want),
                        "launches": counts}
        assert others[name]["bit_equal_to_eager"], others
        ch.captured_render().release()
        del ch, got, want

    # render_segmented / render_resumable fold the captured step
    cfg, chain = chains[512]
    xs = signal[:, :SEGMENTED_BLOCKS * 512 - 17].contiguous()
    blocks = pt.block.make_blocks(xs, 512)
    state, outs = chain.init_state((C,)), []
    for i in range(blocks.shape[-2]):
        state, y = chain.step(state, blocks[:, i])
        outs.append(y)
    fold = torch.cat(outs, dim=-1)
    del outs
    chain.fold_step((C,)).capture((C, 512))     # its warm-up uncounted
    seg, seg_counts = counted(lambda: pt.render_segmented(
        chain, xs, cfg, segment_blocks=SEGMENTED_PER))
    res = pt.render_resumable(chain, blocks,
                              os.path.join(workdir, "resumable_512"),
                              segment_blocks=SEGMENTED_PER)
    segmented = {"blocks": blocks.shape[-2], "segment_blocks": SEGMENTED_PER,
                 "render_segmented_equal": torch.equal(seg, fold),
                 "render_resumable_equal": torch.equal(
                     res.reshape(C, -1), fold),
                 "launches": seg_counts}
    assert segmented["render_segmented_equal"] \
        and segmented["render_resumable_equal"], segmented
    assert seg_counts["conv_pairs"] == seg_counts["serial_walk"] \
        == blocks.shape[-2], seg_counts
    counts_by_run["render_segmented_512"] = seg_counts
    return {"phase": "compiled_render", "chain": "chain8", "channels": C,
            "seconds_of_audio": SECONDS,
            "while_node_cuda_versions": dict(zip(
                ("driver", "runtime"), graph_cond.cuda_versions())),
            "settle_step": settle,
            "by_block_size": by_B, "burst_then_silence": burst_runs,
            "two_shapes": two_shapes, "other_chains": others,
            "render_segmented": segmented,
            "launch_counts": counts_by_run, "nvidia_smi": smi}


# ---------------------------------------------------------------------------
# phase 5b: windows no thread block holds, kernels longer than a window

# A block size whose filters need a streaming window past one block's 16,384
# points, and the blocks streamed at it (3 s at 44.1 kHz).
LONG_BLOCK = 16384
LONG_STEPS = 8
# A FIR longer than one window of the segmented conv takes (32,769 taps):
# three partitions; and one too long to stream at B=4096 (four partitions).
LONG_FIR_TAPS = 40000
LONGER_FIR_TAPS = 65000
# Blocks the 65,000-tap FIR streams at B=4096 (past its length), and the
# blocks of 65,536 a lowcut streams (chain8 at 32,768: twice as many).
LONGER_STEPS = 20
WIDE_STEPS = 4


def long_kernel(taps: int, seed: int) -> np.ndarray:
    """A decaying noise tail behind a zero prefix of 37 samples: the shape
    of a reverb line's response."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal(taps) * np.exp(-np.arange(taps) / (taps / 4.0))
    return np.r_[np.zeros(37), k * 0.05]


def step_vs_plain(fir_e, block: torch.Tensor) -> dict:
    """One step of a streaming FIR's kernels (``convpairs.stream_step``: its
    parts' launches, the accumulate mode, the history read as it lies) on a
    seeded random history and ``block`` (a slice of a longer signal, taken
    as it lies), against the same step's plain version: dB of the output,
    which must reach CONV_DB_PLAIN, and the next histories, which must be
    equal."""
    gen = torch.Generator(device="cuda").manual_seed(fir_e.params.history)
    hist = torch.randn((block.shape[0], fir_e.params.history),
                       generator=gen, device="cuda")
    st, y = fir_e.step(fir_e.params, {"hist": hist}, block)
    pst, py = fir_e.step(fir_e.params, {"hist": hist}, block,
                         use_kernels=False)
    r = {"db_step_plain": db_json(snr_db_cuda(py, y)),
         "step_max_abs_err": float((py - y).abs().max()),
         "next_history_equal": bool(torch.equal(st["hist"], pst["hist"]))}
    assert snr_db_cuda(py, y) >= CONV_DB_PLAIN \
        and r["next_history_equal"], r
    return r


def long_windows(signal: torch.Tensor, n: int) -> dict:
    """What the windows past one thread block buy, on the main path's
    signal: (1) a lowcut and (2) chain8 streamed at B=16,384 (windows of
    32,768 and 65,536 over clusters of two and four blocks), one
    ``conv_pairs_step`` launch a step, held to the offline kernel render,
    the plain-version stream and a float64 oracle; (3) a 40,000-tap FIR
    offline at 64 ch x 30 s through its three partitions (one launch each,
    the later ones adding into the output), held to the plain version, the
    oracle and the partitions summed by ``torch.add``, and timed; (4) a
    65,000-tap FIR at B=4096: four partitions offline, and streamed in two
    (its window would be 69,099 samples), held to its offline render; (5) a
    lowcut at B=65,536 streamed in two sub-blocks; (6) chain8 at B=32,768,
    its three filters fused into one FIR that streams in two partitions. In
    (4), (5) and (6) one step of the partitioned FIR is also held to its
    plain version on the same history and block (``step_vs_plain``)."""
    C, B = signal.shape[0], LONG_BLOCK
    T = LONG_STEPS * B
    x = signal[:, :T].contiguous()
    cfg = pt.EngineConfig(SAMPLE_RATE, B)
    r = {}

    # (1) the lowcut
    lowcut = pt.ops.lowcut(cfg, 120.0, device="cuda")
    p = lowcut.params
    outs, counts = stream_run(pt.Chain([lowcut], device="cuda"), cfg, x)
    streamed = torch.cat(outs, dim=-1)
    assert counts["conv_pairs"] == LONG_STEPS and sum(counts.values()) \
        == LONG_STEPS, counts
    offline = lowcut.offline(p, x.reshape(C, LONG_STEPS, B)).reshape(C, T)
    plain = fold_steps(lowcut, x, B, functools.partial(
        fft_filter.fir_step, use_kernels=False))
    oracle = fft_conv64(x[[0, C - 1]].cpu().numpy(), lowcut.lti_kernel)
    H = fft_filter.history_len(p)
    hist = torch.randn((C, H), device="cuda")
    dbs = (snr_db_cuda(offline, streamed), snr_db_cuda(plain, streamed),
           snr_db(oracle, streamed[[0, C - 1]].cpu().numpy()))
    r["lowcut"] = {
        "B": B, "taps": p.kernel_len, "window": p.stream.n,
        "blocks": convpairs.blocks_for(p.stream.n, C), "launches": counts,
        "db_offline": db_json(dbs[0]), "db_plain_stream": db_json(dbs[1]),
        "db_oracle_2ch": db_json(dbs[2]),
        "versions_bit_equal": all(torch.equal(
            convpairs._launch_step(hist, x[:, :B], p.stream, b)[0],
            convpairs.conv_pairs_step(hist, x[:, :B], p.stream, p.lead)[0])
            for b in convpairs.versions(p.stream.n))}
    assert dbs[0] >= STREAM_FIR_DB and dbs[1] >= CONV_DB_PLAIN \
        and dbs[2] >= CONV_DB_ORACLE, r
    assert r["lowcut"]["versions_bit_equal"], r
    del streamed, offline, plain, outs

    # (2) chain8
    _, chain = chain8(B)
    fir_e, dyn_e, _ = chain.exec_effects
    outs, counts = stream_run(chain, cfg, x)
    streamed = torch.cat(outs, dim=-1)
    assert counts["conv_pairs"] == counts["serial_walk"] == LONG_STEPS \
        and sum(counts.values()) == 2 * LONG_STEPS, counts
    offline = pt.render(chain, x, cfg)
    blocks = x.reshape(C, LONG_STEPS, B)
    y_conv = fir_e.offline(fir_e.params, blocks).reshape(C, T)
    fir_stream = fold_steps(fir_e, x, B)
    dyn_off = dyn_e.offline(dyn_e.params, y_conv.reshape(C, LONG_STEPS, B))
    dbs = (snr_db_cuda(offline, streamed), snr_db_cuda(y_conv, fir_stream))
    r["chain8"] = {
        "B": B, "fir_taps": fir_e.params.kernel_len,
        "window": fir_e.params.stream.n,
        "blocks": convpairs.blocks_for(fir_e.params.stream.n, C),
        "launches": counts,
        "db_offline": db_json(dbs[0]), "db_fir_stage": db_json(dbs[1]),
        "dynamics_stage_mismatching_samples": int(
            (fold_steps(dyn_e, y_conv, B) != dyn_off.reshape(C, T)).sum()),
        "peak": float(streamed.abs().max())}
    assert dbs[0] >= CHAIN8_DB_PLAIN and dbs[1] >= STREAM_FIR_DB, r
    assert r["chain8"]["dynamics_stage_mismatching_samples"] == 0, r
    assert 0.0 < r["chain8"]["peak"] <= 1.0, r
    del streamed, outs, offline, y_conv, fir_stream, dyn_off, blocks, x

    # (3) a 40,000-tap FIR through its partitions, at the main path's size
    Tm = -(-n // 4096) * 4096
    xm = torch.nn.functional.pad(signal, (0, Tm - n)).contiguous()
    kernel = long_kernel(LONG_FIR_TAPS, 1)
    fir = fft_filter.fir(kernel, 4096, device="cuda")
    plans = fir.params.plans
    assert len(plans) == 3
    zero_launch_counts()
    got = segconv.partitioned_conv(xm, plans)
    torch.cuda.synchronize()
    assert launch_counts()["segconv"] == len(plans)
    plain = segconv.partitioned_conv(xm, plans, use_kernels=False)
    oracle = fft_conv64(xm[[0, C - 1], :ORACLE_EXCERPT].cpu().numpy(),
                        kernel)
    db_plain, db_oracle = snr_db_cuda(plain, got), snr_db(
        oracle, got[[0, C - 1], :ORACLE_EXCERPT].cpu().numpy())
    max_err = float((got - plain).abs().max())
    del plain

    def summed_by_add():
        y = segconv._launch(xm, plans[0])
        for q in plans[1:]:
            y = y + segconv._launch(xm, q)
        return y

    assert snr_db_cuda(got, summed_by_add()) >= CONV_DB_PLAIN
    r["partitioned_fir"] = {
        "taps": LONG_FIR_TAPS, "C": C, "T": Tm,
        "partitions": [{"shift": q.shift, "taps": q.kernel_len, "n": q.n,
                        "halo": q.halo, "seg": q.seg, "blocks": q.blocks}
                       for q in plans],
        "db_plain": db_json(db_plain), "db_oracle_2ch": db_json(db_oracle),
        "oracle_samples": ORACLE_EXCERPT, "max_abs_err": max_err,
        "ms": time_ms(lambda: segconv.partitioned_conv(xm, plans)),
        **bound(rl.conv_cost_from_params(C, Tm, fir.params))}
    assert db_plain >= CONV_DB_PLAIN and db_oracle >= CONV_DB_ORACLE, r
    del got, xm

    # (4) 65,000 taps at B=4096: offline in four partitions; streamed in two
    longer = fft_filter.fir(long_kernel(LONGER_FIR_TAPS, 2), 4096,
                            device="cuda")
    assert len(longer.params.plans) == 4 and len(longer.params.parts) == 2
    xs = signal[:, :LONGER_STEPS * 4096].contiguous()
    got = longer.offline(longer.params, xs.reshape(C, LONGER_STEPS, 4096))
    want = longer.offline(longer.params, xs.reshape(C, LONGER_STEPS, 4096),
                          use_kernels=False)
    db = snr_db_cuda(want, got)
    cfg4 = pt.EngineConfig(SAMPLE_RATE, 4096)
    outs, counts = stream_run(pt.Chain([longer], device="cuda"), cfg4, xs)
    streamed = torch.cat(outs, dim=-1)
    assert counts["conv_pairs"] == 2 * LONGER_STEPS \
        and sum(counts.values()) == 2 * LONGER_STEPS, counts
    db_stream = snr_db_cuda(got.reshape(C, -1), streamed)
    r["longer_fir"] = {
        "taps": LONGER_FIR_TAPS, "B": 4096,
        "partitions": len(longer.params.plans), "db_plain": db_json(db),
        "stream_parts": [{"n": q.plan.n, "taps": q.plan.kernel_len,
                          "start": q.start, "add": q.add}
                         for q in longer.params.parts],
        "history_samples": longer.params.history,
        "steps": LONGER_STEPS, "launches": counts,
        "launches_a_step": counts["conv_pairs"] // LONGER_STEPS,
        "db_stream_to_offline": db_json(db_stream),
        **step_vs_plain(longer, xs[:, :4096])}
    assert db >= CONV_DB_PLAIN and db_stream >= STREAM_FIR_DB, r
    del got, want, streamed, outs, xs

    # (5) lowcut(120) at B=65,536: two sub-blocks, each a window of 65,536
    Bw = 65536
    cfgw = pt.EngineConfig(SAMPLE_RATE, Bw)
    wide = pt.ops.lowcut(cfgw, 120.0, device="cuda")
    xw = signal[:, :WIDE_STEPS * Bw].contiguous()
    outs, counts = stream_run(pt.Chain([wide], device="cuda"), cfgw, xw)
    n_parts = len(wide.params.parts)
    assert n_parts == 2 and counts["conv_pairs"] == n_parts * WIDE_STEPS \
        and sum(counts.values()) == n_parts * WIDE_STEPS, counts
    off = wide.offline(wide.params, xw.reshape(C, WIDE_STEPS, Bw))
    db = snr_db_cuda(off.reshape(C, -1), torch.cat(outs, dim=-1))
    r["lowcut_65536"] = {"B": Bw, "taps": wide.params.kernel_len,
                         "parts": [(q.plan.n, q.out0, q.keep)
                                   for q in wide.params.parts],
                         "steps": WIDE_STEPS, "launches": counts,
                         "db_offline": db_json(db),
                         **step_vs_plain(wide, xw[:, :Bw])}
    assert db >= STREAM_FIR_DB, r
    del outs, off, xw

    # (6) chain8 at B=32,768: the three filters fuse (two partitions)
    Bc = 32768
    cfgc, chain = chain8(Bc)
    fir_e = chain.exec_effects[0]
    xc = signal[:, :WIDE_STEPS * 2 * Bc].contiguous()
    outs, counts = stream_run(chain, cfgc, xc)
    steps = WIDE_STEPS * 2
    assert counts["conv_pairs"] == len(fir_e.params.parts) * steps \
        and counts["serial_walk"] == steps, counts
    db = snr_db_cuda(pt.render(chain, xc, cfgc), torch.cat(outs, dim=-1))
    r["chain8_32768"] = {"B": Bc, "fused": fir_e.name,
                         "fir_taps": fir_e.params.kernel_len,
                         "stream_parts": len(fir_e.params.parts),
                         "steps": steps, "launches": counts,
                         "db_offline": db_json(db),
                         **step_vs_plain(fir_e, xc[:, :Bc])}
    assert db >= CHAIN8_DB_PLAIN, r
    return {"phase": "long_windows", **r}


# Cycles of the spin that holds the device while launches queue behind it
# (about 20 ms at the H100's clock), and how often a spin that ended too soon
# is tried again, four times as long each time (the host's pace varies: its
# cores are shared).
SPIN_CYCLES = 40_000_000
SPIN_TRIES = 4


def queued_ms(fn, runs: int = 50) -> float:
    """Device time (ms) per call of a kernel that is over in microseconds:
    the launches are queued behind a spin kernel, so they run back to back
    and the host's pace (which is what a plain event pair around them would
    measure) does not show. A try whose spin ended before the last launch
    was queued is thrown away and made again behind a longer spin; after
    ``SPIN_TRIES`` it raises."""
    fn()
    torch.cuda.synchronize()
    spin = SPIN_CYCLES
    for _ in range(SPIN_TRIES):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(runs):
            fn()
        b.record()
        still_spinning = not a.query()
        torch.cuda.synchronize()
        if still_spinning:
            return a.elapsed_time(b) / runs
        spin *= 4
    raise RuntimeError(
        f"the spin ended before the launches were queued, {SPIN_TRIES} "
        "times: the time would be the host's, not the device's")


# Segment lengths (log2) of the serial walk's sweep.
SWEEP_LSEG = (3, 4, 5, 6)


def time_stream_kernels(chain, cfg, streamed_in: torch.Tensor,
                        timing: dict) -> None:
    """The two streaming kernels at the step's shapes, on a block of the
    main path's own data."""
    C, B = streamed_in.shape[0], cfg.block_size
    fir_e, dyn_e, _ = chain.exec_effects
    plan = fir_e.params.stream
    n, lead = plan.n, fir_e.params.lead
    H = fft_filter.history_len(fir_e.params)
    # row 8: the step's window: the first n samples of history + block
    hist = streamed_in[:, :H].contiguous()
    block = streamed_in[:, H:H + B]              # a slice, as a stream passes
    joined = streamed_in[:, :H + B].contiguous()
    rows = joined[:, :n]
    got = convpairs.conv_pairs(rows, plan)
    plain = convpairs.conv_pairs(rows, plan, use_kernels=False)
    out, new_hist = convpairs.conv_pairs_step(hist, block, plan, lead)
    torch.cuda.synchronize()
    assert snr_db_cuda(plain, got) >= CONV_DB_PLAIN
    assert torch.equal(out, got[:, n - B:]), "step differs from conv_pairs"
    assert torch.equal(new_hist, joined[:, B:])
    q = queued_ms(lambda: convpairs.conv_pairs(rows, plan))
    dense = rows.contiguous()
    # both versions of the kernel, in turns, for the rule in
    # kernels/convpairs.blocks_for
    versions = {}
    for blocks in (1, 4, 4, 1):
        name = VERSION_NAMES[blocks]
        v = versions.setdefault(name, {"conv_pairs_ms": [], "step_ms": []})
        v["conv_pairs_ms"].append(queued_ms(lambda: convpairs._launch(
            rows, plan, blocks)))
        v["step_ms"].append(queued_ms(lambda: convpairs._launch_step(
            hist, block, plan, blocks)))
    q_step = queued_ms(lambda: convpairs.conv_pairs_step(hist, block, plan,
                                                         lead))
    plain_ms = queued_ms(lambda: convpairs.conv_pairs_step(
        hist, block, plan, lead, use_kernels=False))
    # the one call that computes the window's convolution; it is given the
    # window already joined and leaves the history to the caller
    library_ms = queued_ms(lambda: torch.fft.irfft(
        torch.fft.rfft(dense, dim=-1) * plan.spectrum_rfft, n=n,
        dim=-1))
    # The headline figures are those of the entry point the main path
    # launches, the step: it reads history and block once and writes the
    # block's output and the next history once. `conv_pairs` on the same
    # window stands beside it.
    timing["conv_pairs"][B] = {
        "R": C, "n": n, "taps": plan.kernel_len, "history": H, "B": B,
        "headline_is": "conv_pairs_step(hist, block, plan, lead)",
        "version": VERSION_NAMES[convpairs.blocks_for(n, C)],
        "db_plain": db_json(snr_db_cuda(plain, got)),
        "max_abs_err": float((out - plain[:, n - B:]).abs().max()),
        "ms": q_step,
        # the same step, GRAPH_STEPS of them captured in one CUDA graph
        "in_graph_ms": graph_ms(lambda: convpairs.conv_pairs_step(
            hist, block, plan, lead)),
        "step_equal_conv_pairs": True,
        "plain_ms": plain_ms, "library_ms": library_ms,
        **roofline_row(rl.conv_pairs_cost(C, n, H, B), ms=q_step,
                       plain_ms=plain_ms, library_ms=library_ms),
        "conv_pairs_ms": q,
        "conv_pairs_plain_ms": queued_ms(lambda: convpairs.conv_pairs(
            rows, plan, use_kernels=False)),
        "conv_pairs_bound_ms": bound(rl.conv_pairs_cost(C, n))["bound_ms"],
        "versions": versions}
    # row 7: the step's block, from REST
    scalars = [kdyn.op_scalars(p) for p in dyn_e.params]
    x = got[:, n - B:].contiguous()
    entry = torch.zeros((len(scalars), C), dtype=torch.int32, device="cuda")
    out, z, rounds = kdyn._launch_serial(scalars, x, entry, want_rounds=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_out, p_z = kdyn.serial_walk(scalars, x, entry, use_kernels=False)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    mismatching = int((out != p_out).sum())
    assert mismatching == 0 and torch.equal(z, p_z)
    q = queued_ms(lambda: kdyn.serial_walk(scalars, x, entry), runs=20)
    # the step itself: the same walk with the 4-field state read and written
    # by the kernel, one launch
    state = dyn_e.state((C,))
    before = kdyn.serial_walk_launch_count
    new_state, s_out = dyn_e.step(dyn_e.params, state, x)
    assert kdyn.serial_walk_launch_count == before + 1
    assert torch.equal(s_out, out)
    for j, p in enumerate(dyn_e.params):
        want = kdyn.decode_state(p, z[j])
        assert all(torch.equal(new_state[j][f], want[f])
                   and new_state[j][f].dtype == want[f].dtype
                   for f in kdyn.FIELDS), j
    q_step = queued_ms(lambda: dyn_e.step(dyn_e.params, state, x), runs=20)
    # the same block through the offline audio walk at one segment
    a_out, a_z = kdyn.audio_walk(scalars, x, 1, B, entry)
    assert torch.equal(a_out, out) and torch.equal(a_z, z)
    # one sample of the dependent chain: two one-round walks of silence that
    # differ only in the segment's length
    silence = torch.zeros_like(x)
    one_round = {k: queued_ms(lambda: kdyn._launch_serial(
        scalars, silence, entry, lseg=k), runs=30) for k in (7, 8)}
    sample_ns = (one_round[8] - one_round[7]) / 128 * 1e6
    lseg, segments, threads = kdyn.serial_geometry(B)
    timing["serial_walk"][B] = {
        "C": C, "T": B, "n_ops": len(scalars),
        "segment": 1 << lseg, "segments": segments, "threads": threads,
        "rounds": int(rounds.max()),
        "mismatching_samples": mismatching, "exit_states_equal": True,
        "max_abs_err": float((out - p_out).abs().max()),
        # the headline is the entry point the main path launches, the step
        # (the 4-field state read and written by the kernel); the walk on
        # encoded states stands beside it
        "headline_is": "cascade_step(scalars, params, states, block)",
        "ms": q_step,
        "in_graph_ms": graph_ms(lambda: dyn_e.step(dyn_e.params, state, x)),
        "serial_walk_ms": q,
        "cascade_step_equal_walk_and_decoded_states": True,
        "dependent_chain_ns_per_sample": sample_ns,
        # rounds x segment x one sample's dependent chain: what this design
        # cannot go below on this data, launch aside
        "critical_path_ms": int(rounds.max()) * (1 << lseg) * sample_ns * 1e-6,
        "plain_ms": plain_ms,
        "plain_ran_with": f"a Python loop over T={B} rows, 1 timed run, "
                          "host clock",
        "library_ms": None,
        **roofline_row(rl.serial_walk_cost(C, B, len(scalars)),
                       ms=q_step, plain_ms=plain_ms)}


def sweep_serial_segments(chain, cfg) -> dict:
    """The serial walk for a range of segment lengths on the stream's signals
    (kernels/dynamics.SERIAL_SEGMENT_LOG2 comes from this table): signal ->
    segment length -> [rounds, ms]. The result does not depend on the
    segment length (checked)."""
    C, B = CHANNELS, cfg.block_size
    scalars = [kdyn.op_scalars(p) for p in chain.exec_effects[1].params]
    table = {}
    for name, x2 in stream_signals(C, B).items():
        entry = torch.zeros((len(scalars), C), dtype=torch.int32,
                            device="cuda")
        if x2.shape[1] == 2 * B:
            _, entry = kdyn.serial_walk(scalars, x2[:, :B].contiguous(), entry)
        x = x2[:, -B:].contiguous()
        want = kdyn.serial_walk(scalars, x, entry)
        row = {}
        for lseg in SWEEP_LSEG:
            out, z, rounds = kdyn._launch_serial(scalars, x, entry, lseg=lseg,
                                                 want_rounds=True)
            assert torch.equal(out, want[0]) and torch.equal(z, want[1]), \
                f"a segment of {1 << lseg} samples changes the result"
            row[str(1 << lseg)] = [int(rounds.max()), queued_ms(
                lambda: kdyn._launch_serial(scalars, x, entry, lseg=lseg),
                runs=30)]
        table[name] = row
    return table


def time_full_batch() -> dict:
    """Row 8 at a batch that fills the card: the offline render's window
    batch at block size 4096, beside the one-call yardstick; both versions of
    the kernel there and at the batches between the step's and that one."""
    n, R = segconv.BLOCK_WINDOW, FULL_BATCH_ROWS
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    x = torch.randn((R, n), generator=gen, device="cuda")
    kernel = np.random.default_rng(5).standard_normal(8185) * 0.02
    plan = convpairs.make_plan(kernel, n, "cuda")
    got = convpairs.conv_pairs(x, plan)
    assert convpairs.blocks_for(n, R) == 1
    lib = lambda: torch.fft.irfft(
        torch.fft.rfft(x, dim=-1) * plan.spectrum_rfft, n=n, dim=-1)
    db = snr_db_cuda(lib()[:64], got[:64])
    assert db >= CONV_DB_PLAIN, db
    assert torch.equal(got[:64], convpairs._launch(x[:64], plan, 4))
    del got
    by_rows = {}
    for rows in (64, 80, 96, 112, 128, 256, 1024, R):
        xr = x[:rows]
        timer = time_ms if rows >= 1024 else queued_ms
        by_rows[str(rows)] = {
            "chosen": VERSION_NAMES[convpairs.blocks_for(n, rows)],
            **{VERSION_NAMES[b]: [timer(lambda: convpairs._launch(xr, plan, b))
                                  for _ in range(2)]
               for b in (1, 4)}}
    cost = rl.conv_pairs_cost(R, n)
    return {"R": R, "n": n, "bytes": cost["bytes"],
            "db_plain_64_rows": db_json(db),
            "ms": time_ms(lambda: convpairs.conv_pairs(x, plan)),
            "library_ms": time_ms(lib),
            "versions_ms_by_rows": by_rows, **bound(cost)}


def time_cluster_by_window() -> dict:
    """Every version of the circular convolution at the step's batch (64
    rows) for every window a cluster takes, up to the 65,536 of a cluster of
    four: n -> version -> ms, and the step entry point in the version the
    rule picks (its history as at a block of n/4)."""
    rng = np.random.default_rng(31)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    table = {}
    n = convpairs.CLUSTER_MIN_WINDOW
    while n <= convpairs.MAX_WINDOW:
        plan = convpairs.make_plan(rng.standard_normal(n // 2) * 0.05, n,
                                   "cuda")
        x = torch.randn((CHANNELS, n), generator=gen, device="cuda")
        hist = torch.randn((CHANNELS, n - n // 4), generator=gen,
                           device="cuda")
        blk = torch.randn((CHANNELS, n // 4), generator=gen, device="cuda")
        table[str(n)] = {
            "chosen": VERSION_NAMES[convpairs.blocks_for(n, CHANNELS)],
            "step_ms": queued_ms(lambda: convpairs.conv_pairs_step(
                hist, blk, plan, 0)),
            **{VERSION_NAMES[b]: [queued_ms(lambda: convpairs._launch(
                x, plan, b)) for _ in range(2)]
               for b in convpairs.versions(n)}}
        n *= 2
    return table


def device_ms_by_name(prof, calls: int, top: int) -> dict:
    """The ``top`` device-side entries of a profile by kernel name, ms a
    call over ``calls`` calls, and the device launches a call. Device-side
    entries only: a PyTorch operator's entry repeats the time of the
    kernels it launched."""
    by_name, launches = {}, 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3 / calls
            launches += ev.count
    return {"device_launches_per_call": launches / calls,
            "device_ms_per_call_by_name": dict(
                sorted(by_name.items(), key=lambda kv: -kv[1])[:top])}


def profile_stream(chain, cfg, signal, steps: int,
                   eager: bool = False) -> dict:
    """Device time of ``steps`` streaming steps under ``torch.profiler``, by
    kernel name. The steps are a StreamProcessor's (graph replays), or with
    ``eager`` the eager ``Chain.step``'s."""
    from torch.profiler import ProfilerActivity, profile

    C, B = signal.shape[0], cfg.block_size
    if eager:
        state = [chain.init_state((C,))]

        def step(block):
            state[0], y = chain.step(state[0], block)
            return y
    else:
        sp = pt.StreamProcessor(chain, cfg, (C,))
        sp.warmup()
        step = sp.process
    for i in range(8):
        step(signal[:, i * B:(i + 1) * B])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(8, 8 + steps):
            step(signal[:, i * B:(i + 1) * B])
        torch.cuda.synchronize()
    r = {"steps": steps, **device_ms_by_name(prof, steps, 6)}
    if not r["device_ms_per_call_by_name"]:
        if eager:
            raise RuntimeError("torch.profiler recorded no device time")
        # the profiler may not see the kernels inside a graph's replay
        r["profiler"] = "recorded no device time in the graph replays"
    return r


def profile_renders(chain, signal, cfg, passes: int = 3) -> dict:
    """Device time of ``passes`` chained captured renders (``render``) under
    ``torch.profiler``, by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    o = pt.render(chain, signal, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(passes):
            o = pt.render(chain, o, cfg)
        torch.cuda.synchronize()
    chain.captured_render().walks()
    r = {"passes": passes, **device_ms_by_name(prof, passes, 8)}
    if not r["device_ms_per_call_by_name"]:
        raise RuntimeError("torch.profiler recorded no device time")
    return r


# ---------------------------------------------------------------------------
# phases 5c-5e: the reverb, the biquad EQ, the drop-in compat API and the CLI

REVERB_MS = 1500.0
# Blocks the reverb streams at B=512 (11.6 s of audio, past its 1.5 s).
REVERB_STREAM_BLOCKS = 1000
# The reverb's bars: its offline is the conv kernel's rounding away from its
# plain version, like row 1's (CONV_DB_PLAIN); the
# oracle holds a 65,000-tap response, whose float32 sum of products sits a
# little further from float64 than a short filter's: 100 dB. The stream runs
# other windows than the offline render: the chain bar, 90 dB.
REVERB_DB_ORACLE = 100.0
STREAM_DB = 90.0
# The EQ of the JAX package's parity tests (tests/test_ops_parity.py).
EQ_ARGS = (200.0, 3.5, 1000.0, -2.5, 8000.0, 4.0)
EQ_STREAM_BLOCKS = 300
# The float64 recurrence and the FIR-ised response (truncated at 1e-9 of its
# peak) against a float64 per-sample recursion: 100 dB, the JAX package's
# bar for its double-float scan.
EQ_DB_ORACLE = 100.0
COMPAT_CHUNK = 512


def counted(fn):
    """(result, launch counts): ``fn`` with every count set to 0 just
    before it and read just after."""
    torch.cuda.synchronize()
    zero_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def render_shape(signal: torch.Tensor, B: int) -> tuple:
    """The blocks shape ``render`` gives a (..., n) signal at block size B."""
    return tuple(signal.shape[:-1]) + (-(-signal.shape[-1] // B), B)


def prepare_render(chain, signal: torch.Tensor, cfg) -> None:
    """Capture the chain's render for the signal's blocks shape (its warm-up
    on a side stream included; nothing if captured before), so that a
    counted ``render`` counts one replay's launches."""
    chain.captured_render().capture(render_shape(signal, cfg.block_size))
    torch.cuda.synchronize()


def eager_render(chain, signal: torch.Tensor, cfg) -> torch.Tensor:
    """What ``render`` ran before it replayed a graph: block, the eager
    ``Chain.render_blocks`` (one read-back a dynamics walk), deblock."""
    blocks = pt.block.make_blocks(signal, cfg.block_size)
    return pt.block.combine_blocks(chain.render_blocks(blocks))


def reverb_phase(signal: torch.Tensor, n: int, smi: str) -> dict:
    """reverb(1500) at 64 ch x 30 s: offline at both block sizes through
    ``render`` (the effect's ``offline_fir``: the combined kernel in 4 / 5
    segconv partitions), held to the plain version and a float64 oracle;
    then streamed at B=512 through StreamProcessor for 1,000 blocks (two
    ``conv_pairs_step`` launches a step: the lines' high-cuts), bit-equal to
    the eager fold and held to the offline render."""
    C = signal.shape[0]
    pick = [0, C - 1]
    runs = {}
    r = {"phase": "reverb", "time_in_ms": REVERB_MS, "channels": C,
         "samples_per_channel": n, "by_block_size": {}, "launch_counts": runs,
         "nvidia_smi": smi}
    for B in BLOCK_SIZES:
        cfg = pt.EngineConfig(SAMPLE_RATE, B)
        eff = pt.ops.reverb(cfg, REVERB_MS, device="cuda")
        assert eff.offline is offline_fir
        chain = pt.Chain([eff], device="cuda")
        T = -(-n // B) * B
        x = torch.nn.functional.pad(signal, (0, T - n)).contiguous()
        blocks = x.reshape(C, T // B, B)
        prepare_render(chain, signal, cfg)
        out, counts = counted(lambda: pt.render(chain, signal, cfg))
        parts = len(eff.params.full.plans)
        assert counts["segconv"] == parts \
            and sum(counts.values()) == parts, counts
        plain = eff.offline(eff.params, blocks, use_kernels=False
                            ).reshape(C, T)
        oracle = fft_conv64(x[pick, :ORACLE_EXCERPT].cpu().numpy(),
                            eff.lti_kernel)
        dbs = {"db_plain": snr_db_cuda(plain, out),
               "db_oracle_2ch": snr_db(
                   oracle, out[pick, :ORACLE_EXCERPT].cpu().numpy())}
        del plain
        rb = {"partitions": parts, "stripped_taps": eff.params.full.kernel_len,
              "launches": counts, **{k: db_json(v) for k, v in dbs.items()}}
        assert dbs["db_plain"] >= CONV_DB_PLAIN, rb
        assert dbs["db_oracle_2ch"] >= REVERB_DB_ORACLE, rb
        r["by_block_size"][str(B)] = rb
        runs[f"offline_{B}"] = counts
        del out, x, blocks

    # streamed at B=512
    B = 512
    cfg = pt.EngineConfig(SAMPLE_RATE, B)
    eff = pt.ops.reverb(cfg, REVERB_MS, device="cuda")
    chain = pt.Chain([eff], device="cuda")
    xs = signal[:, :REVERB_STREAM_BLOCKS * B].contiguous()
    outs, counts = stream_run(chain, cfg, xs)
    assert counts["conv_pairs"] == 2 * REVERB_STREAM_BLOCKS \
        and sum(counts.values()) == 2 * REVERB_STREAM_BLOCKS, counts
    runs["stream_512"] = counts
    streamed = torch.cat(outs, dim=-1)
    e_outs, e_counts = eager_run(chain, cfg, xs)
    eager_equal = torch.equal(torch.cat(e_outs, dim=-1), streamed)
    del e_outs
    assert eager_equal and e_counts == counts, (eager_equal, e_counts)
    db = snr_db_cuda(pt.render(chain, xs, cfg), streamed)
    r["stream"] = {"B": B, "launches": counts,
                   "db_offline": db_json(db),
                   "line_step_window": eff.params.line1.highcut.stream.n,
                   "through": "the captured step (StreamProcessor)",
                   "bit_equal_to_eager_fold": eager_equal}
    assert db >= STREAM_DB, r
    return r


def recursion64(rows, x: np.ndarray) -> np.ndarray:
    """The reference's biquad cascade per sample in float64, each band fed
    the previous band's float64 output, with its one-sample input delay:
    y[n] = b0 x[n-1] + b1 x[n-2] + b2 x[n-3] - a1 y[n-1] - a2 y[n-2]."""
    y = x.astype(np.float64)
    for b0, b1, b2, a1, a2 in rows:
        out = np.zeros_like(y)
        for c in range(y.shape[0]):
            x1 = x2 = x3 = y1 = y2 = 0.0
            for i, v in enumerate(y[c].tolist()):
                o = b0 * x1 + b1 * x2 + b2 * x3 - a1 * y1 - a2 * y2
                x3, x2, x1 = x2, x1, v
                y2, y1 = y1, o
                out[c, i] = o
        y = out
    return y


def eq3band_phase(signal: torch.Tensor, n: int, smi: str) -> dict:
    """eq3band at 64 ch: offline through the FIR-ised route (64 ch x 30 s,
    one segconv launch a partition) and the float64 recurrence, streamed at
    B=512 through the float64 recurrence (no kernel launch: plain PyTorch,
    as the JAX package's scan is plain XLA), both held to a float64
    per-sample recursion with the one-sample delay on 2 channels."""
    C = signal.shape[0]
    pick = [0, C - 1]
    B = 512
    cfg = pt.EngineConfig(SAMPLE_RATE, B)
    eff = pt.ops.eq3band(cfg, *EQ_ARGS, device="cuda")
    assert eff.params.use_fir
    chain = pt.Chain([eff], device="cuda")
    T = -(-n // B) * B
    x = torch.nn.functional.pad(signal, (0, T - n)).contiguous()
    blocks = x.reshape(C, T // B, B)
    prepare_render(chain, signal, cfg)
    out, counts = counted(lambda: pt.render(chain, signal, cfg))
    parts = len(eff.params.fir.plans)
    assert counts["segconv"] == parts and sum(counts.values()) == parts, \
        counts
    m = EQ_STREAM_BLOCKS * B
    oracle = recursion64(eff.params.coeffs.numpy(),
                         x[pick, :m].cpu().numpy())
    rec = eq_recurrence(eff.params, blocks).reshape(C, T)
    xs = x[:, :m].contiguous()
    outs, scounts = stream_run(chain, cfg, xs)
    assert sum(scounts.values()) == 0, scounts
    streamed = torch.cat(outs, dim=-1)
    e_outs, _ = eager_run(chain, cfg, xs)
    eager_equal = torch.equal(torch.cat(e_outs, dim=-1), streamed)
    del e_outs
    dbs = {"fir_db_oracle_2ch": snr_db(oracle, out[pick, :m].cpu().numpy()),
           "recurrence_db_oracle_2ch": snr_db(oracle,
                                              rec[pick, :m].cpu().numpy()),
           "stream_db_oracle_2ch": snr_db(oracle,
                                          streamed[pick].cpu().numpy()),
           "fir_db_plain": snr_db_cuda(eff.offline(
               eff.params, blocks, use_kernels=False).reshape(C, T), out),
           "stream_db_recurrence": snr_db_cuda(rec[:, :m], streamed)}
    r = {"phase": "eq3band", "args": EQ_ARGS, "channels": C, "B": B,
         "samples_per_channel": n, "fir_taps": eff.params.fir.kernel_len,
         "fir_lead": eff.params.fir.lead, "partitions": parts,
         "launch_counts": {"offline_fir_512": counts,
                           "stream_512": scounts},
         **{k: db_json(v) for k, v in dbs.items()},
         "oracle_samples": m,
         "stream": {"through": "the captured step (StreamProcessor)",
                    "bit_equal_to_eager_fold": eager_equal},
         "nvidia_smi": smi}
    assert eager_equal, r
    assert all(v >= EQ_DB_ORACLE for k, v in dbs.items() if "oracle" in k), r
    assert dbs["fir_db_plain"] >= CONV_DB_PLAIN, r
    assert dbs["stream_db_recurrence"] >= EQ_DB_ORACLE, r
    return r


def eager_chunk_loop(effects, chunks) -> list:
    """The compat chunk loop with each effect's eager step, numpy in and
    out of every device as ``apply`` did before the steps were captured:
    the outputs."""
    states = [e.state() for e in effects]
    outs = []
    for c in chunks:
        y = c
        for j, e in enumerate(effects):
            blk = torch.from_numpy(np.ascontiguousarray(
                y, dtype=np.float32)).cuda()
            with torch.inference_mode():
                states[j], out = e.step(e.params, states[j], blk)
            y = out.cpu().numpy()
        outs.append(y)
    return outs


def compat_phase(signal: torch.Tensor, n: int, workdir: str,
                 smi: str) -> dict:
    """The reference's own usage through the drop-in API on one mono
    channel of 30 s: ``config.initialize(44100, 512)``, a chain of devices
    applied chunk by chunk with numpy in and out, bit-equal to the same
    loop of eager steps and held to the same effects' ``Chain`` render on
    the card; then the CLI once on a 2-channel wav."""
    compat.config.initialize(SAMPLE_RATE, COMPAT_CHUNK)
    low = compat.CreateLowCutFilter(800)
    eq = compat.CreateEQ3Band(*EQ_ARGS)
    comp = compat.CreateCompressor(-18, 0.6, 3.1, 30.1)
    gate = compat.CreateGate(-45, 0.1, 3.1, 200.1)
    delay = compat.CreateDelay(150, 2)
    trem = compat.CreateTremolo(0.3, 5.0)
    clip = compat.CreateSoftClipper(0.44)
    rev = compat.CreateReverb(REVERB_MS)
    assert low._effect.device.type == "cuda"
    in_order = [low, eq._low, eq._mid, eq._high, comp, gate, delay, trem,
                clip, rev]
    x = signal[0, :n].cpu().numpy()
    chunks = compat.MakeChunks(x)
    # each device's first chunk of a length captures its step (the JAX
    # devices compile at their first apply): one silent chunk, then reset
    for d in in_order:
        d.apply(np.zeros(COMPAT_CHUNK, np.float32))
        d.reset()
    outs = []
    torch.cuda.synchronize()
    zero_launch_counts()
    for c in chunks:
        y = low.apply(c)
        y = eq.applyhighband(eq.applymidband(eq.applylowband(y)))
        y = clip.apply(trem.apply(delay.apply(gate.apply(comp.apply(y)))))
        y = rev.applyreverb(y)
        outs.append(y)
    counts = launch_counts()
    k = len(chunks)
    # the lowcut's and the reverb lines' steps, the compressor's and the
    # gate's: nothing else launches (the EQ, the delay, the tremolo and the
    # soft clipper step in plain PyTorch)
    assert counts["conv_pairs"] == 3 * k and counts["serial_walk"] == 2 * k \
        and sum(counts.values()) == 5 * k, counts
    got = compat.CombineChunks(outs)
    assert got.shape == (k * COMPAT_CHUNK,) and np.isfinite(got).all()
    # the same chunk loop with each effect stepped eagerly, as ``apply`` did
    # before the steps were captured
    e_outs = eager_chunk_loop([d._effect for d in in_order], chunks)
    eager_equal = np.array_equal(compat.CombineChunks(e_outs), got)
    assert eager_equal, int((compat.CombineChunks(e_outs) != got).sum())
    effects = [low._effect, eq._low._effect, eq._mid._effect,
               eq._high._effect, comp._effect, gate._effect, delay._effect,
               trem._effect, clip._effect, rev._effect]
    cfg = pt.EngineConfig(SAMPLE_RATE, COMPAT_CHUNK)
    chain = pt.Chain(effects, device="cuda")
    want = pt.render(chain, torch.from_numpy(x)[None].cuda(), cfg)[0]
    db = snr_db(want.cpu().numpy()[:len(got)], got)
    r = {"phase": "compat", "chunks": k, "chunk": COMPAT_CHUNK,
         "devices": [type(d).__name__ for d in
                     (low, eq, comp, gate, delay, trem, clip, rev)],
         "launch_counts": {"chunk_loop": counts},
         "offline_chain": [e.name for e in chain.exec_effects],
         "db_offline_chain": db_json(db),
         "through": "each device's captured step",
         "bit_equal_to_eager_loop": eager_equal,
         "nvidia_smi": smi}
    assert db >= STREAM_DB, r
    # the CLI, once, on a 2-channel wav written here
    src = os.path.join(workdir, "cli_in.wav")
    dst = os.path.join(workdir, "cli_out.wav")
    pt.wavio.write_wav(src, signal[:2, :5 * SAMPLE_RATE].cpu().numpy(),
                       SAMPLE_RATE)
    spec = [{"op": "lowcut", "cutoff_hz": 120.0},
            {"op": "eq3band", "low_shelf_hz": 200.0, "low_shelf_db": 3.5,
             "mid_hz": 1000.0, "mid_db": -2.5, "high_shelf_hz": 8000.0,
             "high_shelf_db": 4.0},
            {"op": "compressor", "threshold_db": -18.0},
            {"op": "reverb", "time_in_ms": 300.0}, {"op": "softclipper"}]
    rc = cli_main([src, dst, "--chain", json.dumps(spec), "--block-size",
                   "4096", "--trim"])
    assert rc == 0, rc
    audio, rate = pt.wavio.read_wav(dst)
    assert rate == SAMPLE_RATE and audio.shape == (2, 5 * SAMPLE_RATE)
    assert np.isfinite(audio).all() and np.abs(audio).max() > 0.01
    r["cli"] = {"shape": list(audio.shape), "chain": [e["op"] for e in spec]}
    return r


# ---------------------------------------------------------------------------
# runtime: the realtime engine's pump, unpaced and paced at the audio clock

RUNTIME_B = 512
PACED_SECONDS = 5.0


def runtime_fold(chain, cfg, x: np.ndarray) -> np.ndarray:
    """StreamProcessor folded over x (mono, whole blocks) on a fresh state,
    numpy in and out as the engine's pump steps it (the captured step)."""
    sp = pt.StreamProcessor(chain, cfg)
    B = cfg.block_size
    return np.concatenate([sp.process(x[i:i + B])
                           for i in range(0, x.size, B)])


def runtime_unpaced(chain, cfg, x: np.ndarray) -> dict:
    """A producer thread pushes x through a RealtimeEngine as fast as the
    ring takes it, while this thread pulls; counts zeroed after the engine's
    warm-up, read when every block is out."""
    eng = RealtimeEngine(chain, cfg)
    eng.start()
    B = cfg.block_size
    done = threading.Event()

    def produce():
        i = 0
        while i < x.size:
            took = eng.push(x[i:i + B])
            i += took
            if not took:
                time.sleep(0.0002)
        done.set()

    torch.cuda.synchronize()
    zero_launch_counts()
    producer = threading.Thread(target=produce, daemon=True)
    producer.start()
    outs, got = [], 0
    deadline = time.monotonic() + 120.0
    while got < x.size and time.monotonic() < deadline:
        o = eng.pull(x.size - got)
        if o.size:
            outs.append(o)
            got += o.size
        else:
            time.sleep(0.0002)
    producer.join(timeout=10.0)
    eng.stop()
    counts = launch_counts()
    assert done.is_set() and got == x.size, (got, x.size)
    return {"out": np.concatenate(outs), "counts": counts}


class _PacedStream:
    """A fake ``sounddevice.Stream`` whose clock thread calls the duplex
    callback every block duration (11.61 ms at 512 / 44.1 kHz), on absolute
    deadlines, with the next input block; it waits for ``go`` before the
    first call. It records each callback's output and how many of its
    samples the adapter padded with silence."""

    adapter = None
    signal = None
    go = None

    def __init__(self, samplerate, blocksize, channels, dtype, device,
                 callback):
        assert channels == 1 and dtype == "float32"
        self.period = blocksize / samplerate
        self.blocksize = blocksize
        self.callback = callback
        self.captured, self.padded = [], []
        self._stop = threading.Event()

    def _run(self):
        self.go.wait()
        B, x = self.blocksize, self.signal
        t_next = time.perf_counter()
        for i in range(x.size // B):
            if self._stop.is_set():
                break
            delay = t_next - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            before = self.adapter.underrun_samples
            out = np.zeros((B, 1), np.float32)
            self.callback(x[i * B:(i + 1) * B, None], out, B, None, None)
            self.captured.append(out[:, 0].copy())
            self.padded.append(self.adapter.underrun_samples - before)
            t_next += self.period

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10.0)
        assert not self._thread.is_alive()

    def close(self):
        pass


def runtime_paced(chain, cfg, x: np.ndarray) -> dict:
    """x through DuplexAudioStream with a fake sounddevice clocked at the
    audio rate; counts zeroed after the warm-up, before the first callback,
    read after the engine drained."""
    eng = RealtimeEngine(chain, cfg)
    fake = types.ModuleType("sounddevice")
    fake.Stream = _PacedStream
    saved = sys.modules.get("sounddevice")
    sys.modules["sounddevice"] = fake
    try:
        stream = DuplexAudioStream(eng, backend="sounddevice")
        _PacedStream.adapter, _PacedStream.signal = stream, x
        _PacedStream.go = threading.Event()
        stream.start()                    # the engine's warm-up, then the clock
        clock = stream._stream
        torch.cuda.synchronize()
        zero_launch_counts()
        _PacedStream.go.set()
        clock._thread.join(timeout=x.size / cfg.sample_rate + 60.0)
        eng.drain()
        counts = launch_counts()
        stream.stop()
    finally:
        if saved is None:
            sys.modules.pop("sounddevice", None)
        else:
            sys.modules["sounddevice"] = saved
    B = cfg.block_size
    # the padding is appended to a callback's block, so the samples that
    # came from the ring are, in order, the engine's output stream
    real = np.concatenate([c[:B - p] for c, p in
                           zip(clock.captured, clock.padded)])
    return {"real": real, "padded": clock.padded,
            "counts": counts,
            "underrun_samples": stream.underrun_samples,
            "overrun_samples": stream.overrun_samples}


def runtime_phase(signal: torch.Tensor, n: int, smi: str) -> dict:
    """chain8, mono, B=512 (the reference's realtime chunk, Example3) through
    the RealtimeEngine: (a) unpaced over the main path's 30 s (2,584 blocks),
    bit-equal to the StreamProcessor fold, one conv_pairs and one
    serial_walk launch a block; (b) paced at the audio clock through
    DuplexAudioStream over 5 s (431 blocks), bit-equal to the fold after
    the ring's whole-block lag. The xruns are reported, not asserted: the
    host's cores are shared. Then the step's two kernels at the pump's
    shape."""
    B = RUNTIME_B
    cfg, chain = chain8(B)
    nb = -(-n // B)
    x = np.zeros(nb * B, np.float32)
    x[:n] = signal[0, :n].cpu().numpy()
    runtime_native.load()                 # built before any pump runs
    a = runtime_unpaced(chain, cfg, x)
    want = runtime_fold(chain, cfg, x)
    # the eager step, numpy in and out a block, as the pump ran it before
    # the step was captured: the same bits
    e_outs, _ = eager_run(
        chain, cfg, torch.from_numpy(x)[None].cuda(), as_numpy=True)
    eager_equal = np.array_equal(np.concatenate([o[0] for o in e_outs]),
                                 want)
    del e_outs
    assert eager_equal
    expect = {name: (nb if name in STREAM_KERNELS else 0) for name in KERNELS}
    assert a["counts"] == expect, a["counts"]
    assert np.array_equal(a["out"], want), \
        int((a["out"] != want).sum())
    unpaced = {"blocks": nb, "launches": a["counts"],
               "bit_equal_to_fold": True,
               "through": "the captured step (StreamProcessor in the pump)",
               "fold_bit_equal_to_eager_fold": eager_equal}

    nb5 = int(round(PACED_SECONDS * SAMPLE_RATE / B))
    x5 = x[:nb5 * B]
    b = runtime_paced(chain, cfg, x5)
    want5 = want[:b["real"].size]
    assert b["real"].size >= B, b["real"].size   # something flowed
    assert np.array_equal(b["real"], want5), int((b["real"] != want5).sum())
    first = next(i for i, p in enumerate(b["padded"]) if p < B)
    lag = sum(b["padded"][:first])
    assert lag % B == 0 and b["padded"][first] == 0, b["padded"][:first + 1]
    expect5 = {name: (nb5 if name in STREAM_KERNELS else 0)
               for name in KERNELS}
    assert b["counts"] == expect5, b["counts"]
    # the step's two kernels at the pump's shape, (1, 512): device time a
    # launch, queued behind a spin (measurement only: the counts are read)
    fir_e, dyn_e, _ = chain.exec_effects
    blk = torch.from_numpy(x[:B]).cuda()
    scalars = [kdyn.op_scalars(p) for p in dyn_e.params]
    kernel_ms = {
        "conv_pairs_step": queued_ms(lambda: fft_filter.fir_step(
            fir_e.params, fir_e.state(()), blk)),
        "serial_walk_step": queued_ms(lambda: kdyn.cascade_step(
            scalars, dyn_e.params, dyn_e.state(()), blk))}
    paced = {"blocks": nb5, "launches": b["counts"],
             "bit_equal_to_fold_after_lag": True,
             "lag_blocks": lag // B,
             "underrun_samples": b["underrun_samples"],
             "underrun_samples_after_lag": b["underrun_samples"] - lag,
             "overrun_samples": b["overrun_samples"]}
    return {"phase": "runtime", "chain": "chain8", "channels": 1, "B": B,
            "unpaced": unpaced, "paced": paced, "kernel_ms_1x512": kernel_ms,
            "launch_counts": {"unpaced": a["counts"], "paced": b["counts"]},
            "nvidia_smi": smi}


# ---------------------------------------------------------------------------
# parallel: the sharded render over ranks sharing the one card

PARALLEL_B = 4096
# The four-rank mesh (2, 2) renders this many seconds (the main path's 30 s
# unless the phase ran past a minute at that length).
PARALLEL4_SECONDS = 30.0
RANK_TIMEOUT_S = 300.0
# the undecayed EQ of the port's tests (a low shelf at 0.3 Hz, -3 dB: the
# float64 recurrence, which a time-sharded mesh runs through timescan)
EQ_CHAIN = "lowcut(150) -> eq_band(low, 0.3 Hz, -3 dB) -> softclipper(0.44)"


def eq_chain_effects(cfg, device):
    o = pt.ops
    return [o.lowcut(cfg, 150.0, device=device),
            o.eq_band(cfg, "low", 0.3, -3.0, device=device),
            o.softclipper(cfg, 0.44, device=device)]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


PARALLEL_CFG = pt.EngineConfig(SAMPLE_RATE, PARALLEL_B)


def parallel_chains():
    cfg = PARALLEL_CFG
    return cfg, {"chain8": chain8(PARALLEL_B)[1],
                 "eq_chain": pt.Chain(eq_chain_effects(cfg, "cuda"),
                                      device="cuda")}


def captured_vs_eager(rend, signal: torch.Tensor, n: int, steps=None
                      ) -> tuple[dict, torch.Tensor]:
    """The captured sharded render against the eager one on ``signal``
    (collective: every rank of the mesh calls it): ``rend.render`` (a
    replay of the captured program) against ``render_shard`` + ``gather``.
    Bit-equality, a repeated replay's, each kernel's launches in one replay
    and in one eager render (counted from 0, the conditional nodes' added by
    reading the device's rounds and walks), dynspec's rounds and the
    fixpoints' walks both ways. Returns (that, the captured output). With
    ``steps`` (a rank program on the shard) it holds that program captured
    against ``render_shard`` alone instead."""
    cfg, mesh = rend.cfg, rend.mesh
    B, t = cfg.block_size, mesh.shape["time"]
    blocks = pt.block.make_blocks(torch.nn.functional.pad(
        signal, (0, (-n) % (t * B))), B)
    local = rend.shard(blocks)
    kind = "global" if steps is None else "shard"
    steps = rend.steps if steps is None else steps

    def eager():
        y = rend.render_shard(local)
        return y if kind == "shard" else rend.gather(y)

    def graph():
        if kind == "global":
            return pt.block.make_blocks(rend.render(signal), B)
        rend.captured.prepare(kind, tuple(local.shape), steps).copy_(local)
        return rend.captured.replay()

    torch.cuda.synchronize()
    zero_launch_counts()
    with graph_cond.fixpoints() as fx, pdynspec.recorded_rounds() as rr:
        want = eager()
    walks_eager = [int(f[kdyn.FLAG_WALKS]) for f in fx]
    rounds_eager = pdynspec.read_rounds(rr)
    torch.cuda.synchronize()
    launches_eager = launch_counts()

    rend.captured.release()
    rend.captured.prepare(kind, tuple(local.shape), steps)
    torch.cuda.synchronize()
    zero_launch_counts()
    got = graph()
    rounds_graph = rend.captured.rounds()
    walks_graph = rend.captured.walks()
    torch.cuda.synchronize()
    launches_graph = launch_counts()
    got = got.clone()
    again = graph()
    r = {"bit_equal": bool(torch.equal(got, want)),
         "repeat_bit_equal": bool(torch.equal(again, got)),
         "pieces": len(rend.captured.cuts()) + 1,
         "cuts": rend.captured.cuts(),
         "planned_cuts": None if kind == "shard" else psharding.plan_cuts(
             rend.chain, mesh.shape, B, mesh.capturable),
         "launches_graph": launches_graph,
         "launches_eager": launches_eager,
         "rounds_graph": rounds_graph, "rounds_eager": rounds_eager,
         "walks_graph": walks_graph, "walks_eager": walks_eager}
    del again, want
    return r, got


def check_captured(key: str, name: str, r: dict) -> None:
    """What the captured sharded render must show against the eager one:
    the same bits, launches kernel by kernel, rounds and walks."""
    assert r["bit_equal"] and r["repeat_bit_equal"], (key, name, r)
    assert r["launches_graph"] == r["launches_eager"], (key, name, r)
    assert r["rounds_graph"] == r["rounds_eager"], (key, name, r)
    assert r["walks_graph"] == r["walks_eager"], (key, name, r)
    assert r["planned_cuts"] in (None, r["cuts"]), (key, name, r)


def round_cases() -> dict:
    """The round kernel of dynspec's rounds on the device against its plain
    version: the step on entries (n_ops, C) at 1, 2 and 4 ops and 1, 3 and
    64 channels, moved and not, on the first time rank and after it, from
    flags of a live round and of one past the fixpoint (the entries and the
    flags exactly); and the gate, in a captured graph, setting the if node
    that holds a round's walk: the body runs where the round is live."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    steps = 0
    for n_ops in (1, 2, 4):
        for C in (1, 3, 64):
            came = torch.randint(-1, 400, (n_ops, C), generator=gen,
                                 device="cuda", dtype=torch.int32)
            fresh = torch.randint(-1, 400, (n_ops, C), generator=gen,
                                  device="cuda", dtype=torch.int32)
            for entry0 in (fresh, came.clone()):
                for first in (False, True):
                    for f0 in ((0, 0, 7), (1, 2, 7), (0, 2, 7)):
                        flags0 = torch.tensor(f0, dtype=torch.int32,
                                              device="cuda")
                        e1, f1 = entry0.clone(), flags0.clone()
                        kdyn.round_step(came, e1, f1, first)
                        e2, f2 = entry0.clone(), flags0.clone()
                        kdyn.round_step_plain(came, e2, f2, first)
                        torch.cuda.synchronize()
                        assert torch.equal(e1, e2) and torch.equal(f1, f2), \
                            (n_ops, C, first, f0, f1, f2)
                        steps += 1
    gates = {}
    graph_cond.body_stream(torch.device("cuda"))
    for f0 in ((0, 0, 0), (1, 2, 0), (0, 2, 0)):
        flags = torch.tensor(f0, dtype=torch.int32, device="cuda")
        ran = torch.zeros(1, dtype=torch.int32, device="cuda")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            handle = graph_cond.if_handle("cuda")
            kdyn.round_gate(flags, handle)
            with graph_cond.if_node("cuda", handle):
                ran.add_(1)
        for _ in range(2):
            graph.replay()
        torch.cuda.synchronize()
        gates[str(f0[:2])] = int(ran)
        assert int(ran) == 2 * kdyn.round_live(flags), (f0, int(ran))
        graph.reset()
    return {"round_step_cases_equal_to_plain": steps,
            "gate_if_node_runs_of_two_replays": gates}


def device_rounds_played(mesh, chain, signal: torch.Tensor, n: int) -> dict:
    """dynspec's rounds on the device (the route a capturable mesh
    captures), played eagerly over this mesh's exchanges, against the
    rounds that read their flag back each round: bit-equal, the same
    rounds (collective)."""
    B = PARALLEL_B
    rend = ShardedRenderer(chain, PARALLEL_CFG, mesh)
    local = rend.shard(pt.block.make_blocks(torch.nn.functional.pad(
        signal, (0, (-n) % (mesh.shape["time"] * B))), B))
    dyn = chain.exec_effects[1]
    out = {}
    for capturable in (False, True):
        with pdynspec.recorded_rounds() as rr:
            y = play(pdynspec.time_sharded_steps(dyn.params, local, mesh,
                                                 capturable))
        out[capturable] = (y, pdynspec.read_rounds(rr))
    return {"bit_equal": bool(torch.equal(out[False][0], out[True][0])),
            "rounds_host": out[False][1], "rounds_device": out[True][1]}


def capture_checks(body, state: list, rounds: int = 3) -> dict:
    """``body()`` (exchanges and kernels on the tensors of ``state``, in
    place, allocating nothing) run eagerly ``rounds`` times; then from the
    same start, ``rounds`` bodies captured in one CUDA graph (what a
    capturable rank program does), and one body inside a conditional while
    node run ``rounds`` times (the settle step counting and setting the
    condition on the card: the route the rank program could not take). Each
    result against the eager one: bit-equal, or the error that stopped
    it."""
    dev = state[0].device
    start = [s.clone() for s in state]

    def reset():
        for s, s0 in zip(state, start):
            s.copy_(s0)
        torch.cuda.synchronize()

    for _ in range(rounds):
        body()
    torch.cuda.synchronize()
    want = [s.clone() for s in state]
    res = {}
    flags = torch.zeros(4, dtype=torch.int32, device=dev)
    z = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    entry = torch.zeros_like(z)
    graph_cond.body_stream(dev)
    for kind in ("graph", "while_node"):
        reset()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                if kind == "graph":
                    for _ in range(rounds):
                        body()
                else:
                    flags.zero_()
                    with graph_cond.while_node(dev) as handle:
                        body()
                        z.add_(1)       # the entries move every time
                        kdyn.settle(z, entry, flags, 1, kdyn.IN_WHILE_NODE,
                                    rounds, handle)
            reset()
            graph.replay()
            torch.cuda.synchronize()
            ok = all(torch.equal(s, w) for s, w in zip(state, want))
            if kind == "while_node":
                ok = ok and int(flags[kdyn.FLAG_WALKS]) == rounds
            res[kind] = {"bit_equal": bool(ok)}
        except Exception as exc:          # reported, then asserted
            res[kind] = {"error": f"{type(exc).__name__}: {exc}"}
        finally:
            graph.reset()
    return res


def nccl_world_capture(rounds: int = 3) -> dict:
    """One NCCL all_gather and all_reduce of the job's group (one rank on
    this card) captured: :func:`capture_checks`."""
    x = torch.arange(4096, dtype=torch.float32, device="cuda")
    acc = x.clone()
    gathered = torch.empty((torch.distributed.get_world_size(), 4096),
                           dtype=torch.float32, device="cuda")

    def body():
        torch.distributed.all_gather_into_tensor(gathered, acc)
        acc.add_(gathered[0])
        torch.distributed.all_reduce(acc)

    return capture_checks(body, [acc, gathered], rounds)


def parallel_rank(rank: int, world: int, port: int, shapes, seconds: float,
                  seed: int, out_dir: str) -> None:
    """One rank of the gloo job on the one card: every mesh shape of
    ``shapes``, both chains, the captured sharded render against the eager
    one (:func:`captured_vs_eager`), and held (rank 0) to the single-card
    render; ``render_local_channels`` and ``sharded_meters`` of chain8."""
    pdist.init_distributed(f"localhost:{port}", num_processes=world,
                           process_id=rank, backend="gloo")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    n = int(seconds * SAMPLE_RATE)
    signal = bench_signals.burst_noise(CHANNELS, n, SAMPLE_RATE, seed,
                                       "cuda")
    cfg, chains = parallel_chains()
    single = {}
    if rank == 0:
        for name, chain in chains.items():
            single[name] = pt.render(chain, signal, cfg)
            chain.captured_render().release()
    res = {"rank": rank, "meshes": {}}
    for c, t in shapes:
        mesh = make_mesh(c, t, device="cuda")
        torch.distributed.barrier()
        r = {"capturable": mesh.capturable}
        for name, chain in chains.items():
            rend = ShardedRenderer(chain, cfg, mesh)
            r[name], got = captured_vs_eager(rend, signal, n)
            rend.captured.release()
            if rank == 0:
                want = single[name]
                got = got.reshape(CHANNELS, -1)[:, :want.shape[-1]]
                r[name].update({"db_single_card": db_json(
                    snr_db_cuda(want, got)), "single_bit_equal": bool(
                        torch.equal(want, got))})
            del got
        if t > 1:
            r["device_rounds_played"] = device_rounds_played(
                mesh, chains["chain8"], signal, n)
        r8 = ShardedRenderer(chains["chain8"], cfg, mesh)
        mine = signal[pdist.host_channel_slice(CHANNELS)]
        torch.cuda.synchronize()
        zero_launch_counts()
        local = pdist.render_local_channels(r8, mine)
        r8.captured.rounds()
        r8.captured.walks()
        torch.cuda.synchronize()
        r["local_launches"] = launch_counts()
        r8.captured.release()
        shard = r8.render_shard(r8.shard(pt.block.make_blocks(
            torch.nn.functional.pad(signal, (0, (-n) % (t * cfg.block_size))),
            cfg.block_size)))
        meters = pdist.sharded_meters(shard, mesh)
        whole = r8.gather(shard).reshape(CHANNELS, -1)
        r["local_equal_to_global"] = bool(torch.equal(
            local, whole[pdist.host_channel_slice(CHANNELS), :n]))
        w64 = whole.double()
        r["meters"] = meters
        r["meters_ok"] = bool(
            meters["peak"] == float(whole.abs().max())
            and abs(meters["rms"] - float(w64.square().mean().sqrt()))
            <= 1e-9 * meters["rms"])
        res["meshes"][f"{c}x{t}"] = r
        del whole, w64, local, shard
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


CHAINS = ("chain8", "eq_chain")
DYNSPEC_ROUTE = ("under NCCL, n_time rounds unrolled in the rank's graph, "
                 "each walk in an if node (CUDA refused NCCL's work in a "
                 "conditional while node); "
                 "under gloo, between graphs, a host read a round")


def run_ranks(world: int, shapes, seconds: float, seed: int) -> dict:
    """Spawn ``world`` ranks (start method spawn; they load the kernels the
    parent built and build nothing), wait with a deadline, and return each
    mesh's results: rank 0's checks, every rank's captured-against-eager
    checks, launches summed over ranks."""
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(
            parallel_rank, args=(world, free_port(), shapes, seconds, seed,
                                 out_dir),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            while not ctx.join(timeout=5.0):
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"the {world} ranks did not finish in "
                        f"{RANK_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=10.0)
        ranks = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    return {key: merge_ranks([rk["meshes"][key] for rk in ranks])
            for key in ranks[0]["meshes"]}


def merge_ranks(per_rank: list) -> dict:
    """One mesh's results over its ranks: rank 0's single-card checks, each
    chain's captured-against-eager checks on every rank (launches summed),
    rounds and walks by rank."""
    r0 = per_rank[0]
    out = {"capturable": r0["capturable"],
           "local_equal_to_global": all(r["local_equal_to_global"]
                                        for r in per_rank),
           "meters_ok": all(r["meters_ok"] for r in per_rank),
           "meters": r0["meters"],
           "device_rounds_played": [r.get("device_rounds_played")
                                    for r in per_rank],
           "local_launches_all_ranks": {
               k: sum(r["local_launches"][k] for r in per_rank)
               for k in KERNELS}}
    for name in CHAINS:
        rs = [r[name] for r in per_rank]
        out[name] = {
            **{k: r0[name][k] for k in ("db_single_card", "single_bit_equal",
                                        "pieces", "cuts", "planned_cuts")
               if k in r0[name]},
            "bit_equal": all(r["bit_equal"] for r in rs),
            "repeat_bit_equal": all(r["repeat_bit_equal"] for r in rs),
            "launches_graph": {k: sum(r["launches_graph"][k] for r in rs)
                               for k in KERNELS},
            "launches_eager": {k: sum(r["launches_eager"][k] for r in rs)
                               for k in KERNELS},
            "rounds_graph": [r["rounds_graph"] for r in rs],
            "rounds_eager": [r["rounds_eager"] for r in rs],
            "walks_graph": [r["walks_graph"] for r in rs],
            "walks_eager": [r["walks_eager"] for r in rs]}
    return out


def check_mesh(key: str, r: dict) -> None:
    c, t = map(int, key.split("x"))
    for name, bar in (("chain8", CHAIN8_DB_PLAIN), ("eq_chain", CHAIN_DB_PLAIN)):
        db = r[name]["db_single_card"]           # None: bit-equal
        assert r[name]["single_bit_equal"] or db >= bar, (key, name, r)
        check_captured(key, name, r[name])
        assert r[name]["pieces"] == (1 if r["capturable"]
                                     else len(r[name]["cuts"]) + 1)
    assert r["local_equal_to_global"] and r["meters_ok"], (key, r)
    for played in r["device_rounds_played"]:
        assert played is None or (
            played["bit_equal"]
            and played["rounds_host"] == played["rounds_device"]), (key, r)
    walks = ("serial_walk",) if t > 1 else ("state_walk", "audio_walk")
    launches = {k: r["chain8"]["launches_graph"][k]
                + r["eq_chain"]["launches_graph"][k] for k in KERNELS}
    for name in KERNELS:
        on_path = name in ("segconv", "tail") + walks
        assert (launches[name] > 0) == on_path, (key, name, launches)
        assert (r["local_launches_all_ranks"][name] > 0) \
            == (name in ("segconv", "tail") + walks), (key, name, r)


def parallel_phase(signal: torch.Tensor, n: int, smi: str, seed: int
                   ) -> dict:
    """The sharded render at 64 ch x 30 s, B=4096, chain8 and a chain with an
    undecayed EQ (so that timescan runs), captured (``render`` replays the
    rank's program) and held bit-equal to the eager ``render_shard`` +
    ``gather`` (:func:`captured_vs_eager`): (i) one rank on NCCL, a 1x1 mesh,
    also bit-equal to Chain.render, and one NCCL all_gather and all_reduce
    captured in a graph and in a while node (:func:`nccl_world_capture`);
    (ii) two ranks on the one card over gloo, meshes (1, 2) and (2, 1);
    (iii) four ranks, mesh (2, 2). Then the kernels at a (1, 2) time
    shard's shapes."""
    cfg, chains = parallel_chains()
    rounds = round_cases()
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
        rank=0)
    try:
        mesh = make_mesh(1, 1, device="cuda")
        one = {}
        for name, chain in chains.items():
            rend = ShardedRenderer(chain, cfg, mesh)
            r, got = captured_vs_eager(rend, signal, n)
            rend.captured.release()
            want = pt.render(chain, signal, cfg)
            chain.captured_render().release()
            r["chain_render_bit_equal"] = bool(torch.equal(
                got.reshape(CHANNELS, -1)[:, :want.shape[-1]], want))
            check_captured("1x1", name, r)
            assert r["chain_render_bit_equal"] and r["pieces"] == 1, (name, r)
            one[name] = r
            del got, want
        nccl_capture = nccl_world_capture()
        assert nccl_capture["graph"].get("bit_equal"), nccl_capture
    finally:
        torch.distributed.destroy_process_group()
    launches1 = {k: one["chain8"]["launches_graph"][k]
                 + one["eq_chain"]["launches_graph"][k] for k in KERNELS}
    for name in ("segconv", "tail", "state_walk", "audio_walk"):
        assert launches1[name] > 0, launches1
    r1 = {"backend": "nccl", "ranks": 1, **one, "launches": launches1,
          "nccl_capture": nccl_capture}
    torch.cuda.empty_cache()

    two = run_ranks(2, [(1, 2), (2, 1)], SECONDS, seed)
    four = run_ranks(4, [(2, 2)], PARALLEL4_SECONDS, seed)
    for key, r in {**two, **four}.items():
        check_mesh(key, r)
    # the kernels at a (1, 2) time shard's shapes, in this process (CUDA
    # events, median of 5; measurement only, after every count was read):
    # the conv and the tail with their halos of 5 and 4 blocks, and one
    # round of dynspec's serial walk over the shard, and its round step
    fir_e, dyn_e, tail_e = chains["chain8"].exec_effects
    nbl = -(-n // (2 * PARALLEL_B))
    x = pt.block.make_blocks(torch.nn.functional.pad(
        signal, (0, 2 * nbl * PARALLEL_B - n)), PARALLEL_B)
    rest = torch.zeros((len(dyn_e.params), CHANNELS), dtype=torch.int32,
                       device="cuda")
    flat = x[:, nbl:].reshape(CHANNELS, -1).contiguous()
    scalars = [kdyn.op_scalars(p) for p in dyn_e.params]
    entry, flags = rest.clone(), torch.zeros(3, dtype=torch.int32,
                                             device="cuda")
    shard_kernel_ms = {
        "segconv_with_halo": time_ms(lambda: fir_e.offline(
            fir_e.params, x[:, nbl - 5:].contiguous())),
        "serial_walk_round": time_ms(lambda: kdyn.serial_walk(
            scalars, flat, rest)),
        "round_step": time_ms(lambda: kdyn.round_step(
            rest, entry, flags, False)),
        "tail_with_halo": time_ms(lambda: tail_e.offline(
            tail_e.params, x[:, nbl - 4:].contiguous(),
            first_block=nbl - 4)),
        "shard_blocks": nbl}
    del x, flat
    launch_counts_by_run = {"1x1": launches1,
                            **{k: {name: r["chain8"]["launches_graph"][name]
                                   + r["eq_chain"]["launches_graph"][name]
                                   for name in KERNELS}
                               for k, r in {**two, **four}.items()}}
    return {"phase": "parallel", "channels": CHANNELS, "B": PARALLEL_B,
            "chains": {"chain8": CHAIN8_NAMES, "eq_chain": EQ_CHAIN},
            "dynspec_route": DYNSPEC_ROUTE,
            "one_rank_nccl": r1,
            "two_ranks_gloo": {"seconds_of_audio": SECONDS, **two},
            "four_ranks_gloo": {"seconds_of_audio": PARALLEL4_SECONDS,
                                **four},
            "kernel_ms_at_a_1x2_shard": shard_kernel_ms,
            "round_step": rounds,
            "launch_counts": launch_counts_by_run, "nvidia_smi": smi}


# ---------------------------------------------------------------------------
# phase 5f: the profiler's scopes and the roofline by effect

# chain8 unfused: one scope an effect
CHAIN8_EFFECTS = ["lowcut", "highcut", "eq3band_fft", "compressor", "gate",
                  "delay", "tremolo", "softclipper"]
FIR_EFFECTS = ("lowcut", "highcut", "eq3band_fft")
DYNAMICS_EFFECTS = ("compressor", "gate")
PROFILE_STREAM_B = 512
PROFILE_STREAM_BLOCKS = 64
# what a trace calls a device event: kernels, copies and fills
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")
# the port's kernels by symbol (preceded by no letter: unpack_kernel is not
# pack_kernel, serial_walk_kernel is not walk_kernel) -> launch counter; the
# offline walks are one template, walk_kernel<N_OPS, AUDIO, kVec>
KERNEL_SYMBOLS = {"segconv_kernel": "segconv", "tail_kernel": "tail",
                  "pack_kernel": "pack", "unpack_kernel": "unpack",
                  "serial_walk_kernel": "serial_walk",
                  "convpairs_kernel": "conv_pairs"}
WALK_SYMBOL = re.compile(
    r"(?<![A-Za-z_])walk_kernel(?:<\s*\d+\s*,\s*(true|false)|ILi\d+ELb([01]))")


def kernel_counter(name: str) -> str | None:
    """The launch counter of a trace's kernel, None for PyTorch's own."""
    for symbol, counter in KERNEL_SYMBOLS.items():
        if re.search(rf"(?<![A-Za-z_]){symbol}", name):
            return counter
    m = WALK_SYMBOL.search(name)
    if m:
        return "audio_walk" if (m.group(1) or m.group(2)) in ("true", "1") \
            else "state_walk"
    return None


def read_trace(log_dir: str) -> list:
    """The events of the one trace ``profiling.trace`` wrote there."""
    paths = glob.glob(os.path.join(log_dir, "*.pt.trace.json*"))
    assert len(paths) == 1, paths
    opener = gzip.open if paths[0].endswith(".gz") else open
    with opener(paths[0], "rt") as f:
        return json.load(f)["traceEvents"]


def scope_table(events: list, prefix: str = "effect.") -> dict:
    """Device time and kernel launches by profiler scope. A device event
    belongs to the scope whose host interval holds the runtime call that
    launched it (matched by its correlation id): containment, which holds
    for the ctypes launches as for PyTorch's. Beside it, the profiler's own
    device spans of the scopes (``gpu_user_annotation``) where it makes
    them."""
    scopes = sorted((e for e in events if e.get("cat") == "user_annotation"
                     and e.get("name", "").startswith(prefix)),
                    key=lambda e: e["ts"])
    starts = [sc["ts"] for sc in scopes]
    launched_at = {e["args"]["correlation"]: e["ts"] for e in events
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and "correlation" in e.get("args", {})}
    table = {}
    for sc in scopes:
        row = table.setdefault(sc["name"], {
            "calls": 0, "host_ms": 0.0, "device_ms": 0.0, "device_events": 0,
            "launches": {}})
        row["calls"] += 1
        row["host_ms"] += sc["dur"] / 1e3
    outside = {"device_ms": 0.0, "device_events": 0, "launches": {}}
    for e in events:
        if e.get("cat") not in DEVICE_EVENTS:
            continue
        ts = launched_at.get(e.get("args", {}).get("correlation"))
        row = outside
        if ts is not None:
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= scopes[i]["ts"] + scopes[i]["dur"]:
                row = table[scopes[i]["name"]]
        row["device_ms"] += e["dur"] / 1e3
        row["device_events"] += 1
        counter = kernel_counter(e["name"]) if e["cat"] == "kernel" else None
        if counter:
            row["launches"][counter] = row["launches"].get(counter, 0) + 1
    spans = {}
    for e in events:
        if e.get("cat") == "gpu_user_annotation" and \
                e.get("name", "").startswith(prefix):
            spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur"] / 1e3
    return {"scopes": table, "outside_scopes": outside,
            "profiler_device_spans_ms": spans}


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def effect_cost(e, C: int, T: int) -> dict:
    """The roofline's cost of one effect's whole-signal pass over (C, T)."""
    cost = rl.conv_cost_from_params(C, T, e.params)
    if cost is not None:
        return cost
    if isinstance(e.params, ops_dynamics.DynamicsParams):
        return rl.dynamics_cost(C, T, 1)
    stages = tail._plan_stages([e])[0]
    return rl.simple_cost(C, T, 1.0, 1.0, rl.tail_ops_per_sample(stages))


def expect_launches(name: str, launches: dict, kind: str, blocks: int = 1):
    """What an effect of unfused chain8 launches: offline, the conv once a
    FIR and both walks a dynamics op; a step, ``conv_pairs`` a FIR and
    ``serial_walk`` a dynamics op; the tail's members run plain, but for
    the lone waveshaper's offline, one launch of the tail kernel."""
    if name in FIR_EFFECTS:
        want = {"segconv": 1} if kind == "offline" else \
            {"conv_pairs": blocks}
        assert launches == want, (name, kind, launches)
    elif name in DYNAMICS_EFFECTS:
        if kind == "offline":
            assert set(launches) == {"state_walk", "audio_walk"}, \
                (name, launches)
        else:
            assert launches == {"serial_walk": blocks}, (name, launches)
    elif name == "softclipper" and kind == "offline":
        assert launches == {"tail": 1}, (name, launches)
    else:
        assert launches == {}, (name, kind, launches)


def lone_map_phase(signal: torch.Tensor, n: int, smi: str) -> dict:
    """Each lone waveshaper of LONE_MAP_PLANS at the main path's shape
    (64 ch x 30 s, B=4096), on the main path's signal times 3 (past full
    scale in the bursts: the clippers' clamps at work): its ``offline`` is
    one launch of the tail kernel (a one-stage ``map`` plan), held to the
    same effect's plain ``offline`` (``use_kernels=False``) on the same
    blocks: TAIL_DB_PLAIN, the bitcrusher exactly; the kernel timed queued
    and the plain map by events, beside the roofline's bound."""
    pk = rl.peaks_for_device()
    B = BLOCK_SIZES[0]
    cfg = pt.EngineConfig(SAMPLE_RATE, B)
    blocks = pt.block.make_blocks(signal * 3.0, B)
    C, nb, _ = blocks.shape
    T = nb * B
    maps, launch_counts_by_run = {}, {}
    for plan in LONE_MAP_PLANS:
        (e,) = tail_members(cfg, plan)
        got, counts = counted(lambda: e.offline(e.params, blocks))
        assert nonzero(counts) == {"tail": 1}, (plan, counts)
        want = e.offline(e.params, blocks, use_kernels=False)
        assert got.shape == blocks.shape and got.dtype == torch.float32
        assert bool(torch.isfinite(got).all()), plan
        r = {"effect": e.name, "launches": nonzero(counts)}
        if plan in EXACT_PLANS:
            r["bit_equal_to_plain"] = bool(torch.equal(got, want))
            assert r["bit_equal_to_plain"], (plan, r)
        else:
            db = snr_db_cuda(want, got)
            r["db_plain"] = db_json(db)
            assert db >= TAIL_DB_PLAIN, (plan, r)
        del got, want
        cost = effect_cost(e, C, T)
        kernel = queued_ms(lambda: e.offline(e.params, blocks), runs=20)
        plain = time_ms(lambda: e.offline(e.params, blocks,
                                          use_kernels=False))
        maps[plan] = {
            **r, **rl.bound(cost, pk),
            "kernel": {"ms": kernel,
                       **rl.classify(kernel * 1e-3, cost, pk)},
            "plain": {"ms": plain,
                      **rl.classify(plain * 1e-3, cost, pk)}}
        launch_counts_by_run[f"{plan} offline"] = counts
    return {"phase": "lone_maps", "B": B, "channels": C, "samples": T,
            "maps": maps, "launch_counts": launch_counts_by_run,
            "nvidia_smi": smi}


def profiling_phase(signal: torch.Tensor, n: int, smi: str) -> dict:
    """chain8 through ``profiling.annotate_chain`` at 64 ch x 30 s, B=4096
    and 512: (a) rendered under ``profiling.trace``, bit-equal to the
    unfused chain's render and >= TAIL_DB_PLAIN to the unfused chain
    rendered with the tail's members plain (the lone soft clipper's
    one-stage launch against its plain map), and the fused chain's render
    >= CHAIN8_DB_PLAIN to that plain-tail render; (b)
    every ``effect.<name>.offline`` scope in the trace; (c) each scope's
    launches equal to the counters' over the same effect's pass; (d) each
    scope's device ms against the roofline's cost of its effect; (e) at
    B=512, 64 blocks through the annotated chain's eager ``Chain.step``
    under a trace (a captured step's replay has no host scopes), bit-equal
    to the unfused chain's steps, every ``effect.<name>.step`` scope with
    its launches."""
    pk = rl.peaks_for_device()
    C = signal.shape[0]
    runs, launch_counts_by_run, chains = {}, {}, {}
    for B in BLOCK_SIZES:
        cfg, fused = chain8(B)
        bare = pt.Chain(fused.effects, fuse=False, device="cuda")
        ann = profiling.annotate_chain(fused)
        chains[B] = (cfg, bare, ann)
        assert [e.name for e in ann.exec_effects] == CHAIN8_EFFECTS
        T = -(-n // B) * B
        # eager renders throughout: a graph's replay has no host scopes
        want = eager_render(bare, signal, cfg)
        # the same with the tail's members plain (the lone clipper's
        # one-stage launch too): the fused tail's and the lone clipper's
        # reference in plain PyTorch
        plain_tail = pt.block.make_blocks(signal, B)
        for e in bare.exec_effects:
            plain_tail = e.offline(e.params, plain_tail,
                                   use_kernels=not tail.tail_fusable(e))
        plain_tail = pt.block.combine_blocks(plain_tail)
        # the counters' launches of each effect, effect by effect through
        # the annotated chain's own effects (untraced)
        x, by_effect = pt.block.make_blocks(signal, B), {}
        for e in ann.exec_effects:
            x, counts = counted(lambda: e.offline(e.params, x))
            by_effect[e.name] = nonzero(counts)
        assert torch.equal(pt.block.combine_blocks(x), want)
        del x
        with tempfile.TemporaryDirectory() as d:
            with profiling.trace(d):
                got, traced = counted(lambda: eager_render(ann, signal,
                                                           cfg))
            table = scope_table(read_trace(d))
        bit_equal = torch.equal(got, want)
        db_fused = snr_db_cuda(plain_tail, eager_render(fused, signal, cfg))
        db_lone = snr_db_cuda(plain_tail, got)
        del got, want, plain_tail
        scopes = table["scopes"]
        assert sorted(scopes) == sorted(f"effect.{name}.offline"
                                        for name in CHAIN8_EFFECTS), scopes
        by_scope = {}
        for e in ann.exec_effects:
            row = scopes[f"effect.{e.name}.offline"]
            assert row["calls"] == 1 and row["device_events"] > 0, row
            assert row["launches"] == by_effect[e.name], \
                (e.name, row, by_effect[e.name])
            expect_launches(e.name, row["launches"], "offline")
            cost = effect_cost(e, C, T)
            by_scope[e.name] = {
                **row, **rl.bound(cost, pk),
                **rl.classify(row["device_ms"] * 1e-3, cost, pk)}
        assert table["outside_scopes"]["launches"] == {}, table
        assert nonzero(traced) == {
            k: sum(r["launches"].get(k, 0) for r in scopes.values())
            for k in nonzero(traced)}, (traced, scopes)
        runs[str(B)] = {
            "bit_equal_to_unfused": bit_equal,
            "fused_db_to_plain_tail": db_json(db_fused),
            "db_to_plain_tail": db_json(db_lone),
            "launches": nonzero(traced),
            "device_ms_in_scopes": sum(r["device_ms"]
                                       for r in scopes.values()),
            "device_ms_outside_scopes":
                table["outside_scopes"]["device_ms"],
            "profiler_device_spans_ms": table["profiler_device_spans_ms"],
            "by_effect": by_scope}
        launch_counts_by_run[f"B={B} traced render"] = traced
        assert bit_equal and db_fused >= CHAIN8_DB_PLAIN \
            and db_lone >= TAIL_DB_PLAIN, runs[str(B)]

    # (e) the annotated chain streamed, its steps' scopes
    B = PROFILE_STREAM_B
    cfg, bare, ann = chains[B]
    xs = signal[:, :PROFILE_STREAM_BLOCKS * B]
    blocks = [xs[:, i * B:(i + 1) * B] for i in range(PROFILE_STREAM_BLOCKS)]
    def fold(chain):
        state = chain.init_state((C,))
        outs = []
        for b in blocks:
            state, y = chain.step(state, b)
            outs.append(y)
        return outs

    want = torch.cat(fold(bare), dim=-1)
    fold(ann)                                   # warm-up, untraced
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d):
            outs, streamed = counted(lambda: fold(ann))
        table = scope_table(read_trace(d))
    bit_equal = torch.equal(torch.cat(outs, dim=-1), want)
    scopes = table["scopes"]
    assert sorted(scopes) == sorted(f"effect.{name}.step"
                                    for name in CHAIN8_EFFECTS), scopes
    for name in CHAIN8_EFFECTS:
        row = scopes[f"effect.{name}.step"]
        assert row["calls"] == PROFILE_STREAM_BLOCKS, (name, row)
        expect_launches(name, row["launches"], "step", PROFILE_STREAM_BLOCKS)
    assert nonzero(streamed) == {
        "conv_pairs": len(FIR_EFFECTS) * PROFILE_STREAM_BLOCKS,
        "serial_walk": len(DYNAMICS_EFFECTS) * PROFILE_STREAM_BLOCKS}, \
        streamed
    assert bit_equal, "the annotated chain's steps differ"
    launch_counts_by_run[f"B={B} traced stream"] = streamed
    return {"phase": "profiling", "chain": "chain8 unfused, annotated",
            "channels": C, "seconds_of_audio": SECONDS,
            "effects": CHAIN8_EFFECTS,
            "attribution": "a device event belongs to the scope whose host "
                           "interval holds its launch (correlation id)",
            "render_by_block_size": runs,
            "stream": {"B": B, "blocks": PROFILE_STREAM_BLOCKS,
                       "bit_equal_to_unfused": bit_equal,
                       "launches": nonzero(streamed),
                       "by_effect": {name[len("effect."):-len(".step")]: row
                                     for name, row in scopes.items()},
                       "profiler_device_spans_ms":
                           table["profiler_device_spans_ms"]},
            "launch_counts": launch_counts_by_run, "nvidia_smi": smi}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace a few renders and steps with "
                         "torch.profiler and print device time by kernel")
    args = ap.parse_args()

    if not __debug__:
        sys.exit("chip_smoke.py checks with assert statements: run it "
                 "without -O")
    if not torch.cuda.is_available():
        print("chip_smoke.py needs an NVIDIA GPU: torch.cuda.is_available() "
              "is False", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    print(smi, flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    paths = _build.build_all()
    for name in paths:
        _build.load(name)
    runtime_native.load()       # the realtime runtime's ring (g++)
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 2),
          "sources": sorted(f"pyaudiodsptools_tpu_torch/csrc/{n}.cu"
                            for n in paths)
          + ["pyaudiodsptools_tpu_torch/runtime/native/padt_runtime.cpp"],
          "ptxas": {n: [ln for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, log in _build.build_log.items()}})

    # ---- 3. small cases
    emit(conv_cases())
    emit(tail_cases())
    for cases in (relayout_cases, dynamics_cases, convpairs_cases,
                  serial_walk_cases):
        t0 = time.perf_counter()
        emit({**cases(), "seconds": round(time.perf_counter() - t0, 1)})

    # ---- 4. the paths: counts to 0, render, read counts
    C = CHANNELS
    n = int(SECONDS * SAMPLE_RATE)
    signal = bench_signals.burst_noise(C, n, SAMPLE_RATE, args.seed, "cuda")

    # the main path, chain8, at both block sizes
    chains = {B: chain8(B) for B in BLOCK_SIZES}
    # each render's graph captured first (its warm-up is an eager render):
    # the counted run is the replays'
    for B in BLOCK_SIZES:
        prepare_render(chains[B][1], signal, chains[B][0])

    zero_launch_counts()
    outputs, walks, device_walks = {}, {}, {}
    for B in BLOCK_SIZES:
        cfg, chain = chains[B]
        w0 = kdyn.state_walk_launch_count + kdyn.audio_walk_launch_count
        outputs[B] = pt.render(chain, signal, cfg)
        # the device's walk count (a sync): adds the while node's audio
        # walks to their counter
        device_walks[B] = chain.captured_render().walks()[
            render_shape(signal, B)]
        walks[B] = kdyn.state_walk_launch_count \
            + kdyn.audio_walk_launch_count - w0
        assert walks[B] == sum(device_walks[B]), (walks, device_walks)
    launches = launch_counts()
    settles = kdyn.settle_launch_count
    assert settles == sum(walks.values()), (settles, walks)
    main_outputs = dict(outputs)    # compiled_render holds the graph to them
    for name, count in launches.items():
        if name in STREAM_KERNELS + OFF_PATH_KERNELS:
            assert count == 0, (name, launches)
        else:
            assert count >= len(BLOCK_SIZES), (name, launches)

    main_checks, oracles = {}, {}
    for B in BLOCK_SIZES:
        cfg, chain = chains[B]
        main_checks[B] = check_render(chain, cfg, signal, outputs[B], n,
                                      oracles)
        main_checks[B]["dynamics_walks"] = walks[B]
    T = -(-n // BLOCK_SIZES[0]) * BLOCK_SIZES[0]
    emit({"phase": "main_path", "chain": "chain8", "channels": C,
          "seconds_of_audio": SECONDS, "samples_per_channel": n,
          "through": "the captured render (a CUDA graph a blocks shape; the "
                     "dynamics fixpoint in a conditional while node)",
          "launches": launches, "settle_step_launches": settles,
          "dynamics_segments": kdyn.plan_segments(C, T),
          "oracle": f"float64, 2 channels, first {ORACLE_EXCERPT} samples "
                    f"({ORACLE_EXCERPT / SAMPLE_RATE:.2f} s): the automatons "
                    "are walked sample by sample in Python",
          "by_block_size": {str(B): main_checks[B] for B in BLOCK_SIZES},
          "nvidia_smi": smi})

    # launches by path beside the main path's (the later slices' phases)
    path_launches = {}

    # ---- 5. the streaming main path: counts to 0, stream, read counts
    timing = {name: {} for name in KERNELS}
    stream_checks, stream_launches = {}, {}
    with tempfile.TemporaryDirectory() as workdir:
        for B in BLOCK_SIZES:
            cfg, chain = chains[B]
            t0 = time.perf_counter()
            stream_checks[B], stream_launches[B] = \
                stream_path(chain, cfg, signal, n, outputs.pop(B), oracles[B],
                            workdir)
            stream_checks[B]["seconds"] = round(time.perf_counter() - t0, 1)
    for name in STREAM_KERNELS:
        launches[name] = sum(c[name] for c in stream_launches.values())
        assert launches[name] == sum(
            -(-n // B) for B in BLOCK_SIZES), (name, launches)
    emit({"phase": "stream_path", "chain": "chain8", "channels": C,
          "seconds_of_audio": SECONDS, "samples_per_channel": n,
          "launches": {name: launches[name] for name in STREAM_KERNELS},
          "by_block_size": {str(B): stream_checks[B] for B in BLOCK_SIZES},
          "nvidia_smi": smi})
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        compiled = compiled_step_phase(chains, signal, n, oracles, workdir,
                                       smi)
    path_launches["compiled_step"] = compiled["launch_counts"]
    emit({**compiled, "seconds": round(time.perf_counter() - t0, 1)})
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        compiled_r = compiled_render_phase(chains, signal, n, main_outputs,
                                           oracles, workdir, smi)
    del main_outputs
    path_launches["compiled_render"] = compiled_r["launch_counts"]
    emit({**compiled_r, "seconds": round(time.perf_counter() - t0, 1)})
    for B in BLOCK_SIZES:
        cfg, chain = chains[B]
        T = -(-n // B) * B
        time_stream_kernels(chain, cfg,
                            torch.nn.functional.pad(signal, (0, T - n)),
                            timing)
    near_empty = queued_ms(lambda: kdyn.serial_walk(
        [kdyn.op_scalars(chains[512][1].exec_effects[1].params[0])],
        torch.zeros((1, 1), device="cuda"),
        torch.zeros((1, 1), dtype=torch.int32, device="cuda")))
    emit({"phase": "stream_kernels", "chain": "chain8", "channels": C,
          "by_block_size": {str(B): {
              "serial_walk": timing["serial_walk"][B],
              "conv_pairs": timing["conv_pairs"][B]} for B in BLOCK_SIZES},
          "near_empty_launch": {"what": "serial_walk at C=1, T=1",
                                "ms": near_empty},
          "serial_walk_sweep": {str(B): sweep_serial_segments(
              chains[B][1], chains[B][0]) for B in BLOCK_SIZES},
          "conv_pairs_cluster_by_window": time_cluster_by_window(),
          "conv_pairs_full_card_batch": time_full_batch(),
          "nvidia_smi": smi})
    t0 = time.perf_counter()
    emit({**long_windows(signal, n), "nvidia_smi": smi,
          "seconds": round(time.perf_counter() - t0, 1)})
    with tempfile.TemporaryDirectory() as workdir:
        for phase in (lambda: reverb_phase(signal, n, smi),
                      lambda: eq3band_phase(signal, n, smi),
                      lambda: compat_phase(signal, n, workdir, smi),
                      lambda: runtime_phase(signal, n, smi),
                      lambda: parallel_phase(signal, n, smi, args.seed),
                      lambda: lone_map_phase(signal, n, smi),
                      lambda: profiling_phase(signal, n, smi)):
            t0 = time.perf_counter()
            out = phase()
            path_launches[out["phase"]] = out["launch_counts"]
            emit({**out, "seconds": round(time.perf_counter() - t0, 1)})

    # ---- 6. the offline kernels at the main-path shapes
    stage_by_B, sweep = {}, {}
    for B in BLOCK_SIZES:
        cfg, chain = chains[B]
        fir_e, dyn_e, tail_e = chain.exec_effects
        T = -(-n // B) * B
        x = torch.nn.functional.pad(signal, (0, T - n)).contiguous()
        y_conv = time_segconv(x, fir_e, timing["segconv"], B)
        if B == BLOCK_SIZES[0]:
            timing["segconv"][B]["reverb_parts"] = time_reverb_parts(x)
        y_dyn = time_dynamics(y_conv, dyn_e, timing, B)
        stage_by_B[B] = check_dynamics_stage(y_conv, dyn_e, y_dyn)
        if B == BLOCK_SIZES[0]:
            gaps = (torch.sin(2 * torch.pi * torch.arange(T, device="cuda")
                              / SAMPLE_RATE) > 0.3).to(torch.float32)
            sweep = {"main_path_input": sweep_segments(y_conv, dyn_e, y_dyn),
                     "input_with_0.6s_silences_every_second":
                         sweep_segments(y_conv * gaps, dyn_e, None)}
            del gaps
        del x, y_conv
        time_tail(y_dyn, chain, tail_e, timing["tail"], B)
        del y_dyn
    emit({"phase": "kernel_timing", "nvidia_smi": smi,
          **{name: {str(B): v for B, v in by_B.items()}
             for name, by_B in timing.items() if name not in STREAM_KERNELS},
          "dynamics_stage": {str(B): v for B, v in stage_by_B.items()},
          "segment_sweep": sweep})

    if args.profile:
        emit({"phase": "profile", "chain": "chain8", "channels": C,
              "by_block_size": {
                  str(B): profile_renders(chains[B][1], signal, chains[B][0])
                  for B in BLOCK_SIZES},
              "stream_by_block_size": {
                  str(B): {kind: profile_stream(
                      chains[B][1], chains[B][0], signal,
                      steps=min(200, n // B - 8), eager=kind == "eager")
                      for kind in ("graph", "eager")}
                  for B in BLOCK_SIZES},
              "nvidia_smi": smi})

    # ---- 7. the kernels, one line; headline numbers at block size 4096
    head = BLOCK_SIZES[0]
    summary = []
    for name, (source, replaces) in KERNELS.items():
        by_B = timing[name]
        h = by_B[head]
        summary.append({
            "name": name, "route": "cuda",
            "source": f"pyaudiodsptools_tpu_torch/csrc/{source}",
            "replaces": f"pyaudiodsptools_tpu/kernels/{replaces}",
            "launches": launches[name],
            "launches_on_other_paths": {
                path: {run: counts[name] for run, counts in runs.items()}
                for path, runs in path_launches.items()},
            "max_abs_err": max(v["max_abs_err"] for v in by_B.values()),
            "ms": h["ms"], "plain_ms": h["plain_ms"],
            "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
            "library_ms": h["library_ms"],
            # roofline.classify of the kernel's time against the function's
            # cost (the plain and library times' shares are in by_block_size)
            **{k: h["roofline"]["ms"][k] for k in (
                "hbm_roofline_pct", "fp32_roofline_pct", "bound")},
            # a bound the card can reach: a near-empty launch's device time
            "launch_floor_ms": near_empty,
            # rows 7-8: a call's device time inside a graph of GRAPH_STEPS
            **({"in_graph_ms": h["in_graph_ms"]} if "in_graph_ms" in h
               else {}),
            "by_block_size": {str(B): {k: v[k] for k in (
                "ms", "plain_ms", "library_ms", "copy_ms", "queued_ms",
                "copy_queued_ms", "masked_path_queued_ms", "bound_ms",
                "bound_by", "in_graph_ms", "reverb_parts",
                "roofline", "critical_path_ms", "serial_walk_ms",
                "conv_pairs_ms", "conv_pairs_bound_ms")
                if k in v}
                for B, v in by_B.items()}})
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start, 1)})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
