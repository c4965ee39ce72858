#!/usr/bin/env python3
"""Card lane of the PyTorch/CUDA port: build, check and drive it on one GPU.

    python3 chip_smoke.py            # needs one NVIDIA GPU (written for H100)

What it does, in order; every phase prints one JSON object per line, and any
failed check raises (exit code != 0, no result line):

1. ``device``  the card's name and power limit as ``nvidia-smi`` gives them,
   and the torch / CUDA versions.
2. ``build``   compiles ``pyaudiodsptools_tpu_torch/csrc/*.cu`` with ``nvcc``
   for sm_90a (one process per source, started together). Set-up time: it
   is in no rate below.
3. ``kernel_cases``  each hand-written kernel against its plain PyTorch
   version (and the conv against a float64 oracle) on small cases that cover
   the edges: odd window counts, ragged tiles, re-zeroing before the signal
   start, a shrunk tile, a run the tail kernel refuses.
4. ``main_path``  the chain7 configuration of the flagship chain (saturator
   in place of the compressor/gate pair, whose kernels come with the next
   slice) through ``render`` at 64 channels x 30 s, block size 4096 then 512,
   on noise bursts generated on the card from a seed. The kernels' launch
   counts are set to 0 just before and read just after. Then the outputs are
   held against the same render with ``use_kernels=False`` on the card and,
   for two channels, against a float64 numpy oracle of the whole chain.
5. ``kernel_timing``  each kernel at the main-path shapes: time (CUDA events,
   median of 5 after a warm-up) beside its plain version, a library
   yardstick where there is one, and its bound (bytes over the card's memory
   rate, operations over its fp32 rate, whichever is larger).
6. ``throughput``  samples/s of the whole render, median of 3 chained passes.
   With ``--profile``, a ``profile`` phase follows: ``torch.profiler`` over a
   few renders, device time by kernel name and the device's idle share.
7. the ``{"kernels": [...]}`` summary line, and as the LAST line
   ``{"ok": true, "device": {...}}``.

Tolerances, with their reasons, are the constants below.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import pyaudiodsptools_tpu_torch as pt
from pyaudiodsptools_tpu_torch.kernels import _build, segconv, tail
from pyaudiodsptools_tpu_torch.ops import fft_filter
from pyaudiodsptools_tpu_torch.ops.tremolo import TremoloParams, gain_row

SAMPLE_RATE = 44100
BLOCK_SIZES = (4096, 512)
# The main path's size: the flagship render, full width and full length.
CHANNELS = 64
SECONDS = 30.0

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate and
# the fp32 rate outside the tensor cores. The bounds below are against these.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

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
# the chain


def chain7_effects(cfg, device):
    o = pt.ops
    return [o.lowcut(cfg, 120.0, device=device),
            o.highcut(cfg, 12000.0, device=device),
            o.eq3band_fft(cfg, 250.0, 2.0, 1500.0, -1.5, 6000.0, 2.5,
                          device=device),
            o.saturator(cfg, device=device),
            o.delay(cfg, 150.0, 2, device=device),
            o.tremolo(cfg, 0.3, 5.0, device=device),
            o.softclipper(cfg, 0.44, device=device)]


def burst_noise(channels: int, n: int, seed: int) -> torch.Tensor:
    """Noise times a burst envelope, made on the card from a seed."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    noise = 0.25 * torch.randn((channels, n), generator=gen, device="cuda",
                               dtype=torch.float32)
    t = torch.arange(n, device="cuda", dtype=torch.float32)
    burst = (torch.sin(2 * torch.pi * t / (SAMPLE_RATE // 3)) > 0.6
             ).to(torch.float32) * 0.5 + 0.3
    return torch.clip(noise * burst, -0.99, 0.99)


def chain7_oracle(x: np.ndarray, effects, block_size: int) -> np.ndarray:
    """The whole chain in float64 numpy, from the ops' definitions: three
    causal FIRs (the filters' float64 impulse responses), the saturator
    knee, the delay's taps, the tremolo's LFO table walked block by block
    (freeze quirk included), the soft clipper."""
    C, T = x.shape
    y = x.astype(np.float64)
    for e in effects[:3]:
        y = fft_conv64(y, e.lti_kernel)
    sat, dly, trem, clip = (e.params for e in effects[3:])
    coeff, makeup = float(sat.coeff), float(sat.makeup)
    a = np.abs(y)
    over = a - coeff
    shaped = coeff + over / (1.0 + (over / (1.0 - coeff)) ** sat.mode)
    a = np.where(a > coeff, shaped, a)
    a = np.where(a > 1.0, (coeff + 1.0) / 2.0, a)
    y = makeup * np.where(y < 0, -a, a)
    acc = y.copy()
    for k in range(dly.feedback_loops):
        d = dly.time_in_samples * (k + 1)
        if d < T:
            acc[:, d:] += float(dly.ramp[k]) * y[:, :T - d]
    y = acc
    L = trem.lfo_length
    depth = float(trem.depth)
    lfo = (np.sin(float(trem.omega) * np.arange(L)) / 2 + 0.5) * depth \
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
    a = np.minimum(np.abs(y), 1.0)
    a = -np.abs(a - 1.0) ** float(clip.drive) + 1.0
    return np.where(y < 0, -a, a)


# ---------------------------------------------------------------------------
# phase 3: small cases


def conv_cases() -> dict:
    """(n, halo, klen, shift, C, T): the three cases of the CPU tests at
    B=2048 through the port's planner, plus windows that exercise the
    smallest sizes, the extra radix-2 pass and ragged last windows."""
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
              (16384, 8192, 8185, 9219, 2, 16384 * 3 + 1)]
    for n, halo, klen, shift, C, T in cases:
        k = rng.standard_normal(klen) * 0.1
        plan = segconv.make_plan(k, halo, n - halo, shift, "cuda")
        x = rng.standard_normal((C, T)).astype(np.float32)
        xd = torch.from_numpy(x).cuda()
        before = segconv.launch_count
        got = segconv.segmented_conv(xd, plan)
        torch.cuda.synchronize()
        assert segconv.launch_count == before + 1
        plain = segconv.segmented_conv(xd, plan, use_kernels=False)
        torch.cuda.synchronize()
        assert segconv.launch_count == before + 1
        db_plain = snr_db_cuda(plain, got)
        db_oracle = snr_db(fft_conv64(x, k, shift), got.cpu().numpy())
        assert bool(torch.isfinite(got).all())
        assert not bool(got[:, :shift].any()), "output delay is not silence"
        results.append({"n": n, "halo": halo, "taps": klen, "shift": shift,
                        "C": C, "T": T, "db_plain": db_json(db_plain),
                        "db_oracle": db_json(db_oracle)})
        assert db_plain >= CONV_DB_PLAIN, results[-1]
        assert db_oracle >= CONV_DB_ORACLE, results[-1]
    return {"phase": "kernel_cases", "name": "segconv",
            "replaces": "pyaudiodsptools_tpu/kernels/pallas_conv.py:segmented_conv_fused",
            "cases": results,
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
    # halo 44,100: one block per SM, the tile shrunk to fit beside the halo
    "long_delay+softclipper": [
        ("delay", (500.0, 2), {}), ("softclipper", (0.44,), {})],
    # exact plans: nothing that rounds differently precedes the bitcrusher
    "bitcrusher+delay": [("bitcrusher", (), {}), ("delay", (9.0, 2), {})],
    "delay+tremolo+bitcrusher": [
        ("delay", (9.0, 3), {}), ("tremolo", (0.3, 5.0), {}),
        ("bitcrusher", (), {})],
    # a division / a pow before the bitcrusher: rare whole-step differences
    "saturator+bitcrusher": [("saturator", (), {}), ("bitcrusher", (), {})],
    "softclipper+bitcrusher": [("softclipper", (0.44,), {}),
                               ("bitcrusher", (), {})],
}
EXACT_PLANS = ("bitcrusher+delay", "delay+tremolo+bitcrusher")


def tail_members(cfg, plan: str):
    return [getattr(pt.ops, op)(cfg, *args, **kw, device="cuda")
            for op, args, kw in TAIL_PLANS[plan]]


def tail_cases() -> dict:
    cfg = pt.EngineConfig(SAMPLE_RATE, 512)
    rng = np.random.default_rng(11)
    results = []
    for plan in TAIL_PLANS:
        for C in (1, 3):
            # 140 blocks of 512 = 71,680 samples: several tiles at every
            # plan's halo, the last one ragged
            x = (rng.standard_normal((C, 140, 512)) * 0.6).astype(np.float32)
            x[0, 0, :6] = [1.4, -1.4, 0.0, 2.2, -0.79, 0.81]
            xd = torch.from_numpy(x[0] if C == 1 else x).cuda()
            fused = tail.fused_tail(tail_members(cfg, plan))
            before = tail.launch_count
            got = fused.offline(fused.params, xd)
            torch.cuda.synchronize()
            assert tail.launch_count == before + 1, plan
            want = fused.offline(fused.params, xd, use_kernels=False)
            torch.cuda.synchronize()
            assert tail.launch_count == before + 1
            assert bool(torch.isfinite(got).all())
            r = {"plan": plan, "C": C, "T": 140 * 512}
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
    # a halo that cannot fit shared memory at all is refused when the fused
    # effect is built: there is no route around the kernel on the card
    long_run = [pt.ops.delay(cfg, 700.0, 2, device="cuda"),
                pt.ops.softclipper(cfg, device="cuda")]
    try:
        tail.fused_tail(long_run)
    except ValueError as e:
        refused = "shared memory" in str(e)
    else:
        refused = False
    assert refused, "a tail run beyond the kernel's halo limit was accepted"
    # streaming state is born on the effect's device
    assert long_run[0].state((2,))["buffer"].is_cuda
    dbs = [r["db_plain"] for r in results if r.get("db_plain") is not None]
    return {"phase": "kernel_cases", "name": "tail",
            "replaces": "pyaudiodsptools_tpu/kernels/tail_pallas.py:tail_kernel",
            "cases": results, "min_snr_db": min(dbs),
            "max_mismatch_fraction": max(
                r.get("mismatch_fraction", 0.0) for r in results),
            "oversized_run_refused": refused}


# ---------------------------------------------------------------------------
# phases 4-6: the main path


def tail_ops_per_sample(stages) -> int:
    """Rough operation count of one sample through the stage plan (for the
    operations side of the bound): 2 per tap, 1 per gain, and per map the
    arithmetic of its formula with a pow or a sin counted as 30."""
    per_map = {"saturator": 12, "softclipper": 36, "harddistortion": 38,
               "bitcrusher": 5}
    ops = 0
    for s in stages:
        if s[0] == "taps":
            ops += 1 + 2 * len(s[1])
        elif s[0] == "gain":
            ops += 1
        else:
            ops += per_map[s[1]]
    return ops


def profile_renders(chain, signal, cfg, render_ms: float, passes: int = 3
                    ) -> dict:
    """Device time of ``passes`` chained renders under ``torch.profiler``, by
    kernel name, and the device's idle share of one render: 1 - busy time
    over ``render_ms`` (the host-clock render time taken WITHOUT the profiler,
    whose own cost would otherwise count as idleness)."""
    from torch.profiler import ProfilerActivity, profile

    o = pt.render(chain, signal, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(passes):
            o = pt.render(chain, o, cfg)
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.key_averages():
        # device-side entries only: a PyTorch operator's entry repeats the
        # time of the kernels it launched
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3 / passes
    if not by_name:
        raise RuntimeError("torch.profiler recorded no device time")
    busy_ms = sum(by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    return {"passes": passes, "device_busy_ms_per_render": busy_ms,
            "render_ms": render_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / render_ms),
            "device_ms_per_render_by_name": top}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace a few renders with torch.profiler and "
                         "print device time by kernel and the idle share")
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
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 2),
          "sources": sorted(f"pyaudiodsptools_tpu_torch/csrc/{n}.cu"
                            for n in paths),
          "ptxas": {n: [ln for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, log in _build.build_log.items()}})

    # ---- 3. small cases
    emit(conv_cases())
    emit(tail_cases())

    # ---- 4. main path: counts to 0, render at both block sizes, read counts
    C = CHANNELS
    n = int(SECONDS * SAMPLE_RATE)
    signal = burst_noise(C, n, args.seed)
    chains = {}
    for B in BLOCK_SIZES:
        cfg = pt.EngineConfig(SAMPLE_RATE, B)
        chains[B] = (cfg, pt.Chain(chain7_effects(cfg, "cuda"), device="cuda"))
        assert [e.name for e in chains[B][1].exec_effects] == [
            "fir_cascade:lowcut+highcut+eq3band_fft",
            "tail:saturator+delay+tremolo+softclipper"]
    torch.cuda.synchronize()

    segconv.launch_count = 0
    tail.launch_count = 0
    outputs = {}
    for B in BLOCK_SIZES:
        cfg, chain = chains[B]
        outputs[B] = pt.render(chain, signal, cfg)
        torch.cuda.synchronize()
    launches = {"segconv": segconv.launch_count, "tail": tail.launch_count}
    assert launches["segconv"] >= len(BLOCK_SIZES), launches
    assert launches["tail"] >= len(BLOCK_SIZES), launches

    main_checks = {}
    for B in BLOCK_SIZES:
        cfg, chain = chains[B]
        out = outputs[B]
        T = out.shape[-1]
        assert out.shape == (C, -(-n // B) * B) and out.dtype == torch.float32
        assert bool(torch.isfinite(out).all())
        plain = pt.render(chain, signal, cfg, use_kernels=False)
        torch.cuda.synchronize()
        db_plain = snr_db_cuda(plain, out)
        del plain
        pick = [0, C - 1]
        x2 = torch.nn.functional.pad(signal[pick], (0, T - n)).cpu().numpy()
        oracle = chain7_oracle(x2, chain.effects, B)
        db_oracle = snr_db(oracle, out[pick].cpu().numpy())
        main_checks[B] = {"db_plain": db_json(db_plain),
                          "db_oracle_2ch": db_json(db_oracle),
                          "peak": float(out.abs().max())}
        assert db_plain >= CHAIN_DB_PLAIN, main_checks
        assert db_oracle >= CHAIN_DB_ORACLE, main_checks
        assert 0.0 < main_checks[B]["peak"] <= 1.0
    assert (segconv.launch_count, tail.launch_count) == \
        (launches["segconv"], launches["tail"]), \
        "a plain-version render launched a kernel"
    emit({"phase": "main_path", "chain": "chain7", "channels": C,
          "seconds_of_audio": SECONDS, "samples_per_channel": n,
          "launches": launches,
          "by_block_size": {str(B): main_checks[B] for B in BLOCK_SIZES},
          "nvidia_smi": smi})
    outputs.clear()

    # ---- 5. the kernels at the main-path shapes
    summary = []
    conv_by_B, tail_by_B = {}, {}
    for B in BLOCK_SIZES:
        cfg, chain = chains[B]
        fir_e, tail_e = chain.exec_effects
        T = -(-n // B) * B
        x = torch.nn.functional.pad(signal, (0, T - n)).contiguous()
        plan = fir_e.params.plan

        # segmented conv
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
        n_pairs = C * -(-n_seg // 2)
        log2n = plan.n.bit_length() - 1
        flops = n_pairs * (2 * 5 * plan.n * log2n + 6 * plan.n)
        nbytes = 8 * C * T + 2 * 8 * plan.n
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        conv_by_B[B] = {
            "n": plan.n, "halo": plan.halo, "seg": plan.seg,
            "taps": plan.kernel_len, "shift": plan.shift, "C": C, "T": T,
            "db_plain": db_json(db_plain), "db_oracle_2ch": db_json(db_oracle),
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
            # what this design must move: the signal n/seg times in, once out
            "bound_with_window_overlap_ms":
                4 * C * T * (plan.n / plan.seg + 1) / HBM_BYTES_PER_S * 1e3,
        }

        # fused tail, fed what the conv stage feeds it
        members = tail_e.params
        stages, _, _, D = tail._plan_stages(chain.effects[3:])
        nb = T // B
        gains = torch.stack([gain_row(p, nb, B, x.device) for p in members
                             if isinstance(p, TremoloParams)])
        blocks = y_kernel.reshape(C, nb, B)
        t_kernel = tail.tail_kernel(stages, D, members, y_kernel, gains)
        t_plain = tail_e.offline(members, blocks, use_kernels=False
                                 ).reshape(C, T)
        torch.cuda.synchronize()
        t_err = float((t_kernel - t_plain).abs().max())
        t_db = snr_db_cuda(t_plain, t_kernel)
        assert t_db >= TAIL_DB_PLAIN, (B, t_db)
        del t_plain, t_kernel
        t_ms = time_ms(
            lambda: tail.tail_kernel(stages, D, members, y_kernel, gains))
        t_offline_ms = time_ms(lambda: tail_e.offline(members, blocks))
        t_plain_ms = time_ms(
            lambda: tail_e.offline(members, blocks, use_kernels=False))
        tb = (8 * C * T + 4 * gains.numel()) / HBM_BYTES_PER_S * 1e3
        to = C * T * tail_ops_per_sample(stages) / FP32_FLOP_PER_S * 1e3
        tail_by_B[B] = {
            "halo": D, "tile": tail.tile_for(T, D), "C": C, "T": T,
            "db_plain": db_json(t_db), "max_abs_err": t_err, "ms": t_ms,
            "offline_with_gain_row_ms": t_offline_ms, "plain_ms": t_plain_ms,
            "library_ms": None, "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "bound_bytes_ms": tb, "bound_operations_ms": to,
        }
        del x, y_kernel, blocks, gains
    emit({"phase": "kernel_timing", "nvidia_smi": smi,
          "segconv": {str(B): v for B, v in conv_by_B.items()},
          "tail": {str(B): v for B, v in tail_by_B.items()}})

    # ---- 6. throughput of the whole render: 3 chained passes, o = chain(o)
    rates = {}
    for B in BLOCK_SIZES:
        cfg, chain = chains[B]
        o = pt.render(chain, signal, cfg)              # warm-up
        torch.cuda.synchronize()
        total = o.numel()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            o = pt.render(chain, o, cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        assert bool(torch.isfinite(o).all())
        rates[str(B)] = {"samples_per_s": total / statistics.median(times),
                         "render_ms": statistics.median(times) * 1e3,
                         "samples": total}
    emit({"phase": "throughput", "chain": "chain7", "channels": C,
          "by_block_size": rates, "nvidia_smi": smi})

    if args.profile:
        emit({"phase": "profile", "chain": "chain7", "channels": C,
              "by_block_size": {
                  str(B): profile_renders(chains[B][1], signal, chains[B][0],
                                          rates[str(B)]["render_ms"])
                  for B in BLOCK_SIZES},
              "nvidia_smi": smi})

    # ---- 7. the kernels, one line; headline numbers at block size 4096
    head = BLOCK_SIZES[0]
    for name, source, replaces, by_B in (
            ("segconv", "pyaudiodsptools_tpu_torch/csrc/segconv.cu",
             "pyaudiodsptools_tpu/kernels/pallas_conv.py:926", conv_by_B),
            ("tail", "pyaudiodsptools_tpu_torch/csrc/tail.cu",
             "pyaudiodsptools_tpu/kernels/tail_pallas.py:281", tail_by_B)):
        h = by_B[head]
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(v["max_abs_err"] for v in by_B.values()),
            "ms": h["ms"], "plain_ms": h["plain_ms"],
            "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
            "library_ms": h["library_ms"],
            "by_block_size": {str(B): {k: v[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
                for B, v in by_B.items()}})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
