"""The benchmark's configuration ``reverb1500`` (``portbench/configs/
reverb1500.json``: compressor -> gate -> reverb(1500 ms), the dialogue
reverb return) on the port: the chain at the configuration's test size
through ``render`` on the CPU against the benchmark's plain reference under
the cell's limits; the reference's reverb against upstream's chunk loop
written out in NumPy; the chain's fused execution and the reverb's
partitions; the cell's partition roofline reader; the partitions' stage
marks. The ``cuda`` test needs no JAX (``--noconftest -m cuda``)."""

import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import check, port, roofline, signals, spec  # noqa: E402
from portbench import reference as ref  # noqa: E402
from portbench.record import Run  # noqa: E402

import pyaudiodsptools_tpu_torch as pt  # noqa: E402
from pyaudiodsptools_tpu_torch import profiling  # noqa: E402
from pyaudiodsptools_tpu_torch.kernels import segconv  # noqa: E402
from pyaudiodsptools_tpu_torch.ops import fft_filter  # noqa: E402

CELL = "reverb1500.offline"
H100 = "NVIDIA H100 80GB HBM3"
# the reverb's stripped kernel at B=4096 and its partitions
TAPS = 66825
PARTS = [16385] * 4 + [1285]
# the compressor and the gate fused into one walk
DYNAMICS = "dynamics_cascade:compressor+gate"


def config(small: bool = True) -> dict:
    with open(spec.config_path("reverb1500")) as f:
        c = json.load(f)
    return {**c, **c["test_size"]} if small else c


def limits() -> dict:
    with open(spec.limits_path(CELL)) as f:
        return json.load(f)


def traffic() -> dict:
    with open(spec.traffic_path("offline")) as f:
        return json.load(f)


@pytest.mark.parametrize("B", [4096, 512])
def test_the_chain_at_its_test_size_agrees_with_the_reference(B):
    c = config()
    C, sr = c["channels"], c["sample_rate"]
    n = int(c["length_s"] * sr)
    chain, cfg = port.chain(c, B, "cpu")
    x = signals.make(traffic()["signal"], C, n, sr, 3000000017 + B, "cpu")
    got = pt.render(chain, x, cfg).reshape(C, -1)[:, :n]
    pad = torch.nn.functional.pad(x, (0, -(-n // B) * B - n))
    want = check.reference(c, pad, B)[:, :n]
    numbers = check.numbers([check.rel_errs(got, want)])
    for name, lim in limits().items():
        assert numbers[name] <= lim["limit"], (name, numbers)


def upstream_reverb(x: np.ndarray, sr: int, B: int,
                    time_in_ms: float = 1500.0) -> np.ndarray:
    """``_EffectReverb.py`` chunk by chunk in float64: two lines, each the
    upstream FFT filter's high-cut (a window of three chunks, overlap-save,
    its output one chunk late) and a delay buffer that every chunk adds
    ``loops - 1`` scaled copies into and shifts on by a chunk; the lines'
    buffer heads summed, wet only."""
    C, T = x.shape
    fl = B // 2 - 1
    reverb_samples = int(time_in_ms / 1000 * sr)
    lines = []
    for loops, hz in ((100, 5000.0), (50, 150.0)):
        m = np.arange(fl)
        h = np.sinc(2 * hz / sr * (m - (fl - 1) / 2)) * np.blackman(fl)
        h /= np.sum(h)
        time = reverb_samples // loops
        lines.append({"H": np.fft.rfft(h, 3 * B), "time": time,
                      "ramp": np.linspace(0.3, 0.01, loops), "loops": loops,
                      "window": np.zeros((C, 3 * B)),
                      "buffer": np.zeros((C, time * loops + B))})
    out = []
    for i in range(T // B):
        chunk = x[:, i * B:(i + 1) * B]
        y = np.zeros((C, B))
        for ln in lines:
            ln["window"] = np.concatenate([ln["window"][:, B:], chunk], 1)
            f = np.fft.irfft(np.fft.rfft(ln["window"]) * ln["H"], 3 * B)[
                :, B + fl // 2:2 * B + fl // 2]
            for k in range(ln["loops"] - 1):
                o = ln["time"] * (k + 1)
                ln["buffer"][:, o:o + B] += f * ln["ramp"][k]
            y += ln["buffer"][:, :B]
            ln["buffer"] = np.concatenate(
                [ln["buffer"][:, B:], np.zeros((C, B))], 1)
        out.append(y)
    return np.concatenate(out, 1)


def test_the_reference_reverb_equals_upstreams_chunk_loop():
    sr, B = 44100, 512
    T = (4 * sr // B) * B
    x = np.random.default_rng(19).standard_normal((2, T)) * 0.3
    want = upstream_reverb(x, sr, B)
    ctx = ref.make_ctx(sr, B)
    got = ref.load_op("reverb").apply(torch.from_numpy(x), ctx, 1500.0)
    assert got.dtype == torch.float64
    assert check.rel_err(got, torch.from_numpy(want)) < 1e-10
    # the tail reaches past the signal's first 1.5 s
    assert np.abs(want[:, 66000:]).max() > 0


def test_the_chain_fuses_into_the_fixpoint_and_the_partitioned_reverb():
    chain, _ = port.chain(config(small=False), 4096, "cpu")
    assert [e.name for e in chain.exec_effects] == [DYNAMICS, "reverb"]
    full = chain.exec_effects[1].params.full
    assert full.kernel_len == TAPS
    assert [p[1] for p in fft_filter.plan_partitions(TAPS)] == PARTS
    assert [p.kernel_len for p in full.plans] == PARTS
    ctx = ref.make_ctx(44100, 4096)
    k = ref.load_op("reverb").kernel(ctx, 1500.0)
    assert len(k) - int(np.flatnonzero(k)[0]) == TAPS


def conv_bytes_flops(C, T, n, seg):
    """The frozen conv cost written out: the signal read and written, the
    spectrum and twiddles (8 n bytes each); the windows in pairs, each
    pair a forward and an inverse n-point transform and a product."""
    pairs = -(-(-(-T // seg)) // 2)
    lg = n.bit_length() - 1
    return 8 * C * T + 16 * n, C * pairs * (10 * n * lg + 6 * n)


def test_the_partition_roofline_reader_counts_by_hand():
    reader = spec.reader("kernel.segconv_parts.roofline_pct")
    partitions = reader.__globals__["partitions"]
    assert partitions(TAPS) == PARTS
    assert partitions(8185) == [8185]
    C, T = 2, 100 * 4096
    hbm, fp32 = roofline.PEAKS[H100]
    full_b, full_f = conv_bytes_flops(C, T, 32768, 16384)
    last_b, last_f = conv_bytes_flops(C, T, 16384, 16384 - 1408)
    job = max(full_b / hbm, full_f / fp32) \
        + 3 * max((full_b + 4 * C * T) / hbm, full_f / fp32) \
        + max((last_b + 4 * C * T) / hbm, last_f / fp32)
    geometry = {"C": C, "T": T, "n": T, "B": 4096}

    def rec(launches):
        return Run(CELL, "offline", device_name=H100, geometry=geometry,
                   traced_units=2, profile={"by_name": {
                       "segconv_kernel": [launches, 0.5]}})

    assert reader(rec(10)) == pytest.approx(100.0 * 2 * job / 0.5,
                                            rel=1e-12)
    assert reader(rec(7)) is None
    assert reader(Run(CELL, "offline", geometry=geometry)) is None


def test_partition_marks_only_inside_a_traced_stage(monkeypatch):
    marked = []
    monkeypatch.setattr(profiling, "mark", lambda device=None:
                        marked.append(device))
    profiling.part("cpu")
    assert marked == []
    with profiling.stage_parts() as parts:
        profiling.part("cpu")
        with profiling.stage_parts(False) as inner:
            profiling.part("cpu")
        profiling.part("cpu")
    assert len(parts) == 2 and inner == [] and len(marked) == 2
    profiling.part("cpu")
    assert len(marked) == 2
    assert profiling.stage_names("reverb", 0) == ["reverb"]
    assert profiling.stage_names("reverb", 4) == [
        f"reverb.part{i}" for i in range(5)]


def test_the_plain_partitions_mark_nothing(monkeypatch):
    """On a CPU tensor the partitions are the plain version: no launch, no
    mark, no count."""
    monkeypatch.setattr(profiling, "mark", lambda device=None: 1 / 0)
    rev = importlib.import_module("pyaudiodsptools_tpu_torch.ops.reverb")
    eff = pt.ops.reverb(pt.EngineConfig(44100, 4096), device="cpu")
    before = (segconv.launch_count, segconv.accumulate_launch_count)
    x = torch.zeros(1, 20, 4096)
    with profiling.stage_parts() as parts:
        rev.offline_fir(eff.params, x)
    assert parts == []
    assert (segconv.launch_count, segconv.accumulate_launch_count) == before


@pytest.mark.cuda
def test_cuda_traced_reverb_render_marks_its_partitions_on_card():
    """With tracing on, the captured render of the configuration's chain
    names the reverb's five partitions as stages; a replay adds 5 to the
    conv's launches and 4 to its accumulate launches; the replay is
    bit-equal to the eager ``render_blocks``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    c = config()
    C, sr, B = c["channels"], c["sample_rate"], 4096
    n = int(c["length_s"] * sr)
    x = signals.make(traffic()["signal"], C, n, sr, 2147483659, "cuda")
    blocks = pt.block.make_blocks(x, B)
    was = profiling.enabled()
    profiling.enable()
    try:
        chain, _ = port.chain(c, B, "cuda")
        captured = chain.captured_render()
        captured.capture(tuple(blocks.shape))
    finally:
        profiling.enable(was)
    shape = tuple(blocks.shape)
    assert captured.stages(shape) == [DYNAMICS] + [
        f"reverb.part{i}" for i in range(5)]
    launches = captured.launches_per_replay(shape)
    assert launches["segconv.launch_count"] == 5
    assert launches["segconv.accumulate_launch_count"] == 4
    before = (segconv.launch_count, segconv.accumulate_launch_count)
    got = captured(blocks)
    torch.cuda.synchronize()
    assert (segconv.launch_count - before[0],
            segconv.accumulate_launch_count - before[1]) == (5, 4)
    want = chain.render_blocks(blocks)
    assert torch.equal(got, want)
    untraced, _ = port.chain(c, B, "cuda")
    plain = untraced.captured_render()
    plain.capture(shape)
    assert plain.stages(shape) == []
    assert plain.launches_per_replay(shape) == launches
    assert torch.equal(plain(blocks), want)
    captured.release()
    plain.release()
