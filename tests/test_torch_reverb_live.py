"""The benchmark's configuration ``reverb_live`` (``portbench/configs/
reverb_live.json``: compressor -> gate -> lowcut(160) -> reverb(1500 ms),
a live desk's reverb send) on the port's streaming path: ``Chain.step``
folded over the configuration's test size on the CPU against the
benchmark's plain float64 reference under the cell's limits, and against
the JAX package's chain step; the bfloat16 control against the same
limits; the fused FIR's stream plan, exactly: a frequency-domain delay line
of 131 partitions of 512 taps, the lead's two left out. The ``cuda`` test
imports no JAX (``--noconftest -m cuda`` on the card's machine): the
captured step's one convpairs launch a replay, through the delay line, and
its traced stages."""

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import check, port, signals, spec  # noqa: E402

from pyaudiodsptools_tpu_torch import profiling  # noqa: E402
from pyaudiodsptools_tpu_torch.kernels import convpairs  # noqa: E402

CELL = "reverb_live.stream512_pauses"
B = 512
SEED = 3000000019
# the compressor and the gate fused into one walk, the send's high-pass and
# the reverb into one FIR
DYNAMICS = "dynamics_cascade:compressor+gate"
FIR = "fir_cascade:lowcut+reverb"
TAPS, LEAD = 65287, 1431
# the delay line: windows of 1,024, (1,431 + 65,287) / 512 -> 131
# partitions, the first two (the lead's) zero
WINDOW, SLOTS, USED = 1024, 131, 129


def config() -> dict:
    with open(spec.config_path("reverb_live")) as f:
        c = json.load(f)
    return {**c, **c["test_size"]}


def limits() -> dict:
    with open(spec.limits_path(CELL)) as f:
        return json.load(f)


def signal() -> np.ndarray:
    """The cell's bursts and pauses at the test size, whole blocks."""
    c = config()
    with open(spec.traffic_path("stream512_pauses")) as f:
        kind = json.load(f)["signal"]
    n = int(c["length_s"] * c["sample_rate"]) // B * B
    return signals.make(kind, c["channels"], n, c["sample_rate"], SEED,
                        "cpu").numpy()


def fold(step, state, x: np.ndarray, to_block, to_numpy) -> np.ndarray:
    """``step`` over the blocks of ``x``, the state carried."""
    out = []
    for i in range(x.shape[1] // B):
        state, y = step(state, to_block(x[:, i * B:(i + 1) * B]))
        out.append(to_numpy(y))
    return np.concatenate(out, -1)


@functools.lru_cache(maxsize=None)
def port_stream() -> np.ndarray:
    """The port's ``Chain.step`` over the test signal, on the CPU."""
    chain, _ = port.chain(config(), B, "cpu")
    x = signal()
    return fold(chain.step, chain.init_state((x.shape[0],)), x,
                torch.from_numpy, lambda y: y.numpy())


@functools.lru_cache(maxsize=None)
def reference(precision: str) -> torch.Tensor:
    return check.reference(config(), torch.from_numpy(signal()), B,
                           precision)


def test_the_stream_at_its_test_size_agrees_with_the_reference():
    """Every sample of every channel under the cell's limits, the numbers
    the chip's runs compare: set from the program's runs on the card and
    the bfloat16 control, they also hold the CPU's plain float32 path."""
    got = torch.from_numpy(port_stream())
    want = reference("float64")
    assert float(want.abs().max()) > 1e-3          # the return is not silent
    numbers = check.numbers([check.rel_errs(got, want)])
    for name, lim in limits().items():
        assert numbers[name] <= lim["limit"], (name, numbers)


def test_the_bfloat16_control_fails_the_cells_limits():
    """The reference computed in bfloat16, the precision below the
    configuration's float32, exceeds both limits: the limits tell a lower
    precision from a sound run."""
    want = reference("float64")
    numbers = check.numbers([check.rel_errs(reference("bfloat16"), want)])
    for name, lim in limits().items():
        assert numbers[name] > lim["limit"], (name, numbers)


def test_the_stream_agrees_with_the_jax_chain_step():
    """The JAX package's ``Chain.step`` over the same blocks: >= 90 dB, the
    JAX package's bar for its kernel-backed chains (the dynamics come first
    and see the same input; the two FIRs differ in their windows, so in the
    last bits)."""
    import jax.numpy as jnp

    import pyaudiodsptools_tpu as jx
    from torch_port_util import snr_db

    cfg = jx.EngineConfig(44100, B)
    chain = jx.Chain([jx.ops.compressor(cfg, -18.0, 0.6, 3.1, 30.1),
                      jx.ops.gate(cfg, -45.0, 0.1, 3.1, 200.1),
                      jx.ops.lowcut(cfg, 160.0),
                      jx.ops.reverb(cfg, 1500.0)])
    x = signal()
    want = fold(chain.step, chain.init_state((x.shape[0],)), x,
                jnp.asarray, np.asarray)
    assert snr_db(want, port_stream()) >= 90.0


def test_the_chain_fuses_the_send_into_one_fir_in_two_parts():
    """The compressor and the gate one walk, the high-pass and the reverb
    one FIR of 65,287 stripped taps behind a lead of 1,431, streamed through
    the frequency-domain delay line: windows of 1,024, the kernel with its
    lead in 131 partitions of 512 taps, the first two (all lead) left out;
    the state a ring of 131 spectra of 2 row pairs, the last 2 blocks of
    input and a position; no partitions in convpairs windows, no history."""
    chain, _ = port.chain(config(), B, "cpu")
    assert [e.name for e in chain.exec_effects] == [DYNAMICS, FIR]
    fir = chain.exec_effects[1].params
    assert (fir.kernel_len, fir.lead, fir.history) == (TAPS, LEAD, 0)
    assert fir.parts == ()
    line = fir.spectral
    assert (line.n, line.block, line.slots, line.inputs,
            line.kernel_len) == (WINDOW, B, SLOTS, 2, LEAD + TAPS)
    assert line.delays == tuple(range(SLOTS - USED, SLOTS))
    assert tuple(line.spectra.shape) == (USED, WINDOW, 2)
    state = chain.init_state((4,))
    assert sorted(state[1]) == ["input", "pos", "ring"]
    assert state[1]["ring"].shape == (SLOTS, 2, WINDOW, 2)
    assert state[1]["input"].shape == (4, 2, B)
    assert state[1]["pos"].shape == () \
        and state[1]["pos"].dtype == torch.int32


def test_the_plain_streamed_parts_mark_and_count_nothing(monkeypatch):
    """On a CPU tensor the delay line is the plain version: no launch, no
    count, no mark, even inside a traced stage."""
    monkeypatch.setattr(profiling, "mark", lambda device=None: 1 / 0)
    chain, _ = port.chain(config(), B, "cpu")
    fir = chain.exec_effects[1]
    before = (convpairs.launch_count, convpairs.accumulate_launch_count,
              convpairs.spectral_launch_count)
    with profiling.stage_parts() as parts:
        fir.step(fir.params, fir.state((2,)), torch.zeros(2, B))
    assert parts == []
    assert (convpairs.launch_count, convpairs.accumulate_launch_count,
            convpairs.spectral_launch_count) == before


@pytest.mark.cuda
def test_cuda_captured_step_streams_the_fir_in_one_launch():
    """On the card a replay of the configuration's captured step makes one
    convpairs launch, through the delay line, none accumulating, and one
    serial walk; captured with tracing on, its stages name the FIR as one
    stage; with tracing off it holds no mark and the same launches; both
    replays equal the eager ``Chain.step`` bit for bit, the delay line's
    rings advancing in the graph's own buffers; its state round-trips
    through ``state`` / ``load_state``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    c = config()
    x = torch.from_numpy(signal()[:, :8 * B]).cuda()
    was = profiling.enabled()
    profiling.enable()
    try:
        chain, _ = port.chain(c, B, "cuda")
        traced = chain.captured_step((c["channels"],))
        traced.capture(tuple(x[:, :B].shape))
    finally:
        profiling.enable(was)
    shape = (c["channels"], B)
    assert traced.stages(shape) == [DYNAMICS, FIR, "write_state"]
    launches = traced.launches_per_step(shape)
    assert launches == {"convpairs.launch_count": 1,
                        "convpairs.spectral_launch_count": 1,
                        "dynamics.serial_walk_launch_count": 1}
    untraced_chain, _ = port.chain(c, B, "cuda")
    untraced = untraced_chain.captured_step((c["channels"],))
    untraced.capture(shape)
    assert untraced.stages(shape) == []
    assert untraced.launches_per_step(shape) == launches

    state = chain.init_state((c["channels"],))
    before = (convpairs.launch_count, convpairs.accumulate_launch_count,
              convpairs.spectral_launch_count)
    for i in range(8):
        blk = x[:, i * B:(i + 1) * B]
        state, want = chain.step(state, blk)
        for step in (traced, untraced):
            got = step(blk)
            assert torch.equal(got, want), i
    torch.cuda.synchronize()
    # 8 blocks, each an eager step and two replays, each of them one
    # launch through the delay line
    assert (convpairs.launch_count - before[0],
            convpairs.accumulate_launch_count - before[1],
            convpairs.spectral_launch_count - before[2]) == (24, 0, 24)
    # the graph's buffers hold the eager state; loaded back after a detour,
    # the replay goes on as the eager step
    kept = untraced.state
    for k in ("input", "pos", "ring"):
        assert torch.equal(kept[1][k], state[1][k]), k
    untraced.reset()
    untraced(x[:, :B])
    untraced.load_state(kept)
    blk = x[:, 3 * B:4 * B]
    _, want = chain.step(state, blk)
    assert torch.equal(untraced(blk), want)
