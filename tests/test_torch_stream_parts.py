"""PyTorch/CUDA port: a FIR longer than one streaming window
(``ops/fft_filter.fir``'s routes past one window).

Where the stripped kernel and the block outgrow the streaming kernel's
largest window and a window of twice the block fits it, the step streams
the kernel through a frequency-domain delay line
(``kernels/convpairs.spectral_step``, one launch a step); where even that
does not fit (B past half the window), it cuts the kernel into partitions
and the block into sub-blocks (``plan_stream``, ``convpairs.stream_step``),
one window and one launch each, the later partitions adding into the output
in order, all reading one shared history. Here the largest window is shrunk
so that both routes show at small sizes: each is held to a float64 oracle,
to the one-window stream of the same kernel, and to a numpy mirror of its
launches (``torch_port_util.emulate_stream_step``,
``emulate_spectral_step``); on a card (``cuda`` marker) the partitions are
held to their mirror bit for bit and the delay line to its plain version
within rounding, and the windows that streamed in one launch before keep
their version, their launch count and their bits."""

import numpy as np
import pytest
import torch

from pyaudiodsptools_tpu_torch.kernels import convpairs
from pyaudiodsptools_tpu_torch.ops import fft_filter as pt_fir

from torch_port_util import (conv_oracle, emulate_spectral_step,
                             emulate_stream_step, snr_db)

CPU = "cpu"


def _kernel(taps: int, lead: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    k = rng.standard_normal(taps) * np.exp(-np.arange(taps) / (taps / 3.0))
    return np.r_[np.zeros(lead), 0.1 * k]


def _fold(effect, x: np.ndarray, B: int, step=None):
    """The effect's step over the blocks of x (C, nb*B), state carried."""
    step = step or effect.step
    st = effect.state((x.shape[0],))
    outs = []
    for i in range(x.shape[1] // B):
        st, y = step(effect.params, st, torch.from_numpy(x[:, i * B:(i + 1) * B]))
        outs.append(y.numpy())
    return np.concatenate(outs, -1), st


# (window cap, taps, lead, B): through the delay line at a whole block (B
# within half the cap); partitions and sub-blocks (B past half the cap);
# the delay line with its last partition one tap; a block that is not a
# multiple of its sub-block
SMALL = [(256, 600, 5, 64), (256, 300, 0, 200), (256, 194, 9, 64),
         (512, 900, 3, 333)]


@pytest.mark.parametrize("cap,taps,lead,B", SMALL)
def test_partitioned_stream_matches_oracle_and_one_window(cap, taps, lead, B,
                                                          monkeypatch):
    kernel = _kernel(taps, lead, seed=taps + B)
    whole = pt_fir.fir(kernel, B, device=CPU)
    assert len(whole.params.parts) == 1 and whole.params.spectral is None
    monkeypatch.setattr(pt_fir, "STREAM_WINDOW", cap)
    parted = pt_fir.fir(kernel, B, device=CPU)
    parts = parted.params.parts
    line = parted.params.spectral
    # the delay line where a window of 2 B fits the cap, else partitions
    assert (line is not None) == (2 * B <= cap)
    if line is not None:
        assert parts == () and line.n == 2 * B and line.block == B
        assert line.slots == -(-(lead + taps) // B)
        assert line.delays == tuple(range(lead // B, line.slots))
    else:
        assert len(parts) > 1
        assert all(p.plan.n <= cap for p in parts)
        # every output sample is written once, then added to by each later
        # partition, in order
        cover = np.zeros(B, int)
        for p in parts:
            seg = cover[p.out0:p.out0 + p.keep]
            assert (seg > 0).all() if p.add else (seg == 0).all()
            seg += 1
        assert (cover == cover[0]).all()
    nb = -(-(lead + taps + 3 * B) // B)
    x = np.random.default_rng(B).standard_normal((3, nb * B)).astype(
        np.float32)
    got, st = _fold(parted, x, B)
    one, _ = _fold(whole, x, B)
    if line is not None:
        assert st["ring"].shape == (line.slots, 2, line.n, 2)
        assert st["input"].shape == (3, line.inputs, B)
        assert int(st["pos"]) == nb % line.period
    else:
        assert st["hist"].shape == (3, parted.params.history)
    assert snr_db(conv_oracle(x, kernel), got) >= 120.0
    assert snr_db(one, got) >= 120.0
    assert convpairs.launch_count == 0           # no kernel for a CPU tensor


@pytest.mark.parametrize("cap,taps,lead,B", SMALL)
def test_numpy_mirror_of_the_partitioned_schedule(cap, taps, lead, B,
                                                  monkeypatch):
    """The launches walked in numpy (each window gathered by the sample
    index from the shared history and the block, the window transform's
    mirror, kept samples written or added in float32): >= 110 dB to the
    plain version, the next history equal, over three steps. Through the
    delay line, its one launch walked in numpy: >= 110 dB to the plain
    version in the output and the ring, the input ring and the position
    equal."""
    monkeypatch.setattr(pt_fir, "STREAM_WINDOW", cap)
    eff = pt_fir.fir(_kernel(taps, lead, seed=taps), B, device=CPU)
    rng = np.random.default_rng(taps * B)
    line = eff.params.spectral
    if line is not None:
        st = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(
            np.float32)) for k, v in eff.state((3,)).items() if k != "pos"}
        st["pos"] = torch.tensor(line.period - 2, dtype=torch.int32)
        for _ in range(3):
            block = rng.standard_normal((3, B)).astype(np.float32)
            out, ring, inputs, pos = emulate_spectral_step(
                st["ring"].numpy(), st["input"].numpy(), int(st["pos"]),
                block, line)
            st, want = eff.step(eff.params, st, torch.from_numpy(block))
            assert np.isfinite(out).all()
            assert snr_db(want.numpy(), out) >= 110.0
            assert snr_db(st["ring"].numpy(), ring) >= 110.0
            np.testing.assert_array_equal(st["input"].numpy(), inputs)
            assert int(st["pos"]) == pos
        return
    hist = rng.standard_normal((3, eff.params.history)).astype(np.float32)
    for _ in range(3):
        block = rng.standard_normal((3, B)).astype(np.float32)
        out, nxt = emulate_stream_step(hist, block, eff.params.parts)
        want, want_hist = convpairs.stream_step(
            torch.from_numpy(hist), torch.from_numpy(block), eff.params.parts)
        assert np.isfinite(out).all()
        assert snr_db(want.numpy(), out) >= 110.0
        np.testing.assert_array_equal(nxt, want_hist.numpy())
        hist = nxt


@pytest.mark.parametrize("taps,B,launches", [
    (1017, 512, 1), (65025, 512, 1), (65026, 512, 2), (65033, 512, 2),
    (65000, 4096, 2), (40000, 4096, 1), (65529, 32768, 2), (8191, 16384, 1),
    (32767, 65536, 2), (3, 131072, 3)])
def test_stream_planner_invariants(taps, B, launches):
    sub, pieces = pt_fir.plan_stream(taps, B)
    assert len(pieces) * -(-B // sub) == launches
    assert sum(t for _, t, _ in pieces) == taps
    assert [o for o, _, _ in pieces] == list(
        np.cumsum([0] + [t for _, t, _ in pieces[:-1]]))
    for _, t, n in pieces:
        assert n & (n - 1) == 0 and n <= pt_fir.STREAM_WINDOW
        assert t - 1 + sub <= n                  # wrap-free
    if launches == 1:
        assert pieces == [(0, taps, pt_fir.stream_window(taps, B))]


def test_step_refuses_parts_that_do_not_fit():
    eff = pt_fir.fir(_kernel(50, 3, seed=1), 64, device=CPU)
    (part,) = eff.params.parts
    hist = torch.zeros(2, eff.params.history)
    block = torch.zeros(2, 64)
    bad = convpairs.StreamPart(part.plan, 1, 0, 64, False)
    with pytest.raises(ValueError, match="starts at the history"):
        convpairs.stream_step(hist, block, (bad,))
    late = convpairs.StreamPart(part.plan, eff.params.history + 64, 0, 64,
                                False)
    with pytest.raises(ValueError, match="does not fit"):
        convpairs.stream_step(hist, block, (part, late))


# ---------------------------------------------------------------------------
# on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("taps,B,rows,lead", [
    # one partition in two sub-blocks: nothing adds
    (32767, 65536, 8, 37),
    # two partitions, each in two sub-blocks: the second partition's
    # launches add into the output
    (65000, 65536, 8, 37)])
def test_cuda_partitioned_step_bit_equal_to_its_schedule(taps, B, rows, lead):
    """Each part one launch, in order, the later partitions adding: bit for
    bit the mirror's schedule with each window convolved by the card's own
    ``conv_pairs`` (known bit-equal to the step's kernel on one window), and
    within rounding of the plain version. A block past half the largest
    window takes this route: a window of twice the block would not fit."""
    _card()
    eff = pt_fir.fir(_kernel(taps, lead, seed=taps), B, device="cuda")
    assert eff.params.spectral is None
    parts = eff.params.parts
    assert len(parts) > 1
    adding = sum(p.add for p in parts)
    assert (adding > 0) == (taps == 65000)
    rng = np.random.default_rng(B)
    hist = rng.standard_normal((rows, eff.params.history)).astype(np.float32)
    block = rng.standard_normal((rows, B)).astype(np.float32)

    def on_card(window, plan):
        return convpairs.conv_pairs(torch.from_numpy(window).cuda(),
                                    plan).cpu().numpy()

    want, want_hist = emulate_stream_step(hist, block, parts, on_card)
    before = (convpairs.launch_count, convpairs.accumulate_launch_count)
    out, new_hist = convpairs.stream_step(torch.from_numpy(hist).cuda(),
                                          torch.from_numpy(block).cuda(),
                                          parts)
    torch.cuda.synchronize()
    assert (convpairs.launch_count - before[0],
            convpairs.accumulate_launch_count - before[1]) \
        == (len(parts), adding)
    np.testing.assert_array_equal(out.cpu().numpy(), want)
    np.testing.assert_array_equal(new_hist.cpu().numpy(), want_hist)
    plain, _ = convpairs.stream_step(torch.from_numpy(hist).cuda(),
                                     torch.from_numpy(block).cuda(), parts,
                                     use_kernels=False)
    assert snr_db(plain.cpu().numpy(), out.cpu().numpy()) >= 110.0


@pytest.mark.cuda
@pytest.mark.parametrize("taps,B,rows,lead", [
    (65000, 4096, 8, 37), (65033, 512, 8, 37),
    # windows of 65,536 over a cluster of four, each block summing its part
    (65529, 32768, 8, 37),
    # the benchmark's reverb_live send: 131 partitions of 512 through the
    # delay line (two of them the lead's zeros), a window of 1,024 in one
    # block, four blocks summing beside it
    (65287, 512, 64, 1431)])
def test_cuda_delay_line_step_matches_the_plain_version(taps, B, rows, lead):
    """Through the delay line (B within half the largest window): one
    launch a step, the rings advanced in place, the output and the ring
    within rounding of the plain version on the CPU, the input ring and the
    position equal, over three steps from a random state."""
    _card()
    eff = pt_fir.fir(_kernel(taps, lead, seed=taps), B, device="cuda")
    line = eff.params.spectral
    assert line is not None and eff.params.parts == ()
    cpu = pt_fir.fir(eff.lti_kernel, B, device=CPU)
    rng = np.random.default_rng(line.slots)
    st = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(
        np.float32)).cuda() for k, v in eff.state((rows,)).items()
        if k != "pos"}
    st["pos"] = torch.tensor(line.period - 2, dtype=torch.int32,
                             device="cuda")
    want_st = {k: v.cpu() for k, v in st.items()}
    for _ in range(3):
        block = torch.from_numpy(rng.standard_normal((rows, B)).astype(
            np.float32))
        before = (convpairs.launch_count, convpairs.spectral_launch_count)
        given = st
        st, out = eff.step(eff.params, given, block.cuda())
        torch.cuda.synchronize()
        assert (convpairs.launch_count - before[0],
                convpairs.spectral_launch_count - before[1]) == (1, 1)
        assert st["ring"] is given["ring"] and st["input"] is given["input"]
        want_st, want = cpu.step(cpu.params, want_st, block)
        assert snr_db(want.numpy(), out.cpu().numpy()) >= 110.0
        assert snr_db(want_st["ring"].numpy(),
                      st["ring"].cpu().numpy()) >= 110.0
        assert torch.equal(want_st["input"], st["input"].cpu())
        assert int(want_st["pos"]) == int(st["pos"])
        want_st = {k: v.cpu() for k, v in st.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("taps,B", [(1017, 512), (8185, 4096), (8191, 16384),
                                    (32761, 16384), (8185, 512)])
def test_cuda_one_window_streams_keep_version_launches_and_bits(taps, B):
    """The windows that streamed in one launch before partitions came keep
    one part, one launch a step, and in every version of their window the
    bits of ``conv_pairs`` on the joined window."""
    _card()
    eff = pt_fir.fir(_kernel(taps, 37, seed=taps), B, device="cuda")
    (part,) = eff.params.parts
    plan = part.plan
    rng = np.random.default_rng(taps)
    hist = torch.from_numpy(rng.standard_normal(
        (64, eff.params.history)).astype(np.float32)).cuda()
    block = torch.from_numpy(rng.standard_normal((64, B)).astype(
        np.float32)).cuda()
    joined = torch.cat([hist, block], -1)
    want = convpairs.conv_pairs(joined[:, :plan.n].contiguous(),
                                plan)[:, plan.n - B:]
    before = convpairs.launch_count
    st, out = eff.step(eff.params, {"hist": hist}, block)
    torch.cuda.synchronize()
    assert convpairs.launch_count == before + 1
    assert torch.equal(out, want)
    assert torch.equal(st["hist"], joined[:, B:])
    for b in convpairs.versions(plan.n):
        got, _ = convpairs._launch_step(hist, block, plan, b)
        assert torch.equal(got, want), b
