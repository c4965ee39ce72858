"""PyTorch/CUDA port: a FIR streamed in partitions (``ops/fft_filter.
plan_stream``, ``kernels/convpairs.stream_step``).

Where the stripped kernel and the block outgrow the streaming kernel's
largest window, the step cuts the kernel into partitions (and, past
B = 32,768, the block into sub-blocks), one window and one launch each, the
later partitions adding into the output in order, all reading one shared
history. Here the largest window is shrunk so that the schedule shows at
small sizes: the partitioned stream is held to a float64 oracle, to the
one-window stream of the same kernel, and to a numpy mirror of its launches
(``torch_port_util.emulate_stream_step``); on a card (``cuda`` marker) the
kernel is held to that mirror bit for bit, and the windows that streamed in
one launch before keep their version, their launch count and their bits."""

import numpy as np
import pytest
import torch

from pyaudiodsptools_tpu_torch.kernels import convpairs
from pyaudiodsptools_tpu_torch.ops import fft_filter as pt_fir

from torch_port_util import conv_oracle, emulate_stream_step, snr_db

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


# (window cap, taps, lead, B): partitions at a whole block; partitions and
# sub-blocks (B past half the cap); a last partition of one tap; a block
# that is not a multiple of its sub-block
SMALL = [(256, 600, 5, 64), (256, 300, 0, 200), (256, 194, 9, 64),
         (512, 900, 3, 333)]


@pytest.mark.parametrize("cap,taps,lead,B", SMALL)
def test_partitioned_stream_matches_oracle_and_one_window(cap, taps, lead, B,
                                                          monkeypatch):
    kernel = _kernel(taps, lead, seed=taps + B)
    whole = pt_fir.fir(kernel, B, device=CPU)
    assert len(whole.params.parts) == 1
    monkeypatch.setattr(pt_fir, "STREAM_WINDOW", cap)
    parted = pt_fir.fir(kernel, B, device=CPU)
    parts = parted.params.parts
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
    plain version, the next history equal, over three steps."""
    monkeypatch.setattr(pt_fir, "STREAM_WINDOW", cap)
    eff = pt_fir.fir(_kernel(taps, lead, seed=taps), B, device=CPU)
    rng = np.random.default_rng(taps * B)
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
    (65000, 4096, 8, 37), (65033, 512, 8, 37), (32767, 65536, 8, 37),
    (65529, 32768, 8, 37),
    # the benchmark's reverb_live send: 65,536 over a cluster of four,
    # then the accumulating 1,024 window that writes the history
    (65287, 512, 64, 1431)])
def test_cuda_partitioned_step_bit_equal_to_its_schedule(taps, B, rows, lead):
    """Each part one launch, in order, the later partitions adding: bit for
    bit the mirror's schedule with each window convolved by the card's own
    ``conv_pairs`` (known bit-equal to the step's kernel on one window)."""
    _card()
    eff = pt_fir.fir(_kernel(taps, lead, seed=taps), B, device="cuda")
    parts = eff.params.parts
    assert len(parts) > 1
    rng = np.random.default_rng(B)
    hist = rng.standard_normal((rows, eff.params.history)).astype(np.float32)
    block = rng.standard_normal((rows, B)).astype(np.float32)

    def on_card(window, plan):
        return convpairs.conv_pairs(torch.from_numpy(window).cuda(),
                                    plan).cpu().numpy()

    want, want_hist = emulate_stream_step(hist, block, parts, on_card)
    before = convpairs.launch_count
    out, new_hist = convpairs.stream_step(torch.from_numpy(hist).cuda(),
                                          torch.from_numpy(block).cuda(),
                                          parts)
    torch.cuda.synchronize()
    assert convpairs.launch_count == before + len(parts)
    np.testing.assert_array_equal(out.cpu().numpy(), want)
    np.testing.assert_array_equal(new_hist.cpu().numpy(), want_hist)
    plain, _ = convpairs.stream_step(torch.from_numpy(hist).cuda(),
                                     torch.from_numpy(block).cuda(), parts,
                                     use_kernels=False)
    assert snr_db(plain.cpu().numpy(), out.cpu().numpy()) >= 110.0


@pytest.mark.cuda
@pytest.mark.parametrize("taps,B", [(1017, 512), (8185, 4096), (8191, 16384),
                                    (32761, 16384)])
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
