"""PyTorch/CUDA port: a FIR streamed through a frequency-domain delay line
(``kernels/convpairs.spectral_step``, routed by ``ops/fft_filter.fir``).

The kernel, its zero lead included, in partitions of B taps, each one's
spectrum at the smallest power of two n >= 2 B; the state a ring of the
spectra of the last windows, the last blocks of input and a position. On
the CPU the plain version runs: held here to a float64 oracle (a block size
that is not a power of two, a lead that is not a whole number of blocks, a
kernel of one partition and one tap, an odd row), to the one-window stream
of the same kernel, to the eager contract (``Chain.step`` leaves the state
given as it was; the effect's step advances the rings in place), to its
checkpoints (``StreamProcessor`` and ``.npz``) and to the JAX package's
stream carried over by ``convert.state_from_numpy``."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyaudiodsptools_tpu as jx
from pyaudiodsptools_tpu.ops import fft_filter as jx_fir
import pyaudiodsptools_tpu_torch as pt
from pyaudiodsptools_tpu_torch import convert
from pyaudiodsptools_tpu_torch.engine.stream import (load_state_npz,
                                                     save_state_npz,
                                                     state_leaves)
from pyaudiodsptools_tpu_torch.kernels import convpairs
from pyaudiodsptools_tpu_torch.ops import fft_filter as pt_fir

import torch_port_util
from torch_port_util import conv_oracle, snr_db

CPU = "cpu"


def _kernel(taps: int, lead: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    k = rng.standard_normal(taps) * np.exp(-np.arange(taps) / (taps / 3.0))
    return np.r_[np.zeros(lead), 0.1 * k]


def _fold_line(plan, x: np.ndarray):
    """``spectral_step`` over the blocks of x (R, nb*B) from silence."""
    B = plan.block
    st = convpairs.spectral_init_state(plan, (x.shape[0],), CPU)
    ring, inputs, pos = st["ring"], st["input"], st["pos"]
    outs = []
    for i in range(x.shape[1] // B):
        y, pos = convpairs.spectral_step(
            ring, inputs, pos, torch.from_numpy(x[:, i * B:(i + 1) * B]),
            plan)
        outs.append(y.numpy())
    return np.concatenate(outs, -1), pos


# (B, taps, lead, rows): a block that is not a power of two (n = 128, the
# window reaching back two blocks), its lead not a whole block; a block of
# 300 (n = 1,024: a cluster's window on the card, three blocks back); one
# partition and one tap, no lead; reverb_live's block and lead, an odd row
LINES = [(48, 700, 150, 3), (300, 3000, 37, 2), (64, 65, 0, 3),
         (512, 2000, 1431, 5)]


@pytest.mark.parametrize("B,taps,lead,rows", LINES)
def test_delay_line_matches_oracle(B, taps, lead, rows):
    kernel = _kernel(taps, lead, seed=taps + B)
    plan = convpairs.make_spectral_plan(kernel, B, CPU)
    assert plan.n == pt_fir.convpairs.spectral_window(B) >= 2 * B
    assert plan.slots == -(-(lead + taps) // B)
    assert plan.delays == tuple(range(lead // B, plan.slots))
    assert (plan.inputs - 1) * B >= plan.n - B > (plan.inputs - 2) * B
    nb = plan.slots + 4
    x = np.random.default_rng(B).standard_normal((rows, nb * B)).astype(
        np.float32)
    got, pos = _fold_line(plan, x)
    assert int(pos) == nb % plan.period
    assert snr_db(conv_oracle(x, kernel), got) >= 120.0
    assert convpairs.launch_count == 0           # no kernel for a CPU tensor


@pytest.mark.parametrize("B,cap", [(48, 128), (64, 128), (300, 1024)])
def test_routed_delay_line_matches_the_one_window_stream(B, cap,
                                                         monkeypatch):
    """The same kernel streamed in one window (the real cap) and through
    the delay line (the cap shrunk so that one window no longer holds it):
    >= 120 dB."""
    kernel = _kernel(3 * B, 2 * B + 5, seed=B)
    whole = pt_fir.fir(kernel, B, device=CPU)
    assert len(whole.params.parts) == 1 and whole.params.spectral is None
    monkeypatch.setattr(pt_fir, "STREAM_WINDOW", cap)
    assert pt_fir.streams_spectrally(whole.params.kernel_len, B)
    line = pt_fir.fir(kernel, B, device=CPU)
    assert line.params.spectral is not None and line.params.parts == ()
    x = np.random.default_rng(cap).standard_normal((3, 12 * B)).astype(
        np.float32)
    outs = {}
    for name, eff in (("whole", whole), ("line", line)):
        st, ys = eff.state((3,)), []
        for i in range(12):
            st, y = eff.step(eff.params, st,
                             torch.from_numpy(x[:, i * B:(i + 1) * B]))
            ys.append(y.numpy())
        outs[name] = np.concatenate(ys, -1)
    assert snr_db(outs["whole"], outs["line"]) >= 120.0


def _line_effect(monkeypatch, B=64, taps=500, lead=70):
    monkeypatch.setattr(pt_fir, "STREAM_WINDOW", 2 * B)
    eff = pt_fir.fir(_kernel(taps, lead, seed=taps), B, device=CPU)
    assert eff.params.spectral is not None
    return eff


def test_eager_step_leaves_the_state_it_was_given(monkeypatch):
    """``Chain.step``: two steps from one state give the same output and
    the same new state; the state given is untouched; the new state's rings
    are new tensors."""
    eff = _line_effect(monkeypatch)
    chain = pt.Chain([eff], device=CPU)
    rng = np.random.default_rng(3)
    (st,) = chain.init_state((3,))
    for _ in range(5):
        (st,), _ = chain.step((st,), torch.from_numpy(
            rng.standard_normal((3, 64)).astype(np.float32)))
    kept = {k: v.clone() for k, v in st.items()}
    block = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    (a_st,), a = chain.step((st,), block)
    (b_st,), b = chain.step((st,), block)
    assert all(torch.equal(st[k], kept[k]) for k in kept)
    assert torch.equal(a, b)
    assert all(torch.equal(a_st[k], b_st[k]) for k in a_st)
    assert a_st["ring"] is not st["ring"] and a_st["input"] is not st["input"]
    assert not torch.equal(a_st["ring"], st["ring"])


def test_step_advances_its_rings_in_place_where_the_caller_owns_them(
        monkeypatch):
    """The effect's own step returns the very ring and input tensors it was
    given, advanced: the same numbers ``Chain.step`` gives in new
    tensors."""
    eff = _line_effect(monkeypatch)
    block = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 64)).astype(np.float32))
    st = eff.state((3,))
    (want_st,), want = pt.Chain([eff], device=CPU).step((st,), block)
    new_st, got = eff.step(eff.params, st, block)
    assert new_st["ring"] is st["ring"] and new_st["input"] is st["input"]
    assert torch.equal(got, want)
    assert all(torch.equal(new_st[k], want_st[k]) for k in want_st)


def test_stream_processor_checkpoint_round_trips(monkeypatch, tmp_path):
    """A ``StreamProcessor``'s state saved as ``.npz`` after some blocks and
    loaded back (into the same processor, and through ``load_state_npz``)
    replays the blocks after it bit for bit."""
    eff = _line_effect(monkeypatch)
    cfg = pt.EngineConfig(44100, 64)
    sp = pt.StreamProcessor(pt.Chain([eff], device=CPU), cfg,
                            batch_shape=(3,))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 12 * 64)).astype(np.float32)
    for i in range(6):
        sp.process(x[:, i * 64:(i + 1) * 64])
    path = str(tmp_path / "line.npz")
    sp.save_state(path)
    first = [sp.process(x[:, i * 64:(i + 1) * 64]) for i in range(6, 12)]
    sp.load_state(path)
    again = [sp.process(x[:, i * 64:(i + 1) * 64]) for i in range(6, 12)]
    np.testing.assert_array_equal(np.concatenate(first, -1),
                                  np.concatenate(again, -1))
    loaded = load_state_npz(path, sp.chain.init_state((3,)))
    save_state_npz(str(tmp_path / "again.npz"), loaded)
    twice = load_state_npz(str(tmp_path / "again.npz"),
                           sp.chain.init_state((3,)))
    assert all(torch.equal(a, b) for a, b in zip(state_leaves(loaded),
                                                 state_leaves(twice)))
    assert loaded[0]["pos"].dtype == torch.int32


def test_state_from_numpy_continues_a_jax_stream_through_the_delay_line(
        monkeypatch):
    """A long FIR streamed six blocks in the JAX package, its history
    carried over (the delay line's ring built from it), six more blocks in
    the port through the delay line: >= 90 dB to the JAX package's own
    continuation."""
    B = 64
    monkeypatch.setattr(pt_fir, "STREAM_WINDOW", 2 * B)
    kernel = _kernel(500, 70, seed=7)
    jchain = jx.Chain([jx_fir.fir(kernel, B)])
    pchain = pt.Chain([pt_fir.fir(kernel, B, device=CPU)], device=CPU)
    assert pchain.exec_effects[0].params.spectral is not None
    x = np.random.default_rng(8).standard_normal((2, 12 * B)).astype(
        np.float32)
    jst = jchain.init_state((2,))
    for i in range(6):
        jst, _ = jchain.step(jst, jnp.asarray(x[:, i * B:(i + 1) * B]))
    leaves = [np.asarray(leaf) for leaf in jax.tree.flatten(jst)[0]]
    assert len(leaves) == 1
    pst = convert.state_from_numpy(pchain, leaves)
    assert sorted(pst[0]) == ["input", "pos", "ring"]
    assert int(pst[0]["pos"]) == 0
    got, want = [], []
    for i in range(6, 12):
        blk = x[:, i * B:(i + 1) * B]
        jst, jy = jchain.step(jst, jnp.asarray(blk))
        pst, py = pchain.step(pst, torch.from_numpy(blk))
        want.append(np.asarray(jy))
        got.append(py.numpy())
    assert snr_db(np.concatenate(want, -1), np.concatenate(got, -1)) >= 90.0
    with pytest.raises(ValueError, match="state leaves"):
        convert.state_from_numpy(pchain, leaves + leaves)


def test_delay_line_refuses_a_block_or_state_of_another_shape():
    plan = convpairs.make_spectral_plan(_kernel(200, 3, seed=1), 64, CPU)
    st = convpairs.spectral_init_state(plan, (2,), CPU)
    with pytest.raises(ValueError, match="block"):
        convpairs.spectral_step(st["ring"], st["input"], st["pos"],
                                torch.zeros(2, 32), plan)
    with pytest.raises(ValueError, match="ring"):
        convpairs.spectral_step(st["ring"][1:], st["input"], st["pos"],
                                torch.zeros(2, 64), plan)


def test_the_mirror_shares_the_kernels_thread_counts():
    """``torch_port_util.emulate_spectral_step`` shares the sum out over
    blocks and groups of lanes as csrc/convpairs.cu does: the same thread
    and block counts."""
    src = (Path(convpairs.__file__).resolve().parent.parent / "csrc"
           / "convpairs.cu").read_text()
    for name in ("SPECTRAL_THREADS", "SPECTRAL_SPLIT_THREADS"):
        found = re.search(rf"^#define {name} (\d+)$", src, re.M)
        assert found and int(found.group(1)) == getattr(torch_port_util,
                                                        name), name
    # the summing blocks a pair, which the mirror reads from the wrapper
    found = re.search(r"^#define SPECTRAL_BLOCKS (\d+)$", src, re.M)
    assert found and int(found.group(1)) == convpairs.SPECTRAL_BLOCKS
