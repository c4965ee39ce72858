"""PyTorch/CUDA port, streaming: ``fir_step``, ``Chain.step`` and
``StreamProcessor`` against the JAX package's on the CPU, block by block on
the same numpy inputs, and ``convert.state_from_numpy``.

The port runs with ``device="cpu"`` (the plain versions of its kernels). The
JAX FIR step convolves a window of a 7-smooth number of blocks with the full
kernel; the port's window is a power of two, its zero prefix stripped and
paid back as a delay in the history: parity is judged on the output."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pyaudiodsptools_tpu as jx
import pyaudiodsptools_tpu_torch as pt
from pyaudiodsptools_tpu.ops import fft_filter as jx_fir
from pyaudiodsptools_tpu_torch import convert
from pyaudiodsptools_tpu_torch.engine.stream import (state_from_leaves,
                                                     state_leaves,
                                                     state_paths)
from pyaudiodsptools_tpu_torch.kernels import convpairs, dynamics as kd
from pyaudiodsptools_tpu_torch.ops import fft_filter as pt_fir

from torch_port_util import conv_oracle, snr_db

CPU = "cpu"
B = 512
NB = 10
FIELDS = ("mode", "x", "y", "skip")


def _filters(pkg, cfg, which, **kw):
    members = [pkg.ops.lowcut(cfg, 120.0, **kw),
               pkg.ops.highcut(cfg, 12000.0, **kw),
               pkg.ops.eq3band_fft(cfg, 250.0, 2.0, 1500.0, -1.5, 6000.0, 2.5,
                                   **kw)]
    if which == "cascade":
        fuse = jx_fir.fuse_lti if pkg is jx else pt_fir.fuse_lti
        return fuse(members)
    return members[("lowcut", "highcut", "eq3band_fft").index(which)]


def _chain8_effects(pkg, cfg, **kw):
    o = pkg.ops
    return [o.lowcut(cfg, 120.0, **kw), o.highcut(cfg, 12000.0, **kw),
            o.eq3band_fft(cfg, 250.0, 2.0, 1500.0, -1.5, 6000.0, 2.5, **kw),
            o.compressor(cfg, -18.0, 0.6, 3.1, 30.1, **kw),
            o.gate(cfg, -45.0, 0.1, 3.1, 200.1, **kw),
            o.delay(cfg, 150.0, 2, **kw),
            o.tremolo(cfg, 0.3, 5.0, **kw), o.softclipper(cfg, 0.44, **kw)]


@functools.lru_cache(maxsize=None)
def _chains():
    """(JAX chain8, the port's chain8) at B = 512; built once, so the JAX
    step is traced once for the whole file."""
    jchain = jx.Chain(_chain8_effects(jx, jx.EngineConfig(44100, B)))
    pchain = pt.Chain(_chain8_effects(pt, pt.EngineConfig(44100, B),
                                      device=CPU), device=CPU)
    return jchain, pchain


def _signal(C, n, seed):
    """Noise bursts over a quiet floor: both automatons trigger, hold,
    release and rest within a few blocks."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    burst = (np.sin(2 * np.pi * t / 1900.0) > 0.2) * 0.6 + 0.002
    return np.clip(rng.standard_normal((C, n)) * 0.3 * burst, -0.99, 0.99
                   ).astype(np.float32)


def _dynamics_leaves(state) -> dict:
    """path -> leaf for the dynamics fields of a port state."""
    return {path: leaf for path, leaf in state_paths(state)
            if path[-1] in FIELDS}


def _assert_dynamics_equal(pstate, jstate, what=""):
    ours = _dynamics_leaves(pstate)
    theirs = jax.tree.flatten(jstate)[0]
    paths = [path for path, _ in state_paths(pstate)]
    assert len(paths) == len(theirs)
    assert len(ours) == 8                     # two ops, four fields each
    for path, leaf in zip(paths, theirs):
        if path in ours:
            np.testing.assert_array_equal(ours[path].numpy(),
                                          np.asarray(leaf),
                                          err_msg=f"{what}{path}")


# ---------------------------------------------------------------------------
# fir_step


@pytest.mark.parametrize("block", [64, 512])
@pytest.mark.parametrize("which", ["lowcut", "highcut", "eq3band_fft",
                                   "cascade"])
def test_fir_step_matches_jax_fir_step(which, block):
    jeff = _filters(jx, jx.EngineConfig(44100, block), which)
    peff = _filters(pt, pt.EngineConfig(44100, block), which, device=CPU)
    p = peff.params
    n = p.stream.n
    assert n & (n - 1) == 0 and n >= p.kernel_len - 1 + block > n // 2
    assert pt_fir.history_len(p) == p.lead + n - block
    x = _signal(2, 12 * block, seed=block)
    jst, pst = jeff.init_state(jeff.params, (2,)), peff.state((2,))
    assert pst["hist"].shape == (2, p.lead + n - block)
    got, want = [], []
    for i in range(12):
        blk = x[:, i * block:(i + 1) * block]
        jst, jy = jeff.step(jeff.params, jst, jnp.asarray(blk))
        pst, py = peff.step(p, pst, torch.from_numpy(blk))
        assert py.shape == (2, block) and py.dtype == torch.float32
        want.append(np.asarray(jy))
        got.append(py.numpy())
    got, want = np.concatenate(got, -1), np.concatenate(want, -1)
    assert snr_db(want, got) >= 100.0
    assert snr_db(conv_oracle(x, peff.lti_kernel), got) > 95.0
    # the streamed fold is the offline render, through another window
    off = peff.offline(p, torch.from_numpy(x).reshape(2, 12, block))
    assert snr_db(off.reshape(2, -1).numpy(), got) >= 110.0
    assert convpairs.launch_count == 0           # no kernel for a CPU tensor


def test_fir_step_mono_and_stream_window_planner():
    peff = _filters(pt, pt.EngineConfig(44100, B), "cascade", device=CPU)
    assert (peff.params.stream.n, peff.params.lead,
            peff.params.kernel_len) == (2048, 1155, 1017)
    big = _filters(pt, pt.EngineConfig(44100, 4096), "cascade", device=CPU)
    assert (big.params.stream.n, big.params.lead,
            big.params.kernel_len) == (16384, 9219, 8185)
    assert pt_fir.stream_window(1, 1) == 16
    assert pt_fir.stream_window(8193, 8192) == 16384
    # past one thread block's window, the clusters' 32,768 and 65,536
    assert pt_fir.stream_window(8194, 8192) == 32768
    assert pt_fir.stream_window(32769, 32768) == 65536
    assert pt_fir.stream_window(32770, 32768) == 0
    x = _signal(2, 6 * B, seed=2)
    st2, st1 = peff.state((2,)), peff.state(())
    assert st1["hist"].shape == (1155 + 2048 - B,)
    for i in range(6):
        blk = torch.from_numpy(x[:, i * B:(i + 1) * B])
        st2, y2 = peff.step(peff.params, st2, blk)
        st1, y1 = peff.step(peff.params, st1, blk[0])
        assert y1.shape == (B,)
        assert snr_db(y2[0].numpy(), y1.numpy()) >= 120.0


@pytest.mark.parametrize("block", [64, 512])
def test_fir_step_is_one_conv_pairs_step_and_keeps_the_old_state(block,
                                                                 monkeypatch):
    """``fir_step`` is ONE call of ``stream_step`` with the one part that
    ``conv_pairs_step`` makes, its window from the history's first sample and
    all of the block kept (on the card: one launch; here its plain version).
    Over eight steps it gives, bit for bit, what the join / convolve / slice
    it replaces gives, history included; the state it was given stays valid
    (``StreamProcessor.warmup`` relies on that); and it holds the JAX
    package's ``fir_step`` to the 100 dB of the test above."""
    jeff = _filters(jx, jx.EngineConfig(44100, block), "cascade")
    peff = _filters(pt, pt.EngineConfig(44100, block), "cascade", device=CPU)
    p = peff.params
    n = p.stream.n
    calls = []
    real_step = convpairs.stream_step

    def counted(hist, blk, parts, use_kernels=True):
        calls.append((tuple(hist.shape), tuple(blk.shape),
                      [(q.plan.n, q.start, q.out0, q.keep, q.add)
                       for q in parts]))
        return real_step(hist, blk, parts, use_kernels)

    monkeypatch.setattr(convpairs, "stream_step", counted)
    x = _signal(2, 8 * block, seed=3 * block)
    jst, pst = jeff.init_state(jeff.params, (2,)), peff.state((2,))
    old_hist = pst["hist"]
    got, want, old_way = [], [], []
    for i in range(8):
        blk = torch.from_numpy(x)[:, i * block:(i + 1) * block]
        kept = pst["hist"].clone()
        new_pst, py = peff.step(p, pst, blk)
        assert torch.equal(pst["hist"], kept)        # the old state is whole
        joined = np.concatenate([old_hist.numpy(), blk.numpy()], axis=-1)
        win = convpairs.conv_pairs(
            torch.from_numpy(np.ascontiguousarray(joined[:, :n])), p.stream)
        old_way.append(win[:, n - block:].numpy())
        old_hist = torch.from_numpy(np.ascontiguousarray(joined[:, block:]))
        assert torch.equal(new_pst["hist"], old_hist)
        assert new_pst["hist"].shape == (2, p.lead + n - block)
        jst, jy = jeff.step(jeff.params, jst, jnp.asarray(blk.numpy()))
        pst = new_pst
        got.append(py.numpy())
        want.append(np.asarray(jy))
    assert calls == [((2, p.lead + n - block), (2, block),
                      [(n, 0, 0, block, False)])] * 8
    np.testing.assert_array_equal(np.concatenate(got, -1),
                                  np.concatenate(old_way, -1))
    assert snr_db(np.concatenate(want, -1), np.concatenate(got, -1)) >= 100.0


# ---------------------------------------------------------------------------
# Chain.step


def test_chain8_step_matches_jax_chain_step():
    """Ten blocks of the flagship chain, state carried on both sides: audio
    >= 90 dB (the JAX package's bar for its kernel-backed chain), and the
    dynamics state fields EQUAL after every block. The two FIR outputs
    differ in the last bits, so equality needs a signal that keeps clear of
    the thresholds by more than that: the margin is asserted."""
    jchain, pchain = _chains()
    assert [e.name for e in pchain.exec_effects] == [
        "fir_cascade:lowcut+highcut+eq3band_fft",
        "dynamics_cascade:compressor+gate", "tail:delay+tremolo+softclipper"]
    x = _signal(2, NB * B, seed=4)
    # margin: the FIR output against the compressor's threshold, and the
    # compressor's output against the gate's
    fir_e, dyn_e, _ = pchain.exec_effects
    y = fir_e.offline(fir_e.params, torch.from_numpy(x).reshape(2, NB, B))
    comp_p, gate_p = dyn_e.params
    assert float((y.abs() - comp_p.threshold).abs().min()) > 2e-6
    mid = kd.dynamics_offline(comp_p, y.reshape(2, -1))
    assert float((mid.abs() - gate_p.threshold).abs().min()) > 2e-7

    jst, pst = jchain.init_state((2,)), pchain.init_state((2,))
    got, want = [], []
    for i in range(NB):
        blk = x[:, i * B:(i + 1) * B]
        jst, jy = jchain.step(jst, jnp.asarray(blk))
        pst, py = pchain.step(pst, torch.from_numpy(blk))
        want.append(np.asarray(jy))
        got.append(py.numpy())
        _assert_dynamics_equal(pst, jst, f"block {i}: ")
    got, want = np.concatenate(got, -1), np.concatenate(want, -1)
    assert snr_db(want, got) >= 90.0
    # both automatons were at work: some state is not REST at the end of
    # some block is implied by the audio; at least the gains moved
    assert not np.array_equal(got, x)
    # the tremolo's position: two 0-d int32 leaves on both sides (tensors
    # on the device, advanced by tensor operations), equal
    for j, p in zip(jax.tree.flatten(jst)[0][-2:],
                    [pst[2][1]["avail"], pst[2][1]["phase"]]):
        assert np.asarray(j).dtype == np.int32 and np.asarray(j).shape == ()
        assert p.dtype == torch.int32 and p.shape == ()
        assert int(p) == int(j)


def test_streamed_equals_offline_within_the_port():
    """chain8 block by block against its own offline render: the FIR stage
    through another window (last bits differ), everything after it the same
    arithmetic. 90 dB for the whole chain (one flipped mask bit restarts a
    ramp), 110 dB for the FIR stage alone."""
    _, pchain = _chains()
    cfg = pt.EngineConfig(44100, B)
    x = _signal(3, NB * B - 70, seed=6)
    sp = pt.StreamProcessor(pchain, cfg, (3,))
    padded = np.pad(x, ((0, 0), (0, 70)))
    outs = list(sp.process_stream(padded[:, i * B:(i + 1) * B]
                                  for i in range(NB)))
    streamed = np.concatenate(outs, -1)
    off = pt.render(pchain, x, cfg).numpy()
    assert streamed.shape == off.shape == (3, NB * B)
    assert snr_db(off, streamed) >= 90.0
    # the same through render_segmented: it IS the streaming fold
    seg = pt.render_segmented(pchain, x, cfg, segment_blocks=3).numpy()
    np.testing.assert_array_equal(seg, streamed)


# ---------------------------------------------------------------------------
# StreamProcessor


def test_stream_processor_checkpoint(tmp_path):
    """The JAX package's checkpoint test in both packages: process half,
    save, load into a fresh processor, continue: bit-equal to the
    uninterrupted run within the port, >= 90 dB to the JAX processor."""
    jchain, pchain = _chains()
    jcfg, pcfg = jx.EngineConfig(44100, B), pt.EngineConfig(44100, B)
    x = _signal(1, 8 * B, seed=8)[0]
    blocks = [x[i * B:(i + 1) * B] for i in range(8)]

    sp = pt.StreamProcessor(pchain, pcfg)
    sp.warmup()
    out_full = [sp.process(b) for b in blocks]
    assert all(isinstance(o, np.ndarray) and o.shape == (B,)
               for o in out_full)

    sp2 = pt.StreamProcessor(pchain, pcfg)
    for b in blocks[:4]:
        sp2.process(b)
    ckpt = str(tmp_path / "state.npz")
    sp2.save_state(ckpt)
    sp3 = pt.StreamProcessor(pchain, pcfg)
    sp3.load_state(ckpt)
    for a, b in zip(out_full[4:], [sp3.process(b) for b in blocks[4:]]):
        np.testing.assert_array_equal(a, b)

    jsp = jx.StreamProcessor(jchain, jcfg)
    want = [jsp.process(b) for b in blocks]
    assert snr_db(np.concatenate(want), np.concatenate(out_full)) >= 90.0
    # the archive holds the state's leaves in the JAX processor's order
    jckpt = str(tmp_path / "jstate.npz")
    jsp2 = jx.StreamProcessor(jchain, jcfg)
    for b in blocks[:4]:
        jsp2.process(b)
    jsp2.save_state(jckpt)
    with np.load(ckpt) as ours, np.load(jckpt) as theirs:
        assert ours.files == theirs.files
        for k in ours.files[1:]:             # all but the FIR history
            assert ours[k].shape == theirs[k].shape, k
    with pytest.raises(ValueError, match="leaves"):
        state_from_leaves(sp3.state, state_leaves(sp3.state)[:-1])


def test_stream_processor_reset_and_warmup_leave_no_trace():
    jchain, pchain = _chains()
    jcfg, pcfg = jx.EngineConfig(44100, B), pt.EngineConfig(44100, B)
    x = _signal(2, 4 * B, seed=10)
    blocks = [x[:, i * B:(i + 1) * B] for i in range(4)]
    sp = pt.StreamProcessor(pchain, pcfg, (2,))
    first = [sp.process(b) for b in blocks]
    # warmup in mid-stream: one step on silence, the state stays as it was
    before = [leaf.clone() for leaf in state_leaves(sp.state)]
    sp.warmup()
    after = state_leaves(sp.state)
    assert len(before) == len(after) == 12
    for a, b in zip(before, after):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # reset: the same input gives the same output again, as in the JAX one
    sp.reset()
    again = [sp.process(b) for b in blocks]
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    jsp = jx.StreamProcessor(jchain, jcfg, (2,))
    jfirst = [jsp.process(b) for b in blocks]
    jsp.warmup()
    jsp.reset()
    jagain = [jsp.process(b) for b in blocks]
    for a, b in zip(jfirst, jagain):
        np.testing.assert_array_equal(a, b)
    assert snr_db(np.concatenate(jfirst, -1), np.concatenate(first, -1)) >= 90.0


def test_stream_processor_final_partial_block_and_tensor_io():
    """A short last block is padded with silence, stepped whole (the
    automatons advance through the padding, as in the JAX processor) and cut
    back to its length; a tensor in gives a tensor out."""
    jchain, pchain = _chains()
    jcfg, pcfg = jx.EngineConfig(44100, B), pt.EngineConfig(44100, B)
    x = _signal(2, 3 * B + 300, seed=12)
    pieces = [x[:, i * B:(i + 1) * B] for i in range(4)]
    assert pieces[-1].shape == (2, 300)
    sp = pt.StreamProcessor(pchain, pcfg, (2,))
    jsp = jx.StreamProcessor(jchain, jcfg, (2,))
    got = [sp.process(torch.from_numpy(p)) for p in pieces]
    want = [jsp.process(p) for p in pieces]
    assert all(isinstance(g, torch.Tensor) for g in got)
    assert got[-1].shape == (2, 300) and want[-1].shape == (2, 300)
    assert snr_db(np.concatenate(want, -1),
                  torch.cat(got, -1).numpy()) >= 90.0
    _assert_dynamics_equal(sp.state, jsp.state, "after the short block: ")
    with pytest.raises(ValueError, match="longer than the block size"):
        sp.process(np.zeros((2, B + 1), np.float32))


# ---------------------------------------------------------------------------
# convert.state_from_numpy


def test_state_from_numpy_continues_a_jax_stream():
    """Six blocks in the JAX chain, its state carried over as numpy leaves,
    six more blocks in the port: >= 90 dB to the JAX chain's own
    continuation, dynamics fields equal at the hand-over and at the end."""
    jchain, pchain = _chains()
    x = _signal(2, 12 * B, seed=14)
    jst = jchain.init_state((2,))
    for i in range(6):
        jst, _ = jchain.step(jst, jnp.asarray(x[:, i * B:(i + 1) * B]))
    leaves = [np.asarray(leaf) for leaf in jax.tree.flatten(jst)[0]]
    pst = convert.state_from_numpy(pchain, leaves)
    p = pchain.params[0]
    assert pst[0]["hist"].shape == (2, p.lead + p.stream.n - B)
    # the JAX history (6 blocks) is shorter than lead + n - B: silence in
    # front, the JAX samples at the end
    jhist = leaves[0].reshape(2, -1)
    assert jhist.shape[-1] < pst[0]["hist"].shape[-1]
    np.testing.assert_array_equal(
        pst[0]["hist"][:, -jhist.shape[-1]:].numpy(), jhist)
    assert not pst[0]["hist"][:, :-jhist.shape[-1]].any()
    _assert_dynamics_equal(pst, jst, "hand-over: ")
    got, want = [], []
    for i in range(6, 12):
        blk = x[:, i * B:(i + 1) * B]
        jst, jy = jchain.step(jst, jnp.asarray(blk))
        pst, py = pchain.step(pst, torch.from_numpy(blk))
        want.append(np.asarray(jy))
        got.append(py.numpy())
    assert snr_db(np.concatenate(want, -1), np.concatenate(got, -1)) >= 90.0
    _assert_dynamics_equal(pst, jst, "end: ")
    with pytest.raises(ValueError, match="state leaves"):
        convert.state_from_numpy(pchain, leaves[:-1])


def test_state_from_numpy_cuts_a_longer_jax_history():
    """A lone lowcut at B = 64: the JAX step keeps 2 blocks (128 samples),
    the port lead + n - B = 49 + 128 - 64 = 113: the last 113 are kept."""
    jeff = jx.ops.lowcut(jx.EngineConfig(44100, 64), 300.0)
    peff = pt.ops.lowcut(pt.EngineConfig(44100, 64), 300.0, device=CPU)
    jchain = jx.Chain([jeff])
    pchain = pt.Chain([peff], device=CPU)
    x = _signal(1, 10 * 64, seed=16)[0]
    jst = jchain.init_state(())
    for i in range(5):
        jst, _ = jchain.step(jst, jnp.asarray(x[i * 64:(i + 1) * 64]))
    leaves = [np.asarray(leaf) for leaf in jax.tree.flatten(jst)[0]]
    assert leaves[0].shape == (2, 64)
    pst = convert.state_from_numpy(pchain, leaves)
    assert pst[0]["hist"].shape == (113,)
    np.testing.assert_array_equal(pst[0]["hist"].numpy(),
                                  leaves[0].reshape(-1)[-113:])
    got, want = [], []
    for i in range(5, 10):
        blk = x[i * 64:(i + 1) * 64]
        jst, jy = jchain.step(jst, jnp.asarray(blk))
        pst, py = pchain.step(pst, torch.from_numpy(blk))
        want.append(np.asarray(jy))
        got.append(py.numpy())
    assert snr_db(np.concatenate(want), np.concatenate(got)) >= 100.0


@pytest.mark.cuda
def test_cuda_stream_bit_equal_across_a_checkpoint_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cfg = pt.EngineConfig(44100, B)
    chain = pt.Chain(_chain8_effects(pt, cfg, device="cuda"), device="cuda")
    x = torch.from_numpy(_signal(4, 8 * B, seed=18)).cuda()
    sp = pt.StreamProcessor(chain, cfg, (4,))
    sp.warmup()      # the capture's warm-up step launches too
    before = (convpairs.launch_count, kd.serial_walk_launch_count)
    full = [sp.process(x[:, i * B:(i + 1) * B]) for i in range(8)]
    assert (convpairs.launch_count, kd.serial_walk_launch_count) \
        == (before[0] + 8, before[1] + 8)
    sp2 = pt.StreamProcessor(chain, cfg, (4,))
    for i in range(4):
        sp2.process(x[:, i * B:(i + 1) * B])
    sp2.save_state(str(tmp_path / "s.npz"))
    sp3 = pt.StreamProcessor(chain, cfg, (4,))
    sp3.load_state(str(tmp_path / "s.npz"))
    for i in range(4, 8):
        assert torch.equal(sp3.process(x[:, i * B:(i + 1) * B]), full[i])
    off = pt.render(chain, x, cfg)
    assert snr_db(off.cpu().numpy(), torch.cat(full, -1).cpu().numpy()) >= 90.0


@pytest.mark.cuda
def test_cuda_step_is_two_launches_before_the_tail_on_card(monkeypatch):
    """On the card the FIR stage of a step is ONE kernel launch with no join
    and no copy of the output slice, and the dynamics stage ONE launch with no
    ``encode_state`` / ``decode_state`` call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from torch.profiler import ProfilerActivity, profile
    cfg = pt.EngineConfig(44100, B)
    chain = pt.Chain(_chain8_effects(pt, cfg, device="cuda"), device="cuda")
    fir_e, dyn_e, _ = chain.exec_effects
    x = torch.from_numpy(_signal(4, 4 * B, seed=20)).cuda()
    monkeypatch.setattr(torch, "cat", lambda *a, **k: pytest.fail(
        "the step joined tensors"))
    for name in ("encode_state", "decode_state"):
        monkeypatch.setattr(kd, name, lambda *a, **k: pytest.fail(
            "the step packed or unpacked the state in PyTorch"))
    s_fir, s_dyn = fir_e.state((4,)), dyn_e.state((4,))
    for i in range(2):                                   # build, warm up
        s_fir, y = fir_e.step(fir_e.params, s_fir, x[:, i * B:(i + 1) * B])
        s_dyn, y = dyn_e.step(dyn_e.params, s_dyn, y)
    torch.cuda.synchronize()
    before = (convpairs.launch_count, kd.serial_walk_launch_count)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s_fir, y = fir_e.step(fir_e.params, s_fir, x[:, 2 * B:3 * B])
        s_dyn, y = dyn_e.step(dyn_e.params, s_dyn, y)
        torch.cuda.synchronize()
    assert (convpairs.launch_count, kd.serial_walk_launch_count) \
        == (before[0] + 1, before[1] + 1)
    device_events = [ev for ev in prof.key_averages()
                     if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert sum(ev.count for ev in device_events) == 2, \
        [(ev.key, ev.count) for ev in device_events]
