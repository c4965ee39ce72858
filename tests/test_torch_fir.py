"""PyTorch/CUDA port, FIR effects: ``fir``, ``fuse_lti``, the named filters
and ``eq3band_fft`` against the JAX package's ``fir_offline`` (its CPU XLA
path) and against a float64 ``np.convolve`` oracle."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyaudiodsptools_tpu as jx
import pyaudiodsptools_tpu_torch as pt
from pyaudiodsptools_tpu.ops import fft_filter as jx_fir
from pyaudiodsptools_tpu_torch.ops import fft_filter as pt_fir

from torch_port_util import conv_oracle, snr_db

CPU = "cpu"


def _effects(pkg, cfg, which, **kw):
    members = [pkg.ops.lowcut(cfg, 120.0, **kw),
               pkg.ops.highcut(cfg, 12000.0, **kw),
               pkg.ops.eq3band_fft(cfg, 250.0, 2.0, 1500.0, -1.5, 6000.0, 2.5,
                                   **kw)]
    if which == "cascade":
        fuse = jx_fir.fuse_lti if pkg is jx else pt_fir.fuse_lti
        return fuse(members)
    return members[("lowcut", "highcut", "eq3band_fft").index(which)]


@pytest.mark.parametrize("B", [512, 4096])
@pytest.mark.parametrize("which", ["lowcut", "highcut", "eq3band_fft",
                                   "cascade"])
def test_fir_matches_jax_and_oracle(B, which):
    jeff = _effects(jx, jx.EngineConfig(44100, B), which)
    peff = _effects(pt, pt.EngineConfig(44100, B), which, device=CPU)
    assert peff.name == jeff.name
    np.testing.assert_array_equal(peff.lti_kernel, jeff.lti_kernel)
    assert peff.params.lead == jeff.params.lead
    nb = 44 if B == 512 else 9
    x = (np.random.default_rng(B).standard_normal((2, nb, B)) * 0.4
         ).astype(np.float32)
    got = peff.offline(peff.params, torch.from_numpy(x)).numpy()
    want = np.asarray(jeff.offline(jeff.params, jnp.asarray(x)))
    oracle = conv_oracle(x.reshape(2, -1), peff.lti_kernel)
    # both sides are f32 FFT convolutions of the same f64-built kernel
    assert snr_db(want, got) >= 100.0
    # the bar the JAX package holds its own conv kernel to on the chip
    assert snr_db(oracle, got.reshape(2, -1)) > 95.0
    # the stripped zero prefix comes back as an exact output delay
    lead = peff.params.lead
    assert lead > 0
    assert not got.reshape(2, -1)[:, :lead].any()


def test_cascade_geometry_of_the_flagship_chain():
    """The fused FIR of lowcut+highcut+eq3band_fft: the same lead and tap
    counts as the JAX package builds, and the port's own window: at block
    size 4096 a window of 32,768 over a cluster of two thread blocks (seg
    24,576: 1.33 transformed points a kept one, 2.0 in one block's 16,384),
    at 512 one block's 8,192."""
    for B, lead, taps, n, blocks in ((512, 1155, 1017, 8192, 1),
                                     (4096, 9219, 8185, 32768, 2)):
        p = _effects(pt, pt.EngineConfig(44100, B), "cascade", device=CPU).params
        (plan,) = p.plans                   # it fits one window: no partitions
        assert (p.lead, p.kernel_len, plan.kernel_len) == (lead, taps, taps)
        assert plan.shift == lead
        assert plan.n == n == plan.halo + plan.seg
        assert plan.halo >= taps - 1
        assert plan.n >= min(8 * plan.halo, pt_fir.PLANNED_WINDOW)
        assert plan.blocks == blocks


@pytest.mark.parametrize("klen", [1, 2, 129, 255, 1017, 4097, 8185, 8193,
                                  16385, 16386, 32769])
def test_planner_invariants(klen):
    halo, seg = pt_fir.plan_segments(klen)  # in samples
    n = halo + seg
    assert halo >= klen - 1                 # the halo covers the kernel
    assert n & (n - 1) == 0                 # power of two
    assert n <= pt_fir.MAX_WINDOW           # the kernel path's cap
    assert seg >= halo                      # at least half a window is output
    assert n >= min(8 * halo, pt_fir.PLANNED_WINDOW) and n >= 2 * halo


def test_kernel_too_long_names_the_later_slice():
    # one window of the cluster takes up to 32,769 taps ...
    assert pt_fir.plan_segments(32769) == (32768, 32768)
    assert pt_fir.plan_segments(8194) == (8320, 32768 - 8320)
    assert pt_fir.plan_segments(16385) == (16384, 16384)
    assert pt_fir.plan_segments(16386) == (16512, 65536 - 16512)
    with pytest.raises(ValueError, match="partitions"):
        pt_fir.plan_segments(32770)
    # ... and a longer kernel is cut into partitions of 16,385 taps, each at
    # the planner's window of 32,768
    assert pt_fir.plan_partitions(32769) == [(0, 32769, 32768, 32768)]
    assert pt_fir.plan_partitions(40000) == [
        (0, 16385, 16384, 16384), (16385, 16385, 16384, 16384),
        (32770, 7230, 7296, 32768 - 7296)]
    long_fir = pt_fir.fir(np.ones(20000), 512, device=CPU)
    assert [p.n for p in long_fir.params.plans] == [65536]
    assert long_fir.params.stream.n == 32768
    longer = pt_fir.fir(np.r_[np.zeros(7), np.ones(65000)], 4096, device=CPU)
    assert [(p.shift, p.kernel_len) for p in longer.params.plans] == [
        (7, 16385), (7 + 16385, 16385), (7 + 32770, 16385),
        (7 + 49155, 15845)]
    # ... and it streams through the frequency-domain delay line (one
    # window would take 69,099 samples): windows of 8,192, the kernel with
    # its lead in 16 partitions of 4,096 taps, none of them zero; the state
    # a ring of 16 spectra of the one row pair, the last block of input and
    # a position, no history
    assert longer.params.parts == () and longer.params.history == 0
    line = longer.params.spectral
    assert (line.n, line.block, line.slots, line.inputs, line.delays) == (
        8192, 4096, 16, 2, tuple(range(16)))
    assert {k: tuple(v.shape) for k, v in longer.state((2,)).items()} == {
        "input": (2, 2, 4096), "pos": (), "ring": (16, 1, 8192, 2)}
    # the stream's planner: one window where the kernel and the block fit
    # 65,536, else partitions of 65,537 - B taps, and sub-blocks past
    # B = 32,768
    assert pt_fir.plan_stream(65536 - 512 + 1, 512) == (
        512, [(0, 65025, 65536)])
    assert pt_fir.plan_stream(65536 - 512 + 2, 512) == (
        512, [(0, 65025, 65536), (65025, 1, 512)])
    assert pt_fir.plan_stream(1, 65536) == (65536, [(0, 1, 65536)])
    assert pt_fir.plan_stream(2, 65536) == (
        65536, [(0, 1, 65536), (1, 1, 65536)])
    assert pt_fir.plan_stream(32767, 65536) == (32768, [(0, 32767, 65536)])
    # a long zero prefix is free: it is stripped before planning
    prefixed = pt_fir.fir(np.r_[np.zeros(70000), np.ones(100)], 512,
                          device=CPU)
    assert len(prefixed.params.parts) == 1
    assert prefixed.params.history == 70000 + 1024 - 512


def test_fir_streaming_raises_until_its_slice():
    """Streaming is ported: a filter keeps ``lead + n - B`` samples of
    history and steps. What raises is a block of another size. A kernel
    whose streaming window would outgrow the CUDA kernels' largest no longer
    raises: it streams in partitions and sub-blocks."""
    e = pt.ops.lowcut(pt.EngineConfig(44100, 512), 120.0, device=CPU)
    p = e.params
    assert (p.lead, p.kernel_len, p.stream.n) == (385, 255, 1024)
    st = e.state((2,))
    assert st["hist"].shape == (2, 385 + 1024 - 512)
    st, y = e.step(p, st, torch.zeros(2, 512))
    assert y.shape == (2, 512) and st["hist"].shape == (2, 897)
    with pytest.raises(ValueError, match="blocks of 512"):
        e.step(p, st, torch.zeros(2, 256))
    # at a block size of 65,536 a filter streams too: 32,767 taps and the
    # block would need a window of 98,302 samples, so the block goes as two
    # sub-blocks of 32,768, each through a window of 65,536
    big = pt.ops.lowcut(pt.EngineConfig(44100, 65536), 120.0, device=CPU)
    assert [(q.plan.n, q.out0, q.keep, q.add) for q in big.params.parts] \
        == [(65536, 0, 32768, False), (65536, 32768, 32768, False)]
    assert [p.n for p in big.params.plans] == [65536]
    st = big.state((2,))
    assert st["hist"].shape == (2, big.params.lead + 65536 - 32768)
    st, y = big.step(big.params, st, torch.zeros(2, 65536))
    assert y.shape == (2, 65536) and not y.any()
    assert big.offline(big.params, torch.zeros(1, 1, 65536)).shape \
        == (1, 1, 65536)


def test_all_zero_and_identity_kernels():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 6, 512)).astype(np.float32))
    ident = pt_fir.fir(np.array([1.0]), 512, device=CPU)
    assert snr_db(x.numpy(), ident.offline(ident.params, x).numpy()) > 120.0
    zero = pt_fir.fir(np.zeros(7), 512, device=CPU)
    assert not zero.offline(zero.params, x).any()


def test_sinc_kernel_matches_jax():
    for args in ((8000.0, 44100, 255, "blackman", False),
                 (160.0, 44100, 2047, "blackman", True),
                 (1875.0, 48000, 255, "kaiser6", True)):
        np.testing.assert_array_equal(pt_fir.sinc_kernel(*args),
                                      jx_fir.sinc_kernel(*args))
