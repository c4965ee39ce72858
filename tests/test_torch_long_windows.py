"""PyTorch/CUDA port: windows past one thread block and FIRs past one
window, against the JAX package on the CPU.

The streaming window of a FIR goes up to 65,536 samples (clusters of two and
four thread blocks on the card), so filters stream at block sizes of 8,192
and 16,384 and a Chain fuses chain8's three filters there as the JAX package
does; a FIR longer than one window of the segmented convolution (32,769
taps) renders offline in partitions. The port runs with ``device="cpu"``,
the plain versions of its kernels; the JAX side runs its own ``fir``,
``fir_step`` and ``Chain`` on the CPU."""

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
FIR_NAME = "fir_cascade:lowcut+highcut+eq3band_fft"
DYN_NAME = "dynamics_cascade:compressor+gate"
TAIL8_NAME = "tail:delay+tremolo+softclipper"


def _chain8_effects(pkg, cfg, **kw):
    """The flagship chain, with the arguments of ``__graft_entry__._chain8``."""
    o = pkg.ops
    return [o.lowcut(cfg, 120.0, **kw), o.highcut(cfg, 12000.0, **kw),
            o.eq3band_fft(cfg, 250.0, 2.0, 1500.0, -1.5, 6000.0, 2.5, **kw),
            o.compressor(cfg, -18.0, 0.6, 3.1, 30.1, **kw),
            o.gate(cfg, -45.0, 0.1, 3.1, 200.1, **kw),
            o.delay(cfg, 150.0, 2, **kw),
            o.tremolo(cfg, 0.3, 5.0, **kw), o.softclipper(cfg, 0.44, **kw)]


def _signal(C, n, seed):
    """Noise bursts over a quiet floor: both automatons trigger, hold,
    release and rest within a few blocks."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    burst = (np.sin(2 * np.pi * t / 1900.0) > 0.2) * 0.6 + 0.002
    return np.clip(rng.standard_normal((C, n)) * 0.3 * burst, -0.99, 0.99
                   ).astype(np.float32)


# ---------------------------------------------------------------------------
# block sizes whose streaming window no thread block holds


@pytest.mark.parametrize("B", [8192, 16384])
def test_chain8_fuses_its_filters_at_long_blocks_like_jax(B):
    """At B=8,192 and 16,384 the fused FIR of chain8's three filters (16,377
    and 32,761 stripped taps) streams only through a window no thread block
    holds (24,568 and 49,144 samples): the port fuses the three into one
    FIR, as the JAX Chain does on every backend, with the same kernel."""
    jchain = jx.Chain(_chain8_effects(jx, jx.EngineConfig(44100, B)))
    pchain = pt.Chain(_chain8_effects(pt, pt.EngineConfig(44100, B),
                                      device=CPU), device=CPU)
    assert [e.name for e in pchain.exec_effects] == \
        [FIR_NAME, DYN_NAME, TAIL8_NAME]
    fir_e, jfir = pchain.exec_effects[0], jchain.exec_effects[0]
    assert jfir.name == FIR_NAME
    np.testing.assert_array_equal(fir_e.lti_kernel, jfir.lti_kernel)
    taps = {8192: 16377, 16384: 32761}[B]
    assert fir_e.params.kernel_len == taps
    assert fir_e.params.stream.n == {8192: 32768, 16384: 65536}[B]
    # at B=32,768 the three would need 98,296 samples: they fuse all the
    # same (the JAX Chain fuses every LTI run), and stream in two partitions
    wide = pt.Chain(_chain8_effects(pt, pt.EngineConfig(44100, 32768),
                                    device=CPU), device=CPU)
    assert [e.name for e in wide.exec_effects] == \
        [FIR_NAME, DYN_NAME, TAIL8_NAME]
    assert len(wide.exec_effects[0].params.parts) == 2



def test_lowcut_streams_at_16384_like_jax_fir_step():
    """A lowcut at B=16,384 has 8,191 taps and needs a streaming window of
    24,574 samples, more than one thread block's 16,384: it streams through
    a window of 32,768 (a cluster of two blocks on the card), through
    StreamProcessor, block by block >= 100 dB to the JAX ``fir_step``."""
    Bb, nb = 16384, 4
    pcfg = pt.EngineConfig(44100, Bb)
    peff = pt.ops.lowcut(pcfg, 120.0, device=CPU)
    jeff = jx.ops.lowcut(jx.EngineConfig(44100, Bb), 120.0)
    assert (peff.params.kernel_len, peff.params.stream.n) == (8191, 32768)
    sp = pt.StreamProcessor(pt.Chain([peff], device=CPU), pcfg, (1,))
    x = _signal(1, nb * Bb, seed=16)
    jst = jeff.init_state(jeff.params, (1,))
    got, want = [], []
    for i in range(nb):
        blk = x[:, i * Bb:(i + 1) * Bb]
        got.append(np.asarray(sp.process(blk)))
        jst, jy = jeff.step(jeff.params, jst, jnp.asarray(blk))
        want.append(np.asarray(jy))
    got, want = np.concatenate(got, -1), np.concatenate(want, -1)
    assert got.shape == (1, nb * Bb)
    assert snr_db(want, got) >= 100.0
    assert snr_db(conv_oracle(x, peff.lti_kernel), got) > 95.0


def test_chain8_streams_at_16384_like_jax_chain_step():
    """chain8 at B=16,384: its three filters fuse into ONE FIR of 32,761
    stripped taps, which streams through a window of 65,536 (a cluster of
    four blocks on the card); five blocks of two channels (each filter
    delays by a block: the first three are the fused FIR's latency) through
    ``Chain.step`` against the JAX chain's step at the chain bar, 90 dB."""
    Bb, nb = 16384, 5
    jchain = jx.Chain(_chain8_effects(jx, jx.EngineConfig(44100, Bb)))
    pchain = pt.Chain(_chain8_effects(pt, pt.EngineConfig(44100, Bb),
                                      device=CPU), device=CPU)
    fir_e = pchain.exec_effects[0]
    assert fir_e.name == jchain.exec_effects[0].name \
        == "fir_cascade:lowcut+highcut+eq3band_fft"
    assert (fir_e.params.kernel_len, fir_e.params.stream.n) == (32761, 65536)
    x = _signal(2, nb * Bb, seed=17)
    jst, pst = jchain.init_state((2,)), pchain.init_state((2,))
    got, want = [], []
    for i in range(nb):
        blk = x[:, i * Bb:(i + 1) * Bb]
        jst, jy = jchain.step(jst, jnp.asarray(blk))
        pst, py = pchain.step(pst, torch.from_numpy(blk))
        want.append(np.asarray(jy))
        got.append(py.numpy())
    got, want = np.concatenate(got, -1), np.concatenate(want, -1)
    assert np.abs(got).max() > 0.1
    assert snr_db(want, got) >= 90.0


# ---------------------------------------------------------------------------
# kernels longer than one window: partitions


def _long_kernel(taps: int, seed: int) -> np.ndarray:
    """A decaying noise tail of ``taps`` taps behind a zero prefix, the shape
    of a reverb line's response."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal(taps) * np.exp(-np.arange(taps) / (taps / 4.0))
    return np.r_[np.zeros(37), k * 0.05]


@pytest.mark.parametrize("B", [512, 4096])
def test_partitioned_fir_matches_jax_and_oracle(B):
    """A 40,000-tap FIR, longer than one window of the segmented conv takes
    (32,769 taps), builds as three partitions and renders offline: >= 100
    dB to the JAX ``fir`` (which builds a kernel of any length) and > 95 dB
    to the float64 oracle (the JAX package's bar for its segmented conv)."""
    kernel = _long_kernel(40000, seed=B)
    peff = pt_fir.fir(kernel, B, device=CPU)
    jeff = jx_fir.fir(kernel, B)
    plans = peff.params.plans
    assert [(p.shift, p.kernel_len, p.n) for p in plans] == [
        (37, 16385, 32768), (37 + 16385, 16385, 32768),
        (37 + 32770, 7230, 32768)]
    assert peff.params.stream.n == 65536          # and it streams
    nb = 45056 // B                   # past the kernel's 40,037 samples
    x = (np.random.default_rng(B + 1).standard_normal((1, nb, B)) * 0.4
         ).astype(np.float32)
    got = peff.offline(peff.params, torch.from_numpy(x)).numpy()
    want = np.asarray(jeff.offline(jeff.params, jnp.asarray(x)))
    assert snr_db(want, got) >= 100.0
    assert snr_db(conv_oracle(x.reshape(1, -1), kernel),
                  got.reshape(1, -1)) > 95.0
    # each partition's output delay is exact: the prefix is silence
    assert not got.reshape(1, -1)[:, :37].any()


def test_partitioned_fir_streams_like_jax_fir_step():
    """The same 40,000-tap FIR at B=512 streams through one window of
    65,536: block by block (82 blocks, past the kernel's 40,037 samples)
    >= 100 dB to the JAX ``fir_step``, and > 95 dB to the float64 oracle."""
    B, nb = 512, 82
    kernel = _long_kernel(40000, seed=B)
    peff = pt_fir.fir(kernel, B, device=CPU)
    jeff = jx_fir.fir(kernel, B)
    x = (np.random.default_rng(3).standard_normal((1, nb * B)) * 0.4
         ).astype(np.float32)
    pst, jst = peff.state((1,)), jeff.init_state(jeff.params, (1,))
    got, want = [], []
    for i in range(nb):
        blk = x[:, i * B:(i + 1) * B]
        pst, py = peff.step(peff.params, pst, torch.from_numpy(blk))
        jst, jy = jeff.step(jeff.params, jst, jnp.asarray(blk))
        got.append(py.numpy())
        want.append(np.asarray(jy))
    got, want = np.concatenate(got, -1), np.concatenate(want, -1)
    assert snr_db(want, got) >= 100.0
    assert snr_db(conv_oracle(x, kernel), got) > 95.0


def test_one_window_kernel_keeps_one_plan():
    """A kernel one window takes is one plan, and the partitioned path over
    it is the single segmented convolution, bit for bit."""
    from pyaudiodsptools_tpu_torch.kernels import segconv

    for taps in (1017, 8185, 32769):
        eff = pt_fir.fir(_long_kernel(taps, seed=taps), 512, device=CPU)
        (plan,) = eff.params.plans
        assert plan.kernel_len == taps and plan.shift == 37
        x = torch.from_numpy(np.random.default_rng(taps).standard_normal(
            (2, 40000)).astype(np.float32))
        assert torch.equal(segconv.partitioned_conv(x, eff.params.plans),
                           segconv.segmented_conv(x, plan))


# ---------------------------------------------------------------------------
# streams past the largest window: partitions


@pytest.mark.parametrize("taps,nb", [(40000, 12), (65000, 18)])
def test_long_fir_streams_at_4096_like_jax_fir_step(taps, nb):
    """A 40,000-tap FIR at B=4096 streams through one window of 65,536; a
    65,000-tap one needs 69,099 samples, more than the largest window, and
    streams in two partitions (windows of 65,536 and 8,192, one shared
    history): block by block past the kernel's length >= 100 dB to the JAX
    ``fir_step``, and > 95 dB to float64."""
    B = 4096
    kernel = _long_kernel(taps, seed=taps)
    peff = pt_fir.fir(kernel, B, device=CPU)
    jeff = jx_fir.fir(kernel, B)
    assert len(peff.params.parts) == {40000: 1, 65000: 2}[taps]
    x = (np.random.default_rng(taps).standard_normal((1, nb * B)) * 0.4
         ).astype(np.float32)
    pst, jst = peff.state((1,)), jeff.init_state(jeff.params, (1,))
    got, want = [], []
    for i in range(nb):
        blk = x[:, i * B:(i + 1) * B]
        pst, py = peff.step(peff.params, pst, torch.from_numpy(blk))
        jst, jy = jeff.step(jeff.params, jst, jnp.asarray(blk))
        got.append(py.numpy())
        want.append(np.asarray(jy))
    got, want = np.concatenate(got, -1), np.concatenate(want, -1)
    assert snr_db(want, got) >= 100.0
    assert snr_db(conv_oracle(x, kernel), got) > 95.0


def test_chain8_streams_at_32768_fused_like_jax_chain_step():
    """chain8 at B=32,768: its three filters fuse into ONE FIR as in the JAX
    Chain (65,529 stripped taps), which streams in two partitions of the
    largest window, 65,536. The fused stage streamed block by block against
    the JAX chain's fused FIR step >= 100 dB (the whole chain streams at
    this block size on the card, chip_smoke.py's ``long_windows``: the
    port's plain dynamics step walks 32,768 samples a block in Python,
    some 13 s a block here)."""
    Bb, nb = 32768, 4
    jchain = jx.Chain(_chain8_effects(jx, jx.EngineConfig(44100, Bb)))
    pchain = pt.Chain(_chain8_effects(pt, pt.EngineConfig(44100, Bb),
                                      device=CPU), device=CPU)
    assert [e.name for e in pchain.exec_effects] == \
        [FIR_NAME, DYN_NAME, TAIL8_NAME]
    fir_e, jfir = pchain.exec_effects[0], jchain.exec_effects[0]
    assert jfir.name == FIR_NAME
    np.testing.assert_array_equal(fir_e.lti_kernel, jfir.lti_kernel)
    assert fir_e.params.kernel_len == 65529
    assert [(q.plan.n, q.add) for q in fir_e.params.parts] == \
        [(65536, False), (65536, True)]
    x = _signal(2, nb * Bb, seed=18)
    jst = jfir.init_state(jfir.params, (2,))
    pst = fir_e.state((2,))
    got, want = [], []
    for i in range(nb):
        blk = x[:, i * Bb:(i + 1) * Bb]
        jst, jy = jfir.step(jfir.params, jst, jnp.asarray(blk))
        pst, py = fir_e.step(fir_e.params, pst, torch.from_numpy(blk))
        want.append(np.asarray(jy))
        got.append(py.numpy())
    got, want = np.concatenate(got, -1), np.concatenate(want, -1)
    assert np.abs(got).max() > 0.1
    assert snr_db(want, got) >= 100.0
    assert snr_db(conv_oracle(x, fir_e.lti_kernel), got) > 95.0
