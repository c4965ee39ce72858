"""PyTorch/CUDA port, the reverb (``ops/reverb.py``): offline (the combined
kernel through the partitioned FIR), streamed block by block through the
two lines' structure, the JAX state and params carried across in mid-stream, and a
lowcut fused with a reverb in a Chain as the JAX package fuses them; against
the JAX package on the CPU and a float64 oracle."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pyaudiodsptools_tpu as jx
import pyaudiodsptools_tpu_torch as pt
from pyaudiodsptools_tpu_torch import convert

from torch_port_util import snr_db, spec_from_jax

# the module (``ops.reverb`` is the factory)
pt_rev = importlib.import_module("pyaudiodsptools_tpu_torch.ops.reverb")

CPU = "cpu"


def fft_conv64(x: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """float64 ``conv(x[c], kernel)[:T]`` through one FFT of the whole
    signal (a 66,000-tap kernel is too long for np.convolve here)."""
    T = x.shape[-1]
    n = 1 << int(np.ceil(np.log2(T + len(kernel))))
    return np.fft.irfft(np.fft.rfft(x.astype(np.float64), n)
                        * np.fft.rfft(kernel, n), n)[..., :T]


def _signal(C, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((C, n)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("ms,B", [(120.0, 512), (1500.0, 512),
                                  (1500.0, 4096)])
def test_offline_routes_match_jax_and_oracle(ms, B):
    """The effect's ``offline``, the combined kernel through the partitioned
    FIR, >= 100 dB to the JAX ``offline`` (its combined kernel's segmented
    conv) and > 95 dB to float64, on a signal longer than the reverb; in 4
    (B=512) and 5 (B=4096) partitions at 1,500 ms."""
    pe = pt.ops.reverb(pt.EngineConfig(44100, B), ms, device=CPU)
    je = jx.ops.reverb(jx.EngineConfig(44100, B), ms)
    np.testing.assert_array_equal(pe.lti_kernel, je.lti_kernel)
    assert pe.offline is pt_rev.offline_fir
    if ms == 1500.0:
        assert len(pe.params.full.plans) == {512: 4, 4096: 5}[B]
        assert pe.params.full.kernel_len == {512: 65033, 4096: 66825}[B]
    nb = -(-(len(pe.lti_kernel) + 4096) // B)
    x = _signal(2, nb * B, seed=B + int(ms))
    blocks = x.reshape(2, nb, B)
    want = np.asarray(je.offline(je.params, jnp.asarray(blocks))
                      ).reshape(2, -1)
    oracle = fft_conv64(x, pe.lti_kernel)
    got = pt_rev.offline_fir(pe.params, torch.from_numpy(blocks)
                             ).reshape(2, -1)
    assert got.dtype == torch.float32
    assert snr_db(want, got.numpy()) >= 100.0
    assert snr_db(oracle, got.numpy()) > 95.0


@pytest.mark.parametrize("rate", [22050, 48000])
def test_conversion_needs_the_rate_the_lines_were_designed_for(rate):
    """A JAX reverb built at another rate than 44,100 Hz converts, with the
    rate in its description, to the port's own reverb at that rate (the
    lines' high-cuts equal, >= 100 dB to the JAX ``offline``); described at
    44,100 Hz its lines do not sum to its kernel and the conversion
    raises."""
    B = 512
    je = jx.ops.reverb(jx.EngineConfig(rate, B), 120.0)
    pe = pt.ops.reverb(pt.EngineConfig(rate, B), 120.0, device=CPU)
    got = convert.chain_from_numpy(spec_from_jax([je], rate), CPU).effects[0]
    for key in ("line1", "line2"):
        for a, b in zip(getattr(got.params, key).highcut.parts,
                        getattr(pe.params, key).highcut.parts):
            assert torch.equal(a.plan.spectrum_dif, b.plan.spectrum_dif)
    nb = -(-(len(pe.lti_kernel) + 2048) // B)
    blocks = _signal(2, nb * B, seed=rate).reshape(2, nb, B)
    want = np.asarray(je.offline(je.params, jnp.asarray(blocks)))
    out = got.offline(got.params, torch.from_numpy(blocks)).numpy()
    assert snr_db(want, out) >= 100.0
    with pytest.raises(ValueError, match="another sample rate"):
        convert.chain_from_numpy(spec_from_jax([je], 44100), CPU)


_jax_step = jax.jit(importlib.import_module(
    "pyaudiodsptools_tpu.ops.reverb").step)


@pytest.mark.parametrize("B", [512, 4096])
def test_step_matches_jax_step_with_state_carried_mid_stream(B):
    """reverb(120) streamed block by block: the first half through the JAX
    step, its state (two line buffers, two high-cut histories) and params
    carried across, the second half through the port (its own factory's
    effect and the one built from the JAX params), >= 100 dB to the JAX
    step's own second half; a stream from silence through the port alone
    >= 100 dB to the JAX step and to the offline render. At B=4096 the taps
    (52 and 105 samples apart) overlap within a block: 79 and 40 groups."""
    ms = 120.0
    pcfg, jcfg = pt.EngineConfig(44100, B), jx.EngineConfig(44100, B)
    pe = pt.ops.reverb(pcfg, ms, device=CPU)
    je = jx.ops.reverb(jcfg, ms)
    groups = [len(pt_rev.tap_groups(p.time_in_samples, p.n_taps, B))
              for p in (pe.params.line1, pe.params.line2)]
    assert groups == ({512: [10, 5], 4096: [79, 40]}[B])
    nb = 2 * -(-(len(pe.lti_kernel) + B) // B)
    x = _signal(2, nb * B, seed=B)
    jst = je.init_state(je.params, (2,))
    pst = pe.state((2,))
    want, got = [], []
    for i in range(nb):
        blk = x[:, i * B:(i + 1) * B]
        if i == nb // 2:
            mid = jst
        jst, jy = _jax_step(je.params, jst, jnp.asarray(blk))
        pst, py = pe.step(pe.params, pst, torch.from_numpy(blk))
        want.append(np.asarray(jy))
        got.append(py.numpy())
    want, got = np.concatenate(want, -1), np.concatenate(got, -1)
    assert snr_db(want, got) >= 100.0
    off = pe.offline(pe.params, torch.from_numpy(x.reshape(2, nb, B)))
    assert snr_db(off.reshape(2, -1).numpy(), got) >= 100.0
    # the hand-over
    leaves = [np.asarray(v) for v in jax.tree.flatten((mid,))[0]]
    assert len(leaves) == 4
    built = convert.chain_from_numpy(spec_from_jax([je]), CPU)
    own = pt.Chain([pe], device=CPU)
    assert built.exec_effects[0].name == "reverb"
    for chain in (built, own):
        st = convert.state_from_numpy(chain, leaves)
        assert st[0]["line1"]["buffer"].shape == mid["line1"]["buffer"].shape
        tail = []
        for i in range(nb // 2, nb):
            st, y = chain.step(st, torch.from_numpy(x[:, i * B:(i + 1) * B]))
            tail.append(y.numpy())
        assert snr_db(want[:, nb // 2 * B:], np.concatenate(tail, -1)) >= 100.0


def test_lowcut_and_reverb_fuse_like_jax():
    """A lowcut and a reverb fuse into ONE FIR as in the JAX Chain
    (``tests/test_fusion.py``), its kernel the JAX one; rendered and
    streamed >= 100 dB to the JAX chain's render."""
    B = 512
    pcfg, jcfg = pt.EngineConfig(44100, B), jx.EngineConfig(44100, B)
    pchain = pt.Chain([pt.ops.lowcut(pcfg, 300.0, device=CPU),
                       pt.ops.reverb(pcfg, 120.0, device=CPU)], device=CPU)
    jchain = jx.Chain([jx.ops.lowcut(jcfg, 300.0), jx.ops.reverb(jcfg, 120.0)])
    assert [e.name for e in pchain.exec_effects] == \
        [e.name for e in jchain.exec_effects] == ["fir_cascade:lowcut+reverb"]
    np.testing.assert_array_equal(pchain.exec_effects[0].lti_kernel,
                                  jchain.exec_effects[0].lti_kernel)
    nb = 16
    x = _signal(2, nb * B, seed=7).reshape(2, nb, B)
    want = np.asarray(jchain.render_blocks(jnp.asarray(x))).reshape(2, -1)
    got = pchain.render_blocks(torch.from_numpy(x)).reshape(2, -1).numpy()
    assert snr_db(want, got) >= 100.0
    st, outs = pchain.init_state((2,)), []
    for i in range(nb):
        st, y = pchain.step(st, torch.from_numpy(x[:, i]))
        outs.append(y.numpy())
    assert snr_db(want, np.concatenate(outs, -1)) >= 100.0


@pytest.mark.parametrize("B", [512, 4096, 32768])
def test_lti_fusion_equals_the_jax_chain_at_every_block_size(B):
    """Every LTI run fuses, whatever its fused kernel's length (here past
    100,000 taps, which streams in partitions), as the JAX Chain fuses it:
    the same members and the same float64 kernel at B = 512, 4,096 and
    32,768."""
    def effects(pkg, cfg, **kw):
        o = pkg.ops
        return [o.lowcut(cfg, 120.0, **kw), o.highcut(cfg, 12000.0, **kw),
                o.delay(cfg, 1000.0, 2, **kw), o.reverb(cfg, 300.0, **kw),
                o.softclipper(cfg, 0.44, **kw)]

    jchain = jx.Chain(effects(jx, jx.EngineConfig(44100, B)))
    pchain = pt.Chain(effects(pt, pt.EngineConfig(44100, B), device=CPU),
                      device=CPU)
    assert [e.name for e in pchain.exec_effects] == \
        [e.name for e in jchain.exec_effects] == \
        ["fir_cascade:lowcut+highcut+delay+reverb", "softclipper"]
    fir_e = pchain.exec_effects[0]
    np.testing.assert_array_equal(fir_e.lti_kernel,
                                  jchain.exec_effects[0].lti_kernel)
    assert fir_e.params.kernel_len > 100000
    assert len(fir_e.params.parts) >= 2
