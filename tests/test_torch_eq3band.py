"""PyTorch/CUDA port, the biquad EQ (``ops/eq3band.py``): ``eq3band`` and
each ``eq_band`` kind, streamed block by block through the float64
recurrence and rendered offline by both routes (the FIR-ised response where
it decays, the recurrence where it does not), against the JAX package's
double-float scan and a float64 numpy recursion with the reference's
one-sample input delay; the JAX state carried across in mid-stream
(``convert.state_from_numpy``) and the JAX params (``chain_from_numpy``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dataclasses
import importlib

import pyaudiodsptools_tpu as jx
import pyaudiodsptools_tpu_torch as pt
from pyaudiodsptools_tpu_torch import convert

from torch_port_util import snr_db, spec_from_jax

# the module (``ops.eq3band`` is the factory)
pt_eq = importlib.import_module("pyaudiodsptools_tpu_torch.ops.eq3band")
jx_eq = importlib.import_module("pyaudiodsptools_tpu.ops.eq3band")

CPU = "cpu"
B = 512
NB = 8

# (factory args, decays within 2**18 samples): the JAX package's parity
# settings (tests/test_ops_parity.py), each band alone, and a low shelf at
# 0.3 Hz whose pole sits so close to the unit circle that its response has
# not decayed to 1e-9 of its peak in 2**18 samples. On such settings the JAX
# package's double-float scan itself sits 91-114 dB from float64 (this one
# 106-113 dB on three signals); the port's float64 recurrence is held to
# both.
SETTINGS = {
    "eq3band": (("eq3band", 200.0, 3.5, 1000.0, -2.5, 8000.0, 4.0), True),
    "low": (("eq_band", "low", 250.0, 6.0), True),
    "mid": (("eq_band", "mid", 1500.0, -4.0), True),
    "high": (("eq_band", "high", 6000.0, 3.0), True),
    "low_0.3Hz": (("eq_band", "low", 0.3, -3.0), False),
}

# The JAX recurrence, jitted once per params structure: the FIR fields,
# which it does not read, are set alike so that the single bands share one
# program.
_jax_offline = jax.jit(jx_eq.offline)
_jax_step = jax.jit(jx_eq.step)


def _recurrence_only(params):
    return dataclasses.replace(params, spectrum_fir=None, use_fir=False,
                               halo_blocks=1, seg_blocks=7)


def _make(pkg, cfg, args, **kw):
    mod = pt_eq if pkg is pt else jx_eq       # the JAX ops export no eq_band
    return getattr(mod, args[0])(cfg, *args[1:], **kw)


def recursion64(rows, x: np.ndarray) -> np.ndarray:
    """The reference's per-sample direct form I, float64, each band fed the
    previous band's float64 output, with the one-sample input delay:
    y[n] = b0 x[n-1] + b1 x[n-2] + b2 x[n-3] - a1 y[n-1] - a2 y[n-2]."""
    y = x.astype(np.float64)
    for b0, b1, b2, a1, a2 in rows:
        out = np.zeros_like(y)
        for c in range(y.shape[0]):
            x1 = x2 = x3 = y1 = y2 = 0.0
            for n, v in enumerate(y[c].tolist()):
                o = b0 * x1 + b1 * x2 + b2 * x3 - a1 * y1 - a2 * y2
                x3, x2, x1 = x2, x1, v
                y2, y1 = y1, o
                out[c, n] = o
        y = out
    return y


def _signal(C, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((C, n)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("name", list(SETTINGS))
def test_eq_steps_and_renders_like_jax_and_float64(name):
    args, decays = SETTINGS[name]
    pe = _make(pt, pt.EngineConfig(44100, B), args, device=CPU)
    je = _make(jx, jx.EngineConfig(44100, B), args)
    assert pe.name == je.name
    assert pe.params.use_fir == je.params.use_fir == decays
    assert pe.time_parallel == decays and pe.lti_kernel is None
    np.testing.assert_allclose(
        pe.params.coeffs.numpy(),
        np.asarray(je.params.coeffs, np.float64)
        + np.asarray(je.params.coeffs_lo, np.float64), rtol=1e-14)
    x = _signal(2, NB * B, seed=len(name))
    oracle = recursion64(pe.params.coeffs.numpy(), x)
    blocks = x.reshape(2, NB, B)
    # the JAX package's recurrence: its whole-signal scan, the function its
    # step runs block by block (its un-jitted step takes seconds a block on
    # the CPU; the test below holds the jitted step across a hand-over)
    jrec = np.asarray(_jax_offline(_recurrence_only(je.params),
                                   jnp.asarray(blocks))).reshape(2, -1)
    # streamed, block by block
    pst = pe.state((2,))
    got = []
    for i in range(NB):
        pst, py = pe.step(pe.params, pst,
                          torch.from_numpy(x[:, i * B:(i + 1) * B]))
        assert py.dtype == torch.float32 and py.shape == (2, B)
        got.append(py.numpy())
    got = np.concatenate(got, -1)
    assert pst["y1"].dtype == torch.float64
    assert snr_db(jrec, got) >= 100.0
    assert snr_db(oracle, got) >= 100.0
    # offline: the effect's own route (FIR-ised where it decays), and the
    # recurrence route on any setting
    off = pe.offline(pe.params, torch.from_numpy(blocks)).reshape(2, -1)
    # (the JAX offline of an undecayed cascade is the recurrence above)
    joff = np.asarray(je.offline(je.params, jnp.asarray(blocks))).reshape(
        2, -1) if decays else jrec
    assert snr_db(joff, off.numpy()) >= 100.0
    assert snr_db(oracle, off.numpy()) >= 100.0
    rec = pt_eq.offline(pe.params, torch.from_numpy(blocks)).reshape(2, -1)
    assert snr_db(jrec, rec.numpy()) >= 100.0
    assert snr_db(oracle, rec.numpy()) >= 100.0


def test_impulse_response_matches_jax():
    """The FIR-ised response, built by the port's pure-numpy recursion, is
    the JAX package's (scipy's lfilter where present) to float64 rounding,
    truncated at the same tap."""
    for args, decays in SETTINGS.values():
        pe = _make(pt, pt.EngineConfig(44100, B), args, device=CPU)
        rows = pe.params.coeffs.numpy()
        h, jh = pt_eq._impulse_response(rows), jx_eq._impulse_response(rows)
        if not decays:
            assert h is None and jh is None
            continue
        assert h.shape == jh.shape
        np.testing.assert_allclose(h, jh, rtol=0, atol=1e-12 * np.abs(jh).max())


@pytest.mark.parametrize("name", ["eq3band"])
def test_jax_state_and_params_carried_across_mid_stream(name):
    """Half a stream through the JAX step, its state leaves (each (hi, lo)
    word pair) and its params carried across, the other half block by block
    in the port: >= 100 dB to the JAX step's own second half. (The JAX step
    takes a chunk of any length: each half is one jitted call.)"""
    args, _ = SETTINGS[name]
    jcfg, pcfg = jx.EngineConfig(44100, B), pt.EngineConfig(44100, B)
    je = _make(jx, jcfg, args)
    pchain = convert.chain_from_numpy(spec_from_jax([je]), CPU)
    own = pt.Chain([_make(pt, pcfg, args, device=CPU)], device=CPU)
    x = _signal(2, NB * B, seed=11)
    half = NB * B // 2
    jstep = _jax_step
    jst, _ = jstep(je.params, je.init_state(je.params, (2,)),
                   jnp.asarray(x[:, :half]))
    _, want = jstep(je.params, jst, jnp.asarray(x[:, half:]))
    leaves = [np.asarray(v) for v in jax.tree.flatten((jst,))[0]]
    assert len(leaves) == 10                     # 5 words x (hi, lo)
    for chain in (pchain, own):
        pst = convert.state_from_numpy(chain, leaves)
        assert pst[0]["x1"].shape == (len(chain.effects[0].params.coeffs), 2)
        got = []
        for i in range(NB // 2, NB):
            pst, py = chain.step(pst, torch.from_numpy(x[:, i * B:(i + 1) * B]))
            got.append(py.numpy())
        assert snr_db(np.asarray(want), np.concatenate(got, -1)) >= 100.0


def test_eq_chunk_length_and_batch_shapes():
    """The recurrence takes any chunk length (the reference's quirk can
    give chunks of 500 at a chunk size of 512), a mono chunk and shorter
    ones than three samples; the result does not depend on the cut."""
    pe = pt.ops.eq3band(pt.EngineConfig(44100, B), 200.0, 3.5, 1000.0, -2.5,
                        8000.0, 4.0, device=CPU)
    x = _signal(1, 1500, seed=5)[0]
    st = pe.state(())
    outs = []
    for lo, hi in ((0, 500), (500, 501), (501, 503), (503, 1500)):
        st, y = pe.step(pe.params, st, torch.from_numpy(x[lo:hi]))
        outs.append(y.numpy())
    whole = pe.step(pe.params, pe.state(()), torch.from_numpy(x))[1]
    assert snr_db(whole.numpy(), np.concatenate(outs)) >= 120.0
    assert snr_db(recursion64(pe.params.coeffs.numpy(), x[None])[0],
                  np.concatenate(outs)) >= 100.0
