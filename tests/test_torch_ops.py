"""PyTorch/CUDA port, per op: the same numpy inputs through the JAX op's
``offline`` and the port's, on the CPU (the port with ``device="cpu"``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyaudiodsptools_tpu as jx
import pyaudiodsptools_tpu_torch as pt
from pyaudiodsptools_tpu.ops.tremolo import phase_schedule as jx_phase_schedule
from pyaudiodsptools_tpu_torch.ops.tremolo import phase_schedule

from torch_port_util import snr_db

CPU = "cpu"
JCFG = jx.EngineConfig(sample_rate=44100, block_size=512)
PCFG = pt.EngineConfig(sample_rate=44100, block_size=512)


def _signal(shape, seed=0, scale=0.6):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _both(jeff, peff, blocks):
    want = np.asarray(jeff.offline(jeff.params, jnp.asarray(blocks)))
    got = peff.offline(peff.params, torch.from_numpy(blocks)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    return want, got


# Waveshapers: elementwise f32 formulas; the libraries' pow and sin differ by
# ulps, so the bar is in dB (120, far above the 60 dB parity contract).
@pytest.mark.parametrize("name,args", [
    ("saturator", ()), ("saturator", (-18.0, 1.5, "soft")),
    ("softclipper", (0.44,)), ("softclipper", (1.7,)),
    ("harddistortion", ()),
])
def test_waveshaper_matches_jax(name, args):
    blocks = _signal((3, 9, 512), seed=len(name), scale=0.7)
    blocks[0, 0, :8] = [0.0, -0.0, 1.0, -1.0, 1.5, -2.5, 0.8, -0.8]
    want, got = _both(getattr(jx.ops, name)(JCFG, *args),
                      getattr(pt.ops, name)(PCFG, *args, device=CPU), blocks)
    assert snr_db(want, got) >= 120.0


def test_harddistortion_maps_silence_to_offset():
    e = pt.ops.harddistortion(PCFG, device=CPU)
    y = e.offline(e.params, torch.zeros(1, 2, 8))
    assert torch.allclose(y, torch.full_like(y, 0.8 + 0.2 * np.sin(-4.0)))
    assert float(y[0, 0, 0]) > 0.9


def test_bitcrusher_exact_with_out_of_range():
    blocks = _signal((2, 5, 512), seed=3, scale=0.8)
    # out of [-1, 1]: the int32 -> int16 cast wraps instead of saturating,
    # and negative values take FLOOR division
    blocks[0, 0, :10] = [1.2, -1.2, 1.9999, -2.0, 3.3, -3.3, 1.0, -1.0,
                         -1e-5, 1e-5]
    want, got = _both(jx.ops.bitcrusher(JCFG),
                      pt.ops.bitcrusher(PCFG, device=CPU), blocks)
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("sr,B,depth,hz,nb", [
    (44100, 512, 0.3, 5.0, 40),     # the flagship tremolo
    (44100, 4096, 0.3, 5.0, 12),
    (32768, 512, 0.5, 16.0, 12),    # L = 2048 = 4 blocks: the freeze quirk
    (44100, 441, 0.4, 4.5, 30),     # non-integer sr/hz, odd block
])
def test_tremolo_matches_jax(sr, B, depth, hz, nb):
    jeff = jx.ops.tremolo(jx.EngineConfig(sr, B), depth, hz)
    peff = pt.ops.tremolo(pt.EngineConfig(sr, B), depth, hz, device=CPU)
    assert peff.params.lfo_length == jeff.params.lfo_length
    np.testing.assert_array_equal(
        phase_schedule(peff.params, nb),
        jx_phase_schedule(jeff.params, nb))
    np.testing.assert_array_equal(peff.params.lfo.numpy(),
                                  np.asarray(jeff.params.lfo))
    want, got = _both(jeff, peff, _signal((2, nb, B), seed=B))
    assert snr_db(want, got) >= 120.0


def test_tremolo_freeze_quirk_is_hit():
    peff = pt.ops.tremolo(pt.EngineConfig(32768, 512), 0.5, 16.0, device=CPU)
    phases = phase_schedule(peff.params, 12)
    # three free blocks, then the rolling copy holds exactly one block and
    # the phase never moves again
    assert list(phases[:4]) == [0, 512, 1024, 1536]
    assert len(set(phases[3:])) == 1


def test_tremolo_step_folds_to_offline():
    peff = pt.ops.tremolo(pt.EngineConfig(32768, 512), 0.5, 16.0, device=CPU)
    blocks = torch.from_numpy(_signal((2, 10, 512), seed=8))
    state = peff.state((2,))
    outs = []
    for i in range(blocks.shape[-2]):
        state, y = peff(state, blocks[:, i])
        outs.append(y)
    # step reads the f64-built table, offline evaluates the LFO in f32
    assert snr_db(peff.offline(peff.params, blocks).numpy(),
                  torch.stack(outs, dim=-2).numpy()) >= 120.0


# Delay: shifted adds of f32 products, the same operations in the same order
# in both packages, so the comparison is exact.
@pytest.mark.parametrize("ms,loops,wet,nb", [
    (150.0, 2, False, 40),    # the flagship delay
    (9.0, 3, True, 6),        # wet only
    (60.0, 4, False, 10),     # taps 3 and 4 land at or beyond the signal end
    (0.0, 2, False, 3),       # zero-length delay: taps on the dry sample
])
def test_delay_matches_jax_exactly(ms, loops, wet, nb):
    jeff = jx.ops.delay(JCFG, ms, loops, wet=wet)
    peff = pt.ops.delay(PCFG, ms, loops, wet=wet, device=CPU)
    np.testing.assert_array_equal(peff.params.ramp.numpy(),
                                  np.asarray(jeff.params.ramp))
    np.testing.assert_array_equal(peff.lti_kernel, jeff.lti_kernel)
    want, got = _both(jeff, peff, _signal((2, nb, 512), seed=loops))
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("wet", [False, True])
def test_delay_step_folds_to_offline(wet):
    peff = pt.ops.delay(PCFG, 30.0, 3, wet=wet, device=CPU)
    blocks = torch.from_numpy(_signal((2, 14, 512), seed=5))
    state = peff.state((2,))
    outs = []
    for i in range(blocks.shape[-2]):
        state, y = peff(state, blocks[:, i])
        outs.append(y)
    got = torch.stack(outs, dim=-2).numpy()
    want = peff.offline(peff.params, blocks).numpy()
    # the buffer accumulates taps in arrival order, offline in tap order:
    # same terms, another order of f32 additions
    assert snr_db(want, got) >= 130.0


def test_delay_offline_leaves_its_input_alone():
    peff = pt.ops.delay(PCFG, 9.0, 2, device=CPU)
    blocks = torch.from_numpy(_signal((1, 6, 512), seed=6))
    keep = blocks.clone()
    peff.offline(peff.params, blocks)
    assert torch.equal(blocks, keep)


def test_delay_prefilter_offline_rides_the_fir():
    jeff = jx.ops.delay(JCFG, 20.0, 2, use_lowcut_filter=True,
                        use_highcut_filter=True)
    peff = pt.ops.delay(PCFG, 20.0, 2, use_lowcut_filter=True,
                        use_highcut_filter=True, device=CPU)
    want, got = _both(jeff, peff, _signal((2, 20, 512), seed=7))
    assert snr_db(want, got) >= 100.0
    # streaming, the pre-filters ride the FIR step with their own histories
    blocks = _signal((2, 20, 512), seed=7)
    jst, pst = jeff.init_state(jeff.params, (2,)), peff.state((2,))
    assert sorted(pst) == sorted(jst) == ["buffer", "highcut", "lowcut"]
    outs, jouts = [], []
    for i in range(blocks.shape[-2]):
        pst, y = peff(pst, torch.from_numpy(blocks[:, i]))
        jst, jy = jeff.step(jeff.params, jst, jnp.asarray(blocks[:, i]))
        outs.append(y.numpy())
        jouts.append(np.asarray(jy))
    assert snr_db(np.stack(jouts, -2), np.stack(outs, -2)) >= 100.0
    assert snr_db(got, np.stack(outs, -2)) >= 100.0


def test_block_roundtrip_and_config():
    sig = torch.arange(1000, dtype=torch.float32).reshape(2, 500)
    blocks = pt.block.make_blocks(sig, 128)
    assert blocks.shape == (2, 4, 128)
    assert torch.equal(pt.block.combine_blocks(blocks, 500), sig)
    assert pt.block.combine_blocks(blocks).shape == (2, 512)
    assert PCFG.ms_to_samples(150.0) == JCFG.ms_to_samples(150.0)
    assert PCFG.dtype == torch.float32
    with pytest.raises(ValueError):
        pt.EngineConfig(block_size=0)
