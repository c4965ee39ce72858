"""PyTorch/CUDA port, the core utilities (``core/block.py``'s legacy chunk
partition, ``core/utility.py``, ``core/generators.py``, ``core/metering.py``)
against the JAX package's on the same numpy inputs, on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyaudiodsptools_tpu.core import block as jx_block
from pyaudiodsptools_tpu.core import generators as jx_gen
from pyaudiodsptools_tpu.core import metering as jx_meter
from pyaudiodsptools_tpu.core import utility as jx_util
from pyaudiodsptools_tpu_torch.core import block as pt_block
from pyaudiodsptools_tpu_torch.core import generators as pt_gen
from pyaudiodsptools_tpu_torch.core import metering as pt_meter
from pyaudiodsptools_tpu_torch.core import utility as pt_util

from torch_port_util import snr_db

CPU = "cpu"


def _chunks(fn, n, c):
    try:
        return fn(n, c)
    except ValueError:
        return "raises"


@pytest.mark.parametrize("chunk", [1, 7, 64, 500, 512, 4096])
def test_legacy_chunk_sizes_and_padded_length_match_jax(chunk):
    """Over a grid of lengths, the reference's MakeChunks partition (pad
    only when the length is not a multiple of the chunk COUNT, and the
    shapes on which the reference fails) and the padded length equal the
    JAX package's."""
    for n in list(range(1, 1100, 7)) + [1000, 44100, 65536, 131071]:
        assert _chunks(pt_block.legacy_chunk_sizes, n, chunk) == \
            _chunks(jx_block.legacy_chunk_sizes, n, chunk), (n, chunk)
        assert pt_block.padded_length(n, chunk) == \
            jx_block.padded_length(n, chunk)
    # the reference's quirk: 1000 samples at 512 are two chunks of 500
    assert pt_block.legacy_chunk_sizes(1000, 512) == [500, 500]


def _signals(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(n) * 0.6).astype(np.float32)
    b = (rng.standard_normal(n) * 0.6).astype(np.float32)
    return a, b


def _close(want, got, rtol=1e-6, atol=0.0):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.shape == got.shape and want.dtype == got.dtype, \
        (want.shape, got.shape, want.dtype, got.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_mix_volume_and_dbv_match_jax():
    a, b = _signals()
    t = lambda v: torch.from_numpy(v)
    _close(jx_util.mix_signals(jnp.asarray(a), jnp.asarray(b)),
           pt_util.mix_signals(t(a), t(b)))
    for gain, protect in ((6.0, True), (-12.0, True), (9.5, False)):
        _close(jx_util.volume_change(jnp.asarray(a), gain, protect),
               pt_util.volume_change(t(a), gain, protect))
    _close(jx_util.info_dbv(jnp.asarray(a)), pt_util.info_dbv(t(a)))
    # numpy in: the device is named
    _close(jx_util.info_dbv(jnp.asarray(a)), pt_util.info_dbv(a, device=CPU))
    ints = (a * 20000).astype(np.int16)
    _close(jx_util.info_dbv_16bit(jnp.asarray(ints)),
           pt_util.info_dbv_16bit(t(ints)))


def test_16bit_conversions_match_jax_exactly():
    a, _ = _signals(1)
    a = np.concatenate([a * 2, [1.0, -1.0, 0.99999, -0.99999, 0.0]]
                       ).astype(np.float32)
    want = np.asarray(jx_util.dbv_to_16bit(jnp.asarray(a)))
    got = pt_util.dbv_to_16bit(torch.from_numpy(a)).numpy()
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    _close(jx_util.from_16bit_to_dbv(jnp.asarray(want)),
           pt_util.from_16bit_to_dbv(torch.from_numpy(want.copy())))


@pytest.mark.parametrize("which", ["16to8", "32to16"])
def test_dithers_round_then_dither_down_and_clip(which):
    """The two packages draw other random numbers; what both must give is
    round(x / scale) or one less, clipped, with both values occurring."""
    rng = np.random.default_rng(2)
    gen = torch.Generator().manual_seed(0)
    if which == "16to8":
        x = rng.integers(-32768, 32768, 20000).astype(np.int16)
        got = pt_util.dither_16bit_to_8bit(gen, torch.from_numpy(x)).numpy()
        jgot = np.asarray(jx_util.dither_16bit_to_8bit(
            jax.random.PRNGKey(0), jnp.asarray(x)))
        rounded = np.round(x.astype(np.float32) / 256.0).astype(np.int64)
        lim, dtype = 127, np.int16
    else:
        x = rng.integers(-2 ** 31, 2 ** 31, 20000).astype(np.int32)
        got = pt_util.dither_32bit_to_16bit(gen, torch.from_numpy(x)).numpy()
        jgot = np.asarray(jx_util.dither_32bit_to_16bit(
            jax.random.PRNGKey(0), jnp.asarray(x)))
        rounded = np.round(x.astype(np.float32) / 65535.0).astype(np.int64)
        lim, dtype = 32767, np.int16
    for out in (got, jgot):
        assert out.dtype == dtype and out.shape == x.shape
        d = out.astype(np.int64)
        ok = (d == np.clip(rounded, -lim, lim)) \
            | (d == np.clip(rounded - 1, -lim, lim))
        assert ok.all()
        assert np.abs(d).max() <= lim
    inside = np.abs(rounded) < lim - 1
    diff = rounded[inside] - got.astype(np.int64)[inside]
    assert set(np.unique(diff)) == {0, 1}


def test_sine_and_square_match_jax():
    for f, n, sr in ((440.0, 5000, 44100), (1000.0, 4800, 48000),
                     (13.7, 777, 22050)):
        want = np.asarray(jx_gen.sine(f, n, sr))
        got = pt_gen.sine(f, n, sr, device=CPU).numpy()
        assert got.dtype == np.float32
        assert snr_db(want, got) >= 100.0
        np.testing.assert_array_equal(
            pt_gen.square(f, n, sr, device=CPU).numpy(),
            np.asarray(jx_gen.square(f, n, sr)))


@pytest.mark.parametrize("n,low,high", [(4099, 20.0, 20000.0),
                                        (8192, 300.0, 3000.0)])
def test_whitenoise_magnitude_spectrum_matches_jax(n, low, high):
    """Random phases differ between the packages; the magnitude spectrum
    (unit in the band, zero outside, conjugate symmetric) does not."""
    got = pt_gen.whitenoise(torch.Generator().manual_seed(3), n, 44100, low,
                            high, device=CPU).numpy()
    want = np.asarray(jx_gen.whitenoise(jax.random.PRNGKey(3), n, 44100, low,
                                        high))
    assert got.dtype == np.float32 and got.shape == (n,)
    mg = np.abs(np.fft.fft(got.astype(np.float64)))
    mw = np.abs(np.fft.fft(want.astype(np.float64)))
    np.testing.assert_allclose(mg, mw, rtol=1e-4, atol=1e-4 * mw.max())
    freqs = np.abs(np.fft.fftfreq(n, 1 / 44100))
    outside = (freqs < low) | (freqs > high)
    assert mg[outside].max() <= 1e-4 * mg.max()
    assert not np.allclose(got, want)             # other phases


def test_meters_match_jax():
    a, b = _signals(4, 4096)
    blocks = np.stack([a, b * 2.0]).reshape(2, 8, 512)
    jm = jx_meter.block_meters(jnp.asarray(blocks))
    pm = pt_meter.block_meters(torch.from_numpy(blocks))
    for k in ("peak", "rms"):
        _close(jm[k], pm[k])
    js = jx_meter.summary_meters(jnp.asarray(blocks[1]))
    ps = pt_meter.summary_meters(torch.from_numpy(blocks[1]))
    for k in ("peak", "rms"):
        _close(js[k], ps[k])
    # a level in dB near 0 dB: 1e-6 dB (the float32 means, summed in
    # another order, differ in their last bit)
    _close(js["dbv"], ps["dbv"], rtol=0.0, atol=1e-6)
    assert int(ps["clipped"]) == int(js["clipped"]) > 0
