"""PyTorch/CUDA port, the drop-in ``compat`` API: every ``Create*`` device
chunk by chunk on ``device="cpu"`` against the JAX package's compat device
on the same chunks (numpy in, numpy out, the same length), the reference's
chunking and utility functions, and the wav helpers on a generated file."""

import numpy as np
import pytest
import torch

import pyaudiodsptools_tpu.compat as jcompat
import pyaudiodsptools_tpu_torch.compat as pcompat

from torch_port_util import snr_db

SR, CHUNK = 44100, 512

# (class, constructor args, method): every device the JAX compat exports
DEVICES = [
    ("CreateHighCutFilter", (8000,), "apply"),
    ("CreateLowCutFilter", (800,), "apply"),
    ("CreateEQ3BandFFT", (250, 2.0, 1500, -1.5, 6000, 2.5), "apply"),
    ("CreateEQ3Band", (200, 3.5, 1000, -2.5, 8000, 4.0), "applylowband"),
    ("CreateEQ3Band", (200, 3.5, 1000, -2.5, 8000, 4.0), "applymidband"),
    ("CreateEQ3Band", (200, 3.5, 1000, -2.5, 8000, 4.0), "applyhighband"),
    ("CreateCompressor", (-18, 0.6, 3.1, 30.1), "apply"),
    ("CreateGate", (-30, 0.1, 3.1, 200.1), "apply"),
    ("CreateDelay", (150, 2), "apply"),
    ("CreateDelay", (40, 2, 40, 12000, True, True), "apply"),
    ("CreateTremolo", (0.4, 4.5), "apply"),
    ("CreateSaturator", (-20.0, 2.0, "hard"), "apply"),
    ("CreateSoftClipper", (0.44,), "apply"),
    ("CreateHardDistortion", (), "apply"),
    ("CreateBitCrusher", (), "apply"),
    ("CreateReverb", (300,), "applyreverb"),
    ("CreateLowCutFilterGPU", (160,), "apply"),
    ("CreateHighCutFilterGPU", (12000,), "apply"),
    ("CreateEQ3BandFFTGPU", (250, 2.0, 1500, -1.5, 6000, 2.5), "apply"),
]


@pytest.fixture
def configured():
    jcompat.config.initialize(SR, CHUNK)
    pcompat.config.initialize(SR, CHUNK, device="cpu")
    yield
    pcompat.config.initialize(SR, CHUNK, device="cpu")


def _music(n, seed):
    """Noise bursts over a quiet floor, so that the dynamics trigger."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    env = (np.sin(2 * np.pi * t / 3000.0) > 0.0) * 0.5 + 0.01
    return np.clip(rng.standard_normal(n) * env, -0.99, 0.99
                   ).astype(np.float32)


@pytest.mark.parametrize("name,args,method", DEVICES,
                         ids=[f"{d[0]}.{d[2]}" for d in DEVICES])
def test_device_matches_jax_compat_chunk_by_chunk(configured, name, args,
                                                  method):
    x = _music(40 * CHUNK, seed=len(name) + len(method))
    pdev = getattr(pcompat, name)(*args)
    jdev = getattr(jcompat, name)(*args)
    got, want = [], []
    for c in pcompat.MakeChunks(x):
        y = getattr(pdev, method)(c)
        assert isinstance(y, np.ndarray) and y.shape == c.shape \
            and y.dtype == np.float32
        got.append(y)
        want.append(np.asarray(getattr(jdev, method)(c.copy())))
    got, want = np.concatenate(got), np.concatenate(want)
    assert np.abs(want).max() > 0.01
    assert snr_db(want, got) >= 100.0
    # a tensor in gives numpy out too
    assert isinstance(getattr(pdev, method)(torch.zeros(CHUNK)), np.ndarray)


def test_gpu_names_are_aliases_and_reset(configured):
    assert pcompat.CreateLowCutFilterGPU is pcompat.CreateLowCutFilter
    assert pcompat.CreateHighCutFilterGPU is pcompat.CreateHighCutFilter
    assert pcompat.CreateEQ3BandFFTGPU is pcompat.CreateEQ3BandFFT
    assert sorted(pcompat.__all__) == sorted(jcompat.__all__)
    trem = pcompat.CreateTremolo()
    x = _music(CHUNK, 1)
    first = trem.apply(x)
    trem.apply(x)
    trem.reset()
    np.testing.assert_array_equal(trem.apply(x), first)


def test_devices_run_on_the_configured_device(configured):
    f = pcompat.CreateLowCutFilter(800)
    assert f._effect.device == torch.device("cpu")
    assert pcompat.config.use_gpu is False
    pcompat.config.initialize(SR, CHUNK, use_gpu=True, device="cpu")
    assert pcompat.CreateReverb(100)._effect.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pcompat.config.initialize(SR, CHUNK)


@pytest.mark.parametrize("n", [1000, 4096, 44100, 5000])
def test_chunking_matches_jax_exactly(configured, n):
    x = _music(n, seed=n)
    got, want = pcompat.MakeChunks(x), jcompat.MakeChunks(x)
    assert [len(c) for c in got] == [len(c) for c in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pcompat.CombineChunks(got),
                                  jcompat.CombineChunks(want))


def test_utilities_match_jax_compat(configured):
    a, b = _music(3000, 2), _music(3000, 3)
    np.testing.assert_array_equal(pcompat.MixSignals(a, b),
                                  jcompat.MixSignals(a, b))
    np.testing.assert_array_equal(pcompat.VolumeChange(a, 6.0),
                                  jcompat.VolumeChange(a, 6.0))
    assert pcompat.InfodBV(a) == jcompat.InfodBV(a)
    ints = pcompat.ConvertdBVTo16Bit(a)
    np.testing.assert_array_equal(ints, jcompat.ConvertdBVTo16Bit(a))
    assert pcompat.InfodBV16Bit(ints) == jcompat.InfodBV16Bit(ints)
    np.testing.assert_array_equal(pcompat.Convert16BitTodBV(ints),
                                  jcompat.Convert16BitTodBV(ints))
    for fn in ("Dither16BitTo8Bit", "Dither32BitIntTo16BitInt"):
        src = ints if fn == "Dither16BitTo8Bit" else ints.astype(np.int32) * 65535
        np.testing.assert_array_equal(
            getattr(pcompat, fn)(src, np.random.default_rng(4)),
            getattr(jcompat, fn)(src, np.random.default_rng(4)))
    for fn in ("CreateSinewave", "CreateSquarewave"):
        np.testing.assert_array_equal(getattr(pcompat, fn)(440, 2000),
                                      getattr(jcompat, fn)(440, 2000))
    np.testing.assert_array_equal(
        pcompat.CreateWhitenoise(4000, np.random.default_rng(5)),
        jcompat.CreateWhitenoise(4000, np.random.default_rng(5)))


def test_wav_helpers_on_a_generated_file(configured, tmp_path):
    mono = _music(5000, 6) * 0.5
    left, right = _music(5000, 7) * 0.5, _music(5000, 8) * 0.5
    pcompat.NumpyFloatToWav(str(tmp_path / "mono.wav"), mono)
    pcompat.NumpyFloatToWav(str(tmp_path / "stereo.wav"),
                            np.stack([left, right]))
    got = pcompat.MonoWavToNumpyFloat(str(tmp_path / "mono.wav"))
    np.testing.assert_array_equal(
        got, jcompat.MonoWavToNumpyFloat(str(tmp_path / "mono.wav")))
    # x32767 and truncation on write, /32768 on read (the reference's scales)
    assert np.abs(got - mono).max() <= 2.0 / 32767
    np.testing.assert_array_equal(
        pcompat.MonoWavToNumpy16BitInt(str(tmp_path / "mono.wav")),
        jcompat.MonoWavToNumpy16BitInt(str(tmp_path / "mono.wav")))
    pl, pr = pcompat.StereoWavToNumpyFloat(str(tmp_path / "stereo.wav"))
    jl, jr = jcompat.StereoWavToNumpyFloat(str(tmp_path / "stereo.wav"))
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(pr, jr)
    assert np.abs(pr - right).max() <= 2.0 / 32767
