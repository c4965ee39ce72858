"""Drop-in compatibility namespace for ``pyAudioDspTools`` users.

    import pyaudiodsptools_tpu_torch.compat as pyAudioDspTools
    pyAudioDspTools.config.initialize(44100, 512)      # on the card
    pyAudioDspTools.config.initialize(44100, 512, device="cpu")
    f = pyAudioDspTools.CreateLowCutFilter(800)
    out = f.apply(chunk)                               # numpy in, numpy out

Counterpart of ``pyaudiodsptools_tpu/compat``: the reference's public API
plus its unexported devices (Reverb, BitCrusher), backed by the port's ops.
"""

from . import config
from .devices import (CreateBitCrusher, CreateCompressor, CreateDelay,
                      CreateEQ3Band, CreateEQ3BandFFT, CreateEQ3BandFFTGPU,
                      CreateGate, CreateHardDistortion, CreateHighCutFilter,
                      CreateHighCutFilterGPU, CreateLowCutFilter,
                      CreateLowCutFilterGPU, CreateReverb, CreateSaturator,
                      CreateSoftClipper, CreateTremolo)
from .utility import (CombineChunks, Convert16BitTodBV, ConvertdBVTo16Bit,
                      CreateSinewave, CreateSquarewave, CreateWhitenoise,
                      Dither16BitTo8Bit, Dither32BitIntTo16BitInt, InfodBV,
                      InfodBV16Bit, MakeChunks, MixSignals,
                      MonoWavToNumpy16BitInt, MonoWavToNumpyFloat,
                      NumpyFloatToWav, StereoWavToNumpyFloat, VolumeChange)

__all__ = [
    "config",
    "CreateBitCrusher", "CreateCompressor", "CreateDelay", "CreateEQ3Band",
    "CreateEQ3BandFFT", "CreateEQ3BandFFTGPU", "CreateGate",
    "CreateHardDistortion", "CreateHighCutFilter", "CreateHighCutFilterGPU",
    "CreateLowCutFilter", "CreateLowCutFilterGPU", "CreateReverb",
    "CreateSaturator", "CreateSoftClipper", "CreateTremolo",
    "CombineChunks", "Convert16BitTodBV", "ConvertdBVTo16Bit",
    "CreateSinewave", "CreateSquarewave", "CreateWhitenoise",
    "Dither16BitTo8Bit", "Dither32BitIntTo16BitInt", "InfodBV", "InfodBV16Bit",
    "MakeChunks", "MixSignals", "MonoWavToNumpy16BitInt", "MonoWavToNumpyFloat",
    "NumpyFloatToWav", "StereoWavToNumpyFloat", "VolumeChange",
]
