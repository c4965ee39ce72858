"""Reference-compatible device classes: ``Create<Name>(params).apply(chunk)``.

Counterpart of ``pyaudiodsptools_tpu/compat/devices.py``. Each class wraps an
effect of :mod:`pyaudiodsptools_tpu_torch.ops` with its state, reproducing
the reference's stateful-object contract: a numpy array (or a tensor) in, a
numpy array of the same length out, so that a pyAudioDspTools user can switch
imports and keep their chunk loop. The effect lives on the device that
:func:`..compat.config.initialize` named (the card unless it named the CPU).
On the card each device replays its own captured step
(``engine/graph.py``), as each JAX device calls its own jitted step: the
first chunk of a length captures the step for that length, later chunks of
it replay the graph. On the CPU ``apply`` steps the effect eagerly under
``torch.inference_mode()``.

Construction snapshots :mod:`..compat.config` like the reference snapshots
its global config.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import ops
from ..engine.graph import CapturedStep
from . import config as _config


class _Device:
    """Base wrapper: owns an Effect and its state (on the card, in its
    captured step's buffers)."""

    def __init__(self, effect):
        self._effect = effect
        self._captured = CapturedStep((effect,), effect.device) \
            if effect.device.type == "cuda" else None
        self._eager_state = None if self._captured is not None \
            else effect.state()

    @property
    def _state(self):
        """The effect's state (on the card a copy of the buffers)."""
        if self._captured is not None:
            return self._captured.state[0]
        return self._eager_state

    def apply(self, float_array_input):
        """Process one chunk, advancing the state (reference contract: the
        output has the exact size of the input)."""
        x = float_array_input
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
        if self._captured is not None:
            return self._captured.replay(x).cpu().numpy()
        x = x.to(device=self._effect.device, dtype=torch.float32)
        with torch.inference_mode():
            self._eager_state, out = self._effect.step(
                self._effect.params, self._eager_state, x)
        return out.cpu().numpy()

    def reset(self):
        if self._captured is not None:
            self._captured.reset()
        else:
            self._eager_state = self._effect.state()


def _cfg_dev():
    return _config.current(), _config.current_device()


class CreateHighCutFilter(_Device):
    """EffectFFTFilter.py parity (1 block latency)."""

    def __init__(self, cutoff_frequency=8000):
        cfg, dev = _cfg_dev()
        super().__init__(ops.highcut(cfg, cutoff_frequency, device=dev))


class CreateLowCutFilter(_Device):
    """EffectFFTFilter.py parity (1 block latency)."""

    def __init__(self, cutoff_frequency=160):
        cfg, dev = _cfg_dev()
        super().__init__(ops.lowcut(cfg, cutoff_frequency, device=dev))


class CreateEQ3BandFFT(_Device):
    """EffectEQ3BandFFT.py parity (1 block latency)."""

    def __init__(self, lowshelf_frequency, lowshelf_db, midband_frequency,
                 midband_db, highshelf_frequency, highshelf_db):
        cfg, dev = _cfg_dev()
        super().__init__(ops.eq3band_fft(
            cfg, lowshelf_frequency, lowshelf_db, midband_frequency,
            midband_db, highshelf_frequency, highshelf_db, device=dev))


class CreateEQ3Band:
    """EffectEQ3Band.py parity: per-band apply methods, zero latency (the
    one-sample input delay of the reference kept). The bands honour the
    configured sampling rate (the reference hard-codes 44100)."""

    def __init__(self, low_shelf_frequency, low_shelf_gain, mid_frequency,
                 mid_gain, high_shelf_frequency, high_shelf_gain):
        cfg, dev = _cfg_dev()
        self._low = _Device(ops.eq_band(cfg, "low", low_shelf_frequency,
                                        low_shelf_gain, device=dev))
        self._mid = _Device(ops.eq_band(cfg, "mid", mid_frequency, mid_gain,
                                        device=dev))
        self._high = _Device(ops.eq_band(cfg, "high", high_shelf_frequency,
                                         high_shelf_gain, device=dev))

    def applylowband(self, float_array_input):
        return self._low.apply(float_array_input)

    def applymidband(self, float_array_input):
        return self._mid.apply(float_array_input)

    def applyhighband(self, float_array_input):
        return self._high.apply(float_array_input)


class CreateCompressor(_Device):
    """EffectCompressor.py parity (zero latency)."""

    def __init__(self, threshold_in_db=-15, ratio=0.60, attack_in_ms=3.1,
                 release_in_ms=30.1):
        cfg, dev = _cfg_dev()
        super().__init__(ops.compressor(cfg, threshold_in_db, ratio,
                                        attack_in_ms, release_in_ms,
                                        device=dev))


class CreateGate(_Device):
    """EffectGate.py parity (zero latency). Envelope lengths honour the
    configured sampling rate (the reference hard-codes 44100)."""

    def __init__(self, threshold_in_db=-5, depth=0.1, attack=3.1,
                 release=200.1):
        cfg, dev = _cfg_dev()
        super().__init__(ops.gate(cfg, threshold_in_db, depth, attack,
                                  release, device=dev))


class CreateDelay(_Device):
    """EffectDelay.py parity (zero latency). Unlike the reference, the
    lowcut / highcut filter options work (the reference calls methods that
    do not exist)."""

    def __init__(self, time_in_ms=500, feedback_loops=2,
                 lowcut_filter_frequency=40, highcut_filter_frequency=12000,
                 use_lowcut_filter=False, use_highcut_filter=False,
                 wet=False):
        cfg, dev = _cfg_dev()
        super().__init__(ops.delay(
            cfg, time_in_ms, feedback_loops, lowcut_filter_frequency,
            highcut_filter_frequency, use_lowcut_filter, use_highcut_filter,
            wet, device=dev))


class CreateTremolo(_Device):
    """EffectTremolo.py parity (zero latency), including ``.reset()``."""

    def __init__(self, tremolo_depth=0.4, lfo_in_hertz=4.5):
        cfg, dev = _cfg_dev()
        super().__init__(ops.tremolo(cfg, tremolo_depth, lfo_in_hertz,
                                     device=dev))


class CreateSaturator(_Device):
    """EffectSaturator.py parity (stateless)."""

    def __init__(self, saturation_threshold_in_db=-20.0, makeup_gain=2.0,
                 mode="hard"):
        cfg, dev = _cfg_dev()
        super().__init__(ops.saturator(cfg, saturation_threshold_in_db,
                                       makeup_gain, mode, device=dev))


class CreateSoftClipper(_Device):
    """EffectSoftClipper.py parity (stateless)."""

    def __init__(self, drive=0.44):
        cfg, dev = _cfg_dev()
        super().__init__(ops.softclipper(cfg, drive, device=dev))


class CreateHardDistortion(_Device):
    """EffectHardDistortion.py parity (stateless)."""

    def __init__(self):
        cfg, dev = _cfg_dev()
        super().__init__(ops.harddistortion(cfg, device=dev))


class CreateBitCrusher(_Device):
    """_EffectBitCrusher.py parity: unexported work in progress in the
    reference, shipped first-class."""

    def __init__(self):
        cfg, dev = _cfg_dev()
        super().__init__(ops.bitcrusher(cfg, device=dev))


class CreateReverb(_Device):
    """_EffectReverb.py parity: unexported work in progress in the
    reference, shipped first-class. ``applyreverb`` is the reference's
    method name."""

    def __init__(self, time_in_ms=1500):
        cfg, dev = _cfg_dev()
        super().__init__(ops.reverb(cfg, time_in_ms, device=dev))

    def applyreverb(self, float32_array_input):
        return self.apply(float32_array_input)


# The reference duplicates its FFT effects into CuPy clones
# (EffectFFTFilterGPU.py, EffectEQ3BandFFTGPU.py); here every device runs on
# the configured device, so the *GPU names are aliases kept for drop-in
# compatibility.
CreateHighCutFilterGPU = CreateHighCutFilter
CreateLowCutFilterGPU = CreateLowCutFilter
CreateEQ3BandFFTGPU = CreateEQ3BandFFT
