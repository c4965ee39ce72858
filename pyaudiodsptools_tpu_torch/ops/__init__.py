"""Effect-op library: pure ``(params, state, block) -> (state, block)`` ops.

The ops of the port's slices so far. Still to come (ROADMAP.md): ``eq3band``
biquads and ``reverb``.
"""

from .base import Effect, params_dataclass
from .fft_filter import highcut, lowcut
from .eq3band_fft import eq3band_fft
from .delay import delay
from .tremolo import tremolo
from .dynamics import compressor, gate
from .waveshapers import saturator, softclipper, harddistortion, bitcrusher

__all__ = [
    "Effect", "params_dataclass",
    "highcut", "lowcut", "eq3band_fft", "delay", "tremolo", "saturator",
    "softclipper", "harddistortion", "bitcrusher", "compressor", "gate",
]
