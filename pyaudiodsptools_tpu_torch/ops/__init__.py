"""Effect-op library: pure ``(params, state, block) -> (state, block)`` ops.

One op per reference effect, as in the JAX package, including the
reference's unexported work-in-progress Reverb and BitCrusher.
"""

from .base import Effect, params_dataclass
from .fft_filter import highcut, lowcut
from .eq3band_fft import eq3band_fft
from .eq3band import eq3band, eq_band
from .dynamics import compressor, gate
from .delay import delay
from .tremolo import tremolo
from .reverb import reverb
from .waveshapers import saturator, softclipper, harddistortion, bitcrusher

__all__ = [
    "Effect", "params_dataclass",
    "highcut", "lowcut", "eq3band_fft", "eq3band", "eq_band", "compressor",
    "gate", "delay", "tremolo", "reverb", "saturator", "softclipper",
    "harddistortion", "bitcrusher",
]
