"""Engine configuration and device resolution.

Counterpart of ``pyaudiodsptools_tpu/core/config.py``: an immutable
:class:`EngineConfig` passed explicitly to op factories, so a config is bound
to the params it built and never global state.

The JAX package reads a process-wide backend; this package has no such
global. Every op factory and :class:`~..engine.chain.Chain` take the device
as an argument (default ``"cuda"``), resolved by :func:`resolve_device`,
which raises when a CUDA device is asked for and none is present.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Any = DEFAULT_DEVICE) -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and no card
    is available. There is no silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions on the host")
    return dev


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Immutable engine-wide parameters.

    Attributes
    ----------
    sample_rate:
        Samples per second (Hz). Reference default is 44100.
    block_size:
        Samples per processing block ("chunk size" in the reference).
    dtype:
        Compute dtype for the signal path. float32 matches the reference's
        audio dtype; the kernels take nothing else.
    """

    sample_rate: int = 44100
    block_size: int = 512
    dtype: Any = torch.float32

    def __post_init__(self) -> None:
        if self.sample_rate <= 0:
            raise ValueError(f"sample_rate must be positive, got {self.sample_rate}")
        if self.block_size <= 0:
            raise ValueError(f"block_size must be positive, got {self.block_size}")

    @property
    def block_duration_ms(self) -> float:
        """Realtime budget per block in milliseconds."""
        return 1000.0 * self.block_size / self.sample_rate

    def ms_to_samples(self, ms: float) -> int:
        """Millisecond -> sample conversion used throughout the reference."""
        return int((self.sample_rate / 1000) * ms)
