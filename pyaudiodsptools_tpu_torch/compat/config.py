"""Drop-in replacement for the reference's module-singleton config
(pyAudioDspTools ``config.py``).

``initialize(sampling_rate, chunk_size)`` sets module-level values that the
compat device constructors snapshot at build time, the semantics migrating
users expect. New code should pass an
:class:`~pyaudiodsptools_tpu_torch.core.config.EngineConfig` and a device
explicitly instead.

``device`` is the only selector: devices run on the card (``"cuda"``) unless
it names the CPU, and ``initialize`` raises if it names CUDA and there is no
card. ``use_gpu`` is accepted for signature compatibility and not read, as in
the reference (which documents the flag and never reads it) and the JAX
package; it never moves work to the CPU.
"""

from __future__ import annotations

import torch

from ..core.config import DEFAULT_DEVICE, EngineConfig, resolve_device

sampling_rate: int | None = None
chunk_size: int | None = None
use_gpu: bool = False
device: torch.device | None = None


def initialize(sampling_rate: int, chunk_size: int, use_gpu: bool = False,
               device=DEFAULT_DEVICE) -> None:
    globals().update(sampling_rate=sampling_rate, chunk_size=chunk_size,
                     use_gpu=use_gpu, device=resolve_device(device))


def current() -> EngineConfig:
    if sampling_rate is None or chunk_size is None:
        raise RuntimeError(
            "pyaudiodsptools_tpu_torch.compat.config.initialize(sampling_rate, "
            "chunk_size) must be called before constructing devices")
    return EngineConfig(sample_rate=sampling_rate, block_size=chunk_size)


def current_device() -> torch.device:
    current()
    return device
