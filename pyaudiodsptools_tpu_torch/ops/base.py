"""The effect-op protocol.

Counterpart of ``pyaudiodsptools_tpu/ops/base.py``. The contract is kept:

    effect: (params, state, block) -> (state, block)

* ``params`` -- a frozen dataclass built once from an
  :class:`~..core.config.EngineConfig`. Never mutated. Large members (filter
  spectra, twiddle tables, the LFO period) are tensors on the effect's
  device. Small members (scalars, a delay's few tap weights) are float32
  tensors on the HOST: PyTorch treats a 0-dim host tensor as a scalar in
  arithmetic with device tensors, and the CUDA kernels take these values by
  value in their launch arguments, so keeping them on the host avoids a
  device read-back per call.
* ``state`` -- explicit dict/tuple of tensors carried across blocks.
* ``block`` -- ``(..., block_size)``; leading axes are channel batch dims.

``offline(params, blocks, use_kernels=True)`` maps a whole
``(..., num_blocks, block_size)`` signal at once. ``use_kernels`` matters
only to effects backed by a hand-written CUDA kernel: for a CUDA tensor they
launch the kernel (or raise), and run their plain PyTorch version only for a
CPU tensor or when the caller passes ``use_kernels=False``.

There is no tracing in this package, so the JAX package's pytree
registration reduces to a frozen dataclass; ``meta_fields`` is kept so that
the conversion layer and the tests can tell array leaves from static fields.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch


def params_dataclass(cls=None, *, meta_fields: tuple[str, ...] = ()):
    """Make ``cls`` a frozen dataclass and record which fields are static
    (``cls.meta_fields``) and which hold tensors (``cls.data_fields``)."""

    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        c.meta_fields = tuple(meta_fields)
        c.data_fields = tuple(
            f.name for f in dataclasses.fields(c) if f.name not in meta_fields)
        return c

    return wrap if cls is None else wrap(cls)


def host_scalar(value) -> torch.Tensor:
    """A 0-dim float32 host tensor (see the module docstring)."""
    return torch.tensor(float(value), dtype=torch.float32)


class Effect(NamedTuple):
    """A bound effect: params plus its pure functions.

    ``init_state(params, batch_shape) -> state`` builds the zero state.
    ``step(params, state, block) -> (state, out)`` is the streaming form.
    ``offline(params, blocks, use_kernels=True) -> blocks`` (optional) is the
    whole-signal form; None means the engine loops ``step`` over the blocks.
    ``lti_kernel`` -- for linear time-invariant ops, the host-side float64
    effective impulse response INCLUDING the op's latency shift, so that the
    op equals ``y = conv(x, lti_kernel)`` truncated to the input length.
    Consecutive LTI ops in a Chain fuse into one segmented convolution.
    ``device`` -- where the params' large tensors and the state live and
    where the effect expects its input. Every factory sets it; there is no
    default.
    ``reach`` -- for a time-parallel effect, how many samples before an
    output sample its ``offline`` reads (a FIR's kernel length minus one,
    latency included; a delay's farthest tap): a sharded render
    (``parallel/sharding.py``) hands each time shard that much left halo.
    ``block_indexed`` -- ``offline`` takes ``first_block=``, the index in
    the whole signal of the first block it is given, because its output
    depends on where a block lies (the tremolo's LFO schedule): a time shard
    passes its own.
    """

    name: str
    params: Any
    init_state: Callable[..., Any]
    step: Callable[[Any, Any, torch.Tensor], tuple[Any, torch.Tensor]]
    device: torch.device
    offline: Optional[Callable[..., torch.Tensor]] = None
    time_parallel: bool = True
    lti_kernel: Optional[Any] = None
    reach: int = 0
    block_indexed: bool = False

    def state(self, batch_shape: tuple[int, ...] = ()) -> Any:
        return self.init_state(self.params, batch_shape)

    def __call__(self, state: Any, block: torch.Tensor):
        return self.step(self.params, state, block)
