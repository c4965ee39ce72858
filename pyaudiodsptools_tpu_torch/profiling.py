"""Profiling hooks: per-effect scopes and a TensorBoard trace.

Counterpart of ``pyaudiodsptools_tpu/profiling.py``:

* ``annotate_chain`` wraps each op's ``step`` and ``offline`` in a named
  ``torch.profiler.record_function`` scope (``effect.<name>.step``,
  ``effect.<name>.offline``), so that a trace attributes the kernels an op
  launches to the user's effect.
* ``trace`` is a context manager around ``torch.profiler.profile`` that
  writes a TensorBoard-readable trace directory.

For Nsight Systems, run the code under
``torch.autograd.profiler.emit_nvtx()``: the same scopes become NVTX ranges.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)

from .core.config import DEFAULT_DEVICE, resolve_device
from .engine.chain import Chain
from .ops.base import Effect


def _wrap(eff: Effect) -> Effect:
    name = eff.name
    inner_step, inner_offline = eff.step, eff.offline

    # every argument passes through: a FIR step's use_kernels, the tremolo's
    # first_block, a sharded render's keywords
    def step(*args, **kwargs):
        with record_function(f"effect.{name}.step"):
            return inner_step(*args, **kwargs)

    offline = None
    if inner_offline is not None:
        def offline(*args, **kwargs):
            with record_function(f"effect.{name}.offline"):
                return inner_offline(*args, **kwargs)

    # _replace keeps reach, block_indexed, lti_kernel and device
    return eff._replace(step=step, offline=offline)


def annotate_chain(chain: Chain) -> Chain:
    """A copy of the chain whose ops carry named profiler scopes.

    Fusion is disabled so each op stays a separately scoped region (the
    point of profiling is per-op attribution; the production chain fuses).
    The copy runs on the chain's device and renders the same bits as
    ``Chain(chain.effects, fuse=False)``."""
    return Chain([_wrap(e) for e in chain.effects], fuse=False,
                 device=chain.device)


@contextlib.contextmanager
def trace(log_dir: str, device=DEFAULT_DEVICE):
    """Capture a profiler trace into ``log_dir``:
    ``with profiling.trace('/tmp/tb'):``. On a card it records CPU and CUDA
    activity (raises without a card); ``device="cpu"`` records the CPU's."""
    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
