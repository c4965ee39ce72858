"""The captured streaming step: the counterpart of ``jax.jit(chain_step)``.

The JAX package compiles its streaming step once per block shape
(``pyaudiodsptools_tpu/engine/chain.py``: ``jax.jit(partial(chain_step,
...))``) and every streamed block calls the compiled program. On the card the
port captures the same step, the eager ``chain_step`` over a chain's executed
effects, in a CUDA graph (``torch.cuda.CUDAGraph``) and replays it block after
block: one graph launch where the eager step issues its few dozen launches
from Python (chain8: 25, the EQ: some 80).

A :class:`CapturedStep` is built for one chain's effects (or one effect), one
batch shape of the state and one device. It owns the state in static buffers
and, like jit's cache, keeps one graph for each block shape it has met, all
of them reading and writing the same state buffers. For each shape it:

* runs the step once on a side stream on silence (the CUDA kernels are built
  and loaded; cuBLAS, which the EQ's float64 products go through, makes its
  handle and workspace), and discards the result;
* captures the step once, followed inside the graph by copies of the new
  state into the state buffers, so that a replay advances the state;
* on each block copies the input into the graph's input buffer and replays.
  The output lies in the graph's own buffer, which the next replay
  overwrites: :meth:`CapturedStep.replay` returns that buffer and
  ``__call__`` a copy (JAX's outputs are immutable).

What a capture freezes: the steps read the scalars of their params on the
host and pass them by value (the dynamics walk's table through ``ctypes``, a
delay's tap gains as 0-d host tensors), which is right because an effect's
params never change; and nothing else, because no step reads a value back
from the device (the tremolo's LFO position is a 0-d int32 tensor).

Launch counters. Each kernel wrapper adds one to a Python counter where it
launches (``kernels/convpairs.launch_count``,
``kernels/dynamics.serial_walk_launch_count``, ...). During a capture the
wrapper runs but launches nothing, so the capture's increments are taken back
and recorded; every replay adds them again, because a replay launches every
captured kernel once.

Captures use ``capture_error_mode="thread_local"``: another thread's CUDA
calls (a realtime pump replaying its own graph, a producer copying a block)
do not invalidate this thread's capture. A capture that fails raises
:class:`CaptureError` naming the effect whose step broke it; nothing falls
back to the eager step. ``Chain.step`` stays eager, the reference the graph
is held to.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..kernels import convpairs, dynamics, relayout, segconv, tail
from ..ops.base import Effect
from .stream import state_leaves

# Every kernel wrapper's launch counter: (module, attribute).
LAUNCH_COUNTERS = ((convpairs, "launch_count"),
                   (dynamics, "serial_walk_launch_count"),
                   (dynamics, "state_walk_launch_count"),
                   (dynamics, "audio_walk_launch_count"),
                   (segconv, "launch_count"), (tail, "launch_count"),
                   (relayout, "pack_launch_count"),
                   (relayout, "unpack_launch_count"))


class CaptureError(RuntimeError):
    """A step could not be captured in a CUDA graph."""


def _rebuild(template, it):
    if isinstance(template, dict):
        built = {k: _rebuild(template[k], it) for k in sorted(template)}
        return {k: built[k] for k in template}
    if isinstance(template, (tuple, list)):
        return tuple(_rebuild(part, it) for part in template)
    return next(it)


def _counts() -> list[int]:
    return [getattr(m, a) for m, a in LAUNCH_COUNTERS]


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    block: torch.Tensor          # input buffer
    out: torch.Tensor            # output buffer
    launches: list[int]          # each counter's launches a replay


class CapturedStep:
    """A streaming step over ``effects`` (a chain's executed effects, in
    order) replayed from CUDA graphs, its state in static buffers.

    >>> step = chain.captured_step((64,))
    >>> step.capture((64, 512))        # optional: the first call captures
    >>> out = step(block)              # a new tensor; the state advanced
    >>> state = step.state             # a copy, for a checkpoint
    >>> step.load_state(state)         # resume
    """

    def __init__(self, effects: Sequence[Effect], device,
                 batch_shape: tuple[int, ...] = ()):
        self.effects = tuple(effects)
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(
                f"a captured step runs on a CUDA device, not {self.device}: "
                "on the CPU call Chain.step")
        for e in self.effects:
            if e.device.type != "cuda":
                raise ValueError(f"effect {e.name!r} was built for "
                                 f"{e.device}, not for the card")
        self.batch_shape = tuple(batch_shape)
        self._template = self._init_state()
        # distinct buffers: an initial state may share one zero tensor
        # between fields, and each field is written on its own
        self._buffers = [leaf.clone() for leaf in state_leaves(self._template)]
        self._graphs: dict[tuple[int, ...], _Graph] = {}

    def _init_state(self):
        return tuple(e.state(self.batch_shape) for e in self.effects)

    # -- state ---------------------------------------------------------------

    @property
    def state(self):
        """A copy of the state, shaped as ``Chain.init_state`` gives it."""
        return _rebuild(self._template,
                        iter([b.clone() for b in self._buffers]))

    def load_state(self, state) -> None:
        """Copy ``state`` (shaped as :attr:`state`) into the buffers."""
        leaves = [torch.as_tensor(leaf) for leaf in state_leaves(state)]
        if len(leaves) != len(self._buffers):
            raise ValueError(f"{len(leaves)} state leaves where this step "
                             f"keeps {len(self._buffers)}")
        for buf, leaf in zip(self._buffers, leaves):
            if leaf.shape != buf.shape:
                raise ValueError(f"a state leaf of shape {tuple(leaf.shape)} "
                                 f"where this step keeps {tuple(buf.shape)}")
        with torch.no_grad():
            for buf, leaf in zip(self._buffers, leaves):
                buf.copy_(leaf)

    def reset(self) -> None:
        self.load_state(self._init_state())

    # -- capture and replay --------------------------------------------------

    def _step(self, block: torch.Tensor, where: list):
        """The eager step on the state buffers (``chain_step``), the effect
        at work named in ``where[0]``."""
        state = _rebuild(self._template, iter(self._buffers))
        new = []
        for e, st in zip(self.effects, state):
            where[0] = e.name
            st, block = e.step(e.params, st, block)
            new.append(st)
        where[0] = None
        return tuple(new), block

    def _write_state(self, new_state) -> None:
        """Copy a step's new state into the buffers (recorded in the
        graph). A new leaf that shares memory with a buffer is copied out
        first, so that no buffer is read after another was written."""
        leaves = state_leaves(new_state)
        if len(leaves) != len(self._buffers):
            raise CaptureError("the step returned a state of another "
                               "structure than its initial state")
        ptrs = {b.untyped_storage().data_ptr() for b in self._buffers}
        staged = []
        for buf, leaf in zip(self._buffers, leaves):
            if not isinstance(leaf, torch.Tensor) \
                    or leaf.shape != buf.shape or leaf.dtype != buf.dtype:
                raise CaptureError(
                    f"a state leaf of {tuple(buf.shape)} {buf.dtype} came "
                    f"back as {getattr(leaf, 'shape', type(leaf))} "
                    f"{getattr(leaf, 'dtype', '')}: the state must keep its "
                    "shape and type from block to block")
            if leaf is buf:
                staged.append(None)
            elif leaf.untyped_storage().data_ptr() in ptrs:
                staged.append(leaf.clone())
            else:
                staged.append(leaf)
        for buf, leaf in zip(self._buffers, staged):
            if leaf is not None:
                buf.copy_(leaf)

    def capture(self, shape: tuple[int, ...]) -> None:
        """Warm up and capture the step for blocks of ``shape`` (float32),
        once: a shape met before is kept."""
        shape = tuple(shape)
        if shape in self._graphs:
            return
        with torch.cuda.device(self.device), torch.no_grad(), \
                torch.inference_mode(False):
            self._graphs[shape] = self._capture(shape)

    def _capture(self, shape: tuple[int, ...]) -> _Graph:
        block = torch.zeros(shape, dtype=torch.float32, device=self.device)
        where = [None]
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._step(block, where)        # warm-up; the result is dropped
        current.wait_stream(side)
        torch.cuda.synchronize(self.device)
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        failed = None
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                try:
                    new_state, out = self._step(block, where)
                    where[0] = "(writing the new state)"
                    self._write_state(new_state)
                except Exception as exc:    # end the capture, then raise
                    failed = exc
        except Exception as exc:
            if failed is None:
                raise CaptureError(
                    f"capturing the streaming step for blocks of {shape} "
                    "failed when the capture ended") from exc
        finally:
            after = _counts()
            for (m, a), v in zip(LAUNCH_COUNTERS, before):
                setattr(m, a, v)
        if failed is not None:
            raise CaptureError(
                f"capturing the streaming step for blocks of {shape} failed "
                f"in the step of {where[0]!r}: {failed}") from failed
        if not isinstance(out, torch.Tensor) or out.shape != block.shape:
            raise CaptureError(f"the step gave {getattr(out, 'shape', out)} "
                               f"for a block of {shape}")
        return _Graph(graph, block, out,
                      [a - b for a, b in zip(after, before)])

    def replay(self, block: torch.Tensor) -> torch.Tensor:
        """Step ``block`` (a tensor on the card or on the host), advancing
        the state; the first block of a shape captures its graph. Returns
        the graph's output buffer, which the next step of this shape
        overwrites."""
        shape = tuple(block.shape)
        g = self._graphs.get(shape)
        if g is None:
            self.capture(shape)
            g = self._graphs[shape]
        g.block.copy_(block)
        g.graph.replay()
        for (m, a), k in zip(LAUNCH_COUNTERS, g.launches):
            if k:
                setattr(m, a, getattr(m, a) + k)
        return g.out

    def __call__(self, block: torch.Tensor) -> torch.Tensor:
        """:meth:`replay`, its output copied: it stays valid."""
        return self.replay(block).clone()

    def launches_per_step(self, shape: tuple[int, ...]) -> dict[str, int]:
        """Each kernel counter's launches in one replay at ``shape``."""
        g = self._graphs[tuple(shape)]
        return {f"{m.__name__.rsplit('.', 1)[-1]}.{a}": k
                for (m, a), k in zip(LAUNCH_COUNTERS, g.launches) if k}
