"""The captured streaming step and the captured offline render: the
counterparts of ``jax.jit(chain_step)`` and ``jax.jit(chain_render)``.

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
  state into the state buffers, so that a replay advances the state (a
  step that advances a leaf in place, the delay line of a FIR longer than
  one window, returns the buffer itself, which needs no copy; the warm-up
  leaves such a leaf as the step it is given would find it: the delay
  line's slots it writes are the ones the step writes before reading);
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

Tracing (``profiling.py``). A capture is the span ``graph.capture``, and
:data:`capture_s` / :data:`captures` count the host's seconds in captures
(warm-up included) and the captures made, always. A graph captured with the
program's tracing on records a stage mark (``profiling.mark``) before the
first executed effect, after each and, in the step, after the state
write-back, and between the partitions of a FIR (``<effect>.part0``, ...:
the render's segconv launches, the step's convpairs launches);
``stages()`` names the stages in order.
Captured with tracing off, a graph holds no mark.

Captures use ``capture_error_mode="thread_local"``: another thread's CUDA
calls (a realtime pump replaying its own graph, a producer copying a block)
do not invalidate this thread's capture. A capture that fails raises
:class:`CaptureError` naming the effect whose step broke it; nothing falls
back to the eager step. ``Chain.step`` stays eager, the reference the graph
is held to.

The offline render (:class:`CapturedRender`, ``Chain.captured_render``) is
captured the same way, one graph per blocks shape, each with a static input
buffer that ``engine/render.render`` writes the padded signal into. Its one
loop whose trip count depends on the data, the dynamics fixpoint
(``kernels/dynamics.dynamics_offline``), becomes a conditional while node
(``kernels/graph_cond.while_node``, ``csrc/graph_cond.cu``): the audio walk
and the settle step are the node's body, and the settle step sets the node's
condition on the card. Those launches are counted when the render's walks
are read (:meth:`CapturedRender.walks`, a synchronisation), never in
``replay``. A graph holds its intermediates in its private pool for as long
as it lives (chain8 at 64 channels x 30 s: four times the signal), so
:meth:`CapturedRender.render`, what ``engine/render.render`` calls, keeps the
graph of the shape it renders and releases the others; ``capture``,
``replay`` and ``__call__`` keep every shape until
:meth:`CapturedRender.release`. ``Chain.render_blocks`` stays eager, the
reference the graph is held to.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import torch

from .. import profiling
from ..kernels import (convpairs, dynamics, graph_cond, relayout, segconv,
                       tail)
from ..kernels.graph_cond import CaptureError
from ..ops.base import Effect
from .stream import state_leaves

# Every kernel wrapper's launch counter: (module, attribute).
LAUNCH_COUNTERS = ((convpairs, "launch_count"),
                   (convpairs, "accumulate_launch_count"),
                   (convpairs, "spectral_launch_count"),
                   (dynamics, "serial_walk_launch_count"),
                   (dynamics, "state_walk_launch_count"),
                   (dynamics, "audio_walk_launch_count"),
                   (dynamics, "settle_launch_count"),
                   (dynamics, "round_launch_count"),
                   (segconv, "launch_count"),
                   (segconv, "accumulate_launch_count"),
                   (tail, "launch_count"),
                   (relayout, "pack_launch_count"),
                   (relayout, "unpack_launch_count"))

# The host's seconds in _capture (warm-up and capture) in this process, and
# the captures made.
capture_s = 0.0
captures = 0


def _rebuild(template, it):
    if isinstance(template, dict):
        built = {k: _rebuild(template[k], it) for k in sorted(template)}
        return {k: built[k] for k in template}
    if isinstance(template, (tuple, list)):
        return tuple(_rebuild(part, it) for part in template)
    return next(it)


def _counts() -> list[int]:
    return [getattr(m, a) for m, a in LAUNCH_COUNTERS]


def _capture(device, warm, run, what: str, pool=None):
    """Run ``warm(where)`` once on a side stream (kernels built and loaded,
    caches filled, cuBLAS's handle made; the result is dropped), then capture
    ``run(where)`` in a CUDA graph in ``thread_local`` mode, its memory from
    ``pool`` if given (``torch.cuda.graph_pool_handle``, shared by graphs
    that replay in the order they were captured), else a pool of its own.
    Each callable names the effect at work in ``where[0]``. Returns (graph,
    what ``run`` returned, each counter's launches a replay); the capture's
    own counts are taken back. A failure raises :class:`CaptureError`
    naming ``what`` and the effect. Its time goes to :data:`capture_s`."""
    global capture_s, captures
    t0 = time.perf_counter()
    try:
        with profiling.span("graph.capture"):
            return _capture_timed(device, warm, run, what, pool)
    finally:
        capture_s += time.perf_counter() - t0
        captures += 1


def _capture_timed(device, warm, run, what: str, pool):
    where = [None]
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        warm(where)
    current.wait_stream(side)
    torch.cuda.synchronize(device)
    before = _counts()
    graph = torch.cuda.CUDAGraph()
    failed, result = None, None
    try:
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            try:
                result = run(where)
            except Exception as exc:    # end the capture, then raise
                failed = exc
    except Exception as exc:
        if failed is None:
            raise CaptureError(f"capturing {what} failed when the capture "
                               "ended") from exc
    finally:
        after = _counts()
        for (m, a), v in zip(LAUNCH_COUNTERS, before):
            setattr(m, a, v)
    if failed is not None:
        raise CaptureError(f"capturing {what} failed in the step of "
                           f"{where[0]!r}: {failed}") from failed
    return graph, result, [a - b for a, b in zip(after, before)]


def read_fixpoints(flags: list[torch.Tensor], read: list[tuple[int, int]],
                   what: str) -> list[int]:
    """The walks of each dynamics fixpoint's last run from its settle flags
    (``dynamics.FLAG_*``; a synchronisation), and the audio walks and settle
    steps its while node ran since ``read`` (each fixpoint's counters at the
    last read, updated) added to the launch counters. Raises if a fixpoint
    ended at its bound unsettled (unreachable: the entries settle one
    segment a walk at least)."""
    if not flags:
        return []
    values = torch.stack(flags).tolist()
    for i, v in enumerate(values):
        audio, unsettled = (v[dynamics.FLAG_AUDIO_WALKS],
                            v[dynamics.FLAG_UNSETTLED])
        seen_audio, seen_unsettled = read[i]
        dynamics.audio_walk_launch_count += audio - seen_audio
        dynamics.settle_launch_count += audio - seen_audio
        read[i] = (audio, unsettled)
        if unsettled != seen_unsettled:
            raise RuntimeError(f"{what} ended a dynamics fixpoint unsettled "
                               "at its bound")
    return [v[dynamics.FLAG_WALKS] for v in values]


def _add_launches(launches: list[int]) -> None:
    for (m, a), k in zip(LAUNCH_COUNTERS, launches):
        if k:
            setattr(m, a, getattr(m, a) + k)


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    block: torch.Tensor          # input buffer
    out: torch.Tensor            # output buffer
    launches: list[int]          # each counter's launches a replay
    stages: list[str]            # between its marks (none: untraced)


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
        initial = self._init_state()
        # distinct buffers: an initial state may share one zero tensor
        # between fields, and each field is written on its own
        self._buffers = [leaf.clone() for leaf in state_leaves(initial)]
        # the state's structure alone: the buffers are the only copy of its
        # tensors that the step keeps
        self._template = _rebuild(initial, iter([None] * len(self._buffers)))
        del initial
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

    def _step(self, block: torch.Tensor, where: list, stages=None):
        """The eager step on the state buffers (``chain_step``), the effect
        at work named in ``where[0]``, the buffers the step's own (a leaf
        may advance in place); with a list for
        ``stages``, a mark before the first effect and after each, the
        effects' names appended (a FIR streamed in partitions marks between
        them too, its parts' names appended: ``profiling.stage_parts``)."""
        state = _rebuild(self._template, iter(self._buffers))
        new = []
        if stages is not None:
            profiling.mark(self.device)
        for e, st in zip(self.effects, state):
            where[0] = e.name
            with profiling.stage_parts(stages is not None) as parts:
                st, block = e.step(e.params, st, block)
            new.append(st)
            if stages is not None:
                profiling.mark(self.device)
                stages.extend(profiling.stage_names(e.name, len(parts)))
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
        traced = profiling.enabled()
        stages: list[str] = []

        def run(where):
            new_state, out = self._step(block, where,
                                        stages if traced else None)
            where[0] = "(writing the new state)"
            self._write_state(new_state)
            if traced:
                profiling.mark(self.device)
                stages.append("write_state")
            return out

        # the warm-up marks too, so that the mark's kernel is loaded before
        # the capture
        graph, out, launches = _capture(
            self.device,
            lambda where: self._step(block, where, [] if traced else None),
            run, f"the streaming step for blocks of {shape}")
        if not isinstance(out, torch.Tensor) or out.shape != block.shape:
            raise CaptureError(f"the step gave {getattr(out, 'shape', out)} "
                               f"for a block of {shape}")
        return _Graph(graph, block, out, launches, profiling.unique(stages))

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
        with profiling.span("step.copy_in"):
            g.block.copy_(block)
        with profiling.span("step.replay"):
            g.graph.replay()
            _add_launches(g.launches)
        return g.out

    def __call__(self, block: torch.Tensor) -> torch.Tensor:
        """:meth:`replay`, its output copied: it stays valid."""
        return self.replay(block).clone()

    def launches_per_step(self, shape: tuple[int, ...]) -> dict[str, int]:
        """Each kernel counter's launches in one replay at ``shape``."""
        g = self._graphs[tuple(shape)]
        return {f"{m.__name__.rsplit('.', 1)[-1]}.{a}": k
                for (m, a), k in zip(LAUNCH_COUNTERS, g.launches) if k}

    def stages(self, shape: tuple[int, ...]) -> list[str]:
        """The stages between the marks of the graph at ``shape``, in
        order: the executed effects, a FIR in partitions as its parts
        (``<effect>.part0``, ...), then ``write_state``; none where it was
        captured with tracing off."""
        return list(self._graphs[tuple(shape)].stages)


# -- the offline render ------------------------------------------------------


@dataclasses.dataclass
class _Render:
    graph: torch.cuda.CUDAGraph
    blocks: torch.Tensor         # static input buffer
    out: torch.Tensor            # output buffer
    launches: list[int]          # each counter's launches a replay, but the
                                 # while nodes' (read with the walks)
    flags: list[torch.Tensor]    # each fixpoint's settle flags
    read: list[tuple[int, int]]  # each fixpoint's counters at the last read
    stages: list[str]            # between its marks (none: untraced)


class CapturedRender:
    """An offline render over ``effects`` (a chain's executed effects, in
    order) replayed from CUDA graphs: the counterpart of the JAX package's
    ``jax.jit(chain_render)``, one graph for each blocks shape, as jit
    keeps one program for each.

    >>> captured = chain.captured_render()
    >>> out = captured(blocks)          # a new tensor; blocks untouched
    >>> y = captured.render(signal, 512)  # engine.render: one shape kept
    >>> captured.walks()                # the dynamics walks (a sync)
    >>> captured.release()              # frees the graphs and their pools

    Each graph reads a static input buffer and writes its own output
    buffer, which the next replay of that shape overwrites:
    :meth:`replay` returns that buffer, ``__call__`` and :meth:`render` a
    copy (JAX's outputs are immutable). Every intermediate lies in the
    graph's private memory pool for as long as the graph lives, which is
    why :meth:`render` keeps the graph of one shape only."""

    def __init__(self, effects: Sequence[Effect], device):
        self.effects = tuple(effects)
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(
                f"a captured render runs on a CUDA device, not {self.device}:"
                " on the CPU call Chain.render_blocks")
        for e in self.effects:
            if e.device.type != "cuda":
                raise ValueError(f"effect {e.name!r} was built for "
                                 f"{e.device}, not for the card")
        self._graphs: dict[tuple, _Render] = {}

    def _render(self, blocks: torch.Tensor, where: list,
                stages=None) -> torch.Tensor:
        """``chain_render`` with kernels, the effect at work in
        ``where[0]``; with a list for ``stages``, a mark before the first
        effect and after each, the effects' names appended (a FIR in
        partitions marks between them too, its parts' names appended:
        ``profiling.stage_parts``)."""
        from .chain import scan_offline

        if stages is not None:
            profiling.mark(self.device)
        for e in self.effects:
            where[0] = e.name
            with profiling.stage_parts(stages is not None) as parts:
                if e.offline is not None:
                    blocks = e.offline(e.params, blocks)
                else:
                    blocks = scan_offline(e.init_state, e.step, e.params,
                                          blocks)
            if stages is not None:
                profiling.mark(self.device)
                stages.extend(profiling.stage_names(e.name, len(parts)))
        where[0] = None
        return blocks

    def capture(self, shape: tuple[int, ...],
                dtype: torch.dtype = torch.float32) -> None:
        """Warm up and capture the render of ``(..., num_blocks,
        block_size)`` blocks, once: a shape met before is kept."""
        key = (tuple(shape), dtype)
        if key in self._graphs:
            return
        if len(shape) < 2:
            raise ValueError(f"a render takes (..., num_blocks, block_size) "
                             f"blocks, not {tuple(shape)}")
        with torch.cuda.device(self.device), torch.no_grad(), \
                torch.inference_mode(False):
            # the while nodes' library loaded and its stream made before
            # the capture, not in it
            graph_cond.body_stream(self.device)
            blocks = torch.zeros(shape, dtype=dtype, device=self.device)
            flags: list[torch.Tensor] = []      # each fixpoint's
            traced = profiling.enabled()
            stages: list[str] = []

            def run(where):
                with graph_cond.fixpoints() as found:
                    out = self._render(blocks, where,
                                       stages if traced else None)
                flags.extend(found)
                return out

            # the warm-up marks too: the mark's kernel loaded before the
            # capture
            graph, out, launches = _capture(
                self.device,
                lambda where: self._render(blocks, where,
                                           [] if traced else None),
                run, f"the offline render of blocks of {tuple(shape)}")
            if not isinstance(out, torch.Tensor) or out.shape != blocks.shape:
                raise CaptureError(f"the render gave "
                                   f"{getattr(out, 'shape', out)} for blocks "
                                   f"of {tuple(shape)}")
            for f in flags:         # the counters the graph only adds to
                f.zero_()
            self._graphs[key] = _Render(graph, blocks, out, launches, flags,
                                        [(0, 0)] * len(flags),
                                        profiling.unique(stages))

    def _get(self, shape, dtype) -> _Render:
        key = (tuple(shape), dtype)
        g = self._graphs.get(key)
        if g is None:
            self.capture(shape, dtype)
            g = self._graphs[key]
        return g

    def replay_input(self, shape: tuple[int, ...],
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Replay the graph for ``shape`` (captured first if need be) on
        what its static input buffer holds. Returns the graph's output
        buffer, which the next replay of this shape overwrites. Reads
        nothing back."""
        g = self._get(shape, dtype)
        g.graph.replay()
        _add_launches(g.launches)
        return g.out

    def replay(self, blocks: torch.Tensor) -> torch.Tensor:
        """Copy ``blocks`` into the input buffer of its shape and replay;
        returns the graph's output buffer (see :meth:`replay_input`)."""
        g = self._get(blocks.shape, blocks.dtype)
        g.blocks.copy_(blocks)
        return self.replay_input(blocks.shape, blocks.dtype)

    def __call__(self, blocks: torch.Tensor) -> torch.Tensor:
        """Render ``(..., num_blocks, block_size)`` blocks: :meth:`replay`,
        its output copied, so that it stays valid. ``blocks`` is not
        touched (the JAX package's render without donation)."""
        return self.replay(blocks).clone()

    def render(self, signal: torch.Tensor, block_size: int) -> torch.Tensor:
        """Render a ``(..., n)`` signal on the card in blocks of
        ``block_size``: the signal is written, zero-padded to whole blocks,
        straight into the input buffer (no padded copy is made, as the JAX
        package donates its padded blocks), the graph replayed and its
        output copied. Returns ``(..., num_blocks, block_size)`` blocks.

        Only this shape's graph is kept: the graphs of other shapes are
        released first, so that a caller who renders signals of many lengths
        holds one graph, not one for each length."""
        n = signal.shape[-1]
        nb = -(-n // block_size)
        shape = tuple(signal.shape[:-1]) + (nb, block_size)
        self.release(keep=(shape, signal.dtype))
        flat = self._get(shape, signal.dtype).blocks.view(
            shape[:-2] + (nb * block_size,))
        with profiling.span("render.copy_in"):
            flat[..., :n].copy_(signal)
            flat[..., n:].zero_()
        with profiling.span("render.replay"):
            out = self.replay_input(shape, signal.dtype)
        with profiling.span("render.copy_out"):
            return out.clone()

    def walks(self) -> dict[tuple[int, ...], list[int]]:
        """The walks of each graph's last replay, one int a dynamics stage
        (the state walk included), by blocks shape. Reads the device (a
        synchronisation) and adds to the launch counters the audio walks
        and settle steps that the while nodes ran since the last read.
        Raises if a fixpoint ended at its bound unsettled (unreachable: the
        entries settle one segment a walk at least)."""
        return {shape: read_fixpoints(g.flags, g.read,
                                      f"a captured render of {shape}")
                for (shape, _), g in self._graphs.items()}

    def launches_per_replay(self, shape: tuple[int, ...],
                            dtype: torch.dtype = torch.float32
                            ) -> dict[str, int]:
        """Each counter's launches in one replay outside the while nodes
        (their audio walks and settle steps depend on the data: see
        :meth:`walks`)."""
        g = self._graphs[(tuple(shape), dtype)]
        return {f"{m.__name__.rsplit('.', 1)[-1]}.{a}": k
                for (m, a), k in zip(LAUNCH_COUNTERS, g.launches) if k}

    def stages(self, shape: tuple[int, ...],
               dtype: torch.dtype = torch.float32) -> list[str]:
        """The stages between the marks of the graph for ``shape``, in
        order: the executed effects, a FIR in partitions as its parts
        (``<effect>.part0``, ...); none where it was captured with tracing
        off."""
        return list(self._graphs[(tuple(shape), dtype)].stages)

    def shapes(self) -> list[tuple[int, ...]]:
        """The blocks shapes whose graphs are kept."""
        return [shape for shape, _ in self._graphs]

    def release(self, keep: tuple | None = None) -> None:
        """Free every graph, its buffers and its private memory pool (the
        memory goes back to PyTorch's caching allocator, which hands it to
        the driver at ``torch.cuda.empty_cache`` or when an allocation would
        fail), but the graph of ``keep`` (``(shape, dtype)``) if given. A
        later render of a released shape captures again."""
        for key in [k for k in self._graphs if k != keep]:
            self._graphs.pop(key).graph.reset()
