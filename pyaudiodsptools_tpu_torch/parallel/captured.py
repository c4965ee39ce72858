"""The captured sharded render: a rank's program replayed from CUDA graphs,
the counterpart of the JAX package's ``jax.jit(_render_with_constraints)``
(``pyaudiodsptools_tpu/parallel/sharding.py``), which compiles a device's
whole share of the sharded render, its collectives inside, into one XLA
program.

A rank program (``parallel/sharding.py``: ``ShardedRenderer.steps``,
``dist.local_steps``) computes on its tensors and yields each exchange as a
``mesh.Exchange`` between buffers it made. :class:`CapturedShardedRender`
captures it on the card, from a static input buffer, in **pieces**:

* where the mesh is capturable (every group NCCL), the whole program is one
  graph: NCCL's collectives and point-to-point calls are captured where the
  program makes them, and dynspec's rounds run on the device, ``n_time`` of
  them unrolled, each walk in a conditional if node that runs it where the
  JAX loop would run the round (``parallel/dynspec.py``: CUDA refused
  NCCL's work inside a conditional while node on the H100);
* with gloo, whose exchanges go through host memory, each exchange ends a
  piece: a replay runs each piece's graph, then its exchange eagerly, then
  the next piece (dynspec's rounds, with their read of a flag each round,
  are one such exchange). The pieces share one memory pool and replay in
  the order they were captured.

Captured with the program's tracing on (``profiling``), the program marks
its stages on the card: ``program.<k>``, the k-th stretch of work between
two exchanges, and under NCCL ``exchange.<what>``, from just before an
exchange to just after it (the mark after it runs once the collective,
and with it the wait for the peers, is done); a gloo piece starts and ends
with a mark, and its exchange, on the host between two graphs, is the span
``sharded.exchange.<what>``. :meth:`~CapturedShardedRender.stages` lists
them in order.

Before the capture the mesh's communicators are made (``Mesh.warmup``) and
the whole program runs once eagerly on a side stream (the kernels loaded,
cuBLAS's handle made, NCCL's links for these sizes set up); every rank
captures the same pieces in the same order, and every rank must replay with
the others, as it renders with them.

Launch counters: each piece's launches are added at each replay, as
``engine/graph.py`` does; those of a conditional node depend on the data and
are added where the device's counts are read:
:meth:`~CapturedShardedRender.rounds` (dynspec's walks, one a live round)
and :meth:`~CapturedShardedRender.walks` (a ``time == 1`` dynamics stage's
fixpoint), each a synchronisation, never in
:meth:`~CapturedShardedRender.replay`. A capture that fails raises
``CaptureError``; nothing falls back to the eager program. One program (one kind and shape) is kept at a time, its
graphs and pool until :meth:`~CapturedShardedRender.release`.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from .. import profiling
from ..engine.graph import _add_launches, _capture, read_fixpoints
from ..kernels import dynamics, graph_cond
from ..kernels.graph_cond import CaptureError
from . import dynspec
from .mesh import Exchange, play


@dataclasses.dataclass
class _Piece:
    graph: torch.cuda.CUDAGraph
    launches: list[int]          # each counter's launches a replay
    cut: Exchange | None         # run after the graph (gloo), None last


@dataclasses.dataclass
class _Program:
    key: tuple
    pieces: list[_Piece]
    blocks: torch.Tensor         # static input buffer
    out: torch.Tensor            # output buffer
    fixpoints: list[torch.Tensor]     # time == 1 dynamics stages' flags
    fixpoints_read: list[tuple[int, int]]
    rounds: list[torch.Tensor]        # dynspec stages' round flags
    rounds_read: list[int]
    stages: list[str]                 # between its marks (none: untraced)


class CapturedShardedRender:
    """A :class:`~.sharding.ShardedRenderer`'s rank program replayed from
    CUDA graphs (see the module docstring), for its ``chain`` (checked to be
    on the card) and ``mesh``.

    >>> captured = renderer.captured
    >>> inp = captured.prepare("global", shard_shape, renderer.steps)
    >>> inp.copy_(my_shard)                # the static input buffer
    >>> out = captured.replay()            # the program's output buffer
    >>> captured.rounds()                  # dynspec's rounds (a sync)
    >>> captured.release()                 # frees the graphs and the pool
    """

    def __init__(self, chain, mesh):
        if chain.device.type != "cuda" or mesh.device.type != "cuda":
            raise ValueError(
                f"a captured sharded render runs on a CUDA device, not "
                f"{chain.device}: on the CPU call render_shard and gather")
        for e in chain.exec_effects:
            if e.device.type != "cuda":
                raise ValueError(f"effect {e.name!r} was built for "
                                 f"{e.device}, not for the card")
        # the mesh only, not the renderer that keeps this object: no cycle,
        # so the graphs go when the renderer goes, not when the garbage
        # collector runs (inside another capture, whose reset of a graph it
        # would break)
        self.mesh = mesh
        self._program: _Program | None = None

    @property
    def kept(self) -> tuple | None:
        """(kind, shape) of the program kept, or None."""
        return None if self._program is None else self._program.key

    def prepare(self, kind: str, shape: tuple[int, ...], steps
                ) -> torch.Tensor:
        """The static input buffer of the program ``steps(blocks,
        capturable, where)`` (a generator) on float32 blocks of ``shape``,
        captured first unless it is the program kept (same ``kind`` and
        shape); capturing releases the program kept before. Collective where
        it captures: every rank of the mesh prepares the same kind."""
        key = (kind, tuple(shape))
        if self._program is None or self._program.key != key:
            self.release()
            with torch.cuda.device(self.mesh.device), torch.no_grad(), \
                    torch.inference_mode(False):
                self._program = self._capture(key, steps)
        return self._program.blocks

    def _capture(self, key, steps) -> _Program:
        mesh = self.mesh
        device = mesh.device
        capturable = mesh.capturable
        # the while nodes' library loaded and its stream made before any
        # capture, and NCCL's communicators made outside it
        graph_cond.body_stream(device)
        if capturable:
            mesh.warmup()
        blocks = torch.zeros(key[1], dtype=torch.float32, device=device)
        here = [None]                   # the effect at work
        program = steps(blocks, capturable, here)
        pool = torch.cuda.graph_pool_handle()
        pieces: list[_Piece] = []
        fixpoints: list[torch.Tensor] = []
        rounds: list[torch.Tensor] = []
        out = None
        traced = profiling.enabled()
        stages: list[str] = []

        def warm(where):
            play(steps(blocks, capturable, where))
            if traced:      # loads the mark's kernel before the capture
                profiling.mark(device)

        def stage(name):
            profiling.mark(device)
            stages.append(name)

        def work():
            stage(f"program.{sum(s.startswith('program.') for s in stages)}")

        def run(where):
            """The program to its next cut (gloo) or its end."""
            with graph_cond.fixpoints() as found, \
                    dynspec.recorded_rounds() as recorded:
                try:
                    if traced:
                        profiling.mark(device)
                    while True:
                        try:
                            ex = program.send(None)
                        except StopIteration as stop:
                            if traced:
                                work()
                            return None, stop.value
                        if traced:
                            work()
                        if not capturable:
                            return ex, None
                        ex.run()
                        if traced:
                            stage(f"exchange.{ex.what}")
                except Exception:
                    where[0] = here[0]
                    raise
                finally:
                    fixpoints.extend(found)
                    rounds.extend(recorded)

        while out is None:
            what = (f"piece {len(pieces)} of the sharded render of "
                    f"{key[0]} blocks of {key[1]} on a "
                    f"{mesh.shape['channel']}x{mesh.shape['time']} mesh")
            with warnings.catch_warnings():
                # a piece between two exchanges may launch nothing (the
                # output of a time == 1 mesh's gather is the gathered
                # buffer): an empty graph replays as a no-op
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                graph, (cut, result), launches = _capture(
                    device, warm, run, what, pool=pool)
            warm = _nothing
            pieces.append(_Piece(graph, launches, cut))
            if cut is None:
                if not isinstance(result, torch.Tensor):
                    raise CaptureError(f"the sharded render gave {result!r}")
                out = result
        for f in fixpoints + rounds:    # the counters the graphs only add to
            f.zero_()
        return _Program(key, pieces, blocks, out, fixpoints,
                        [(0, 0)] * len(fixpoints), rounds, [0] * len(rounds),
                        profiling.unique(stages))

    def replay(self) -> torch.Tensor:
        """Replay the kept program on what its input buffer holds: each
        piece's graph, then its exchange. Returns the output buffer, which
        the next replay overwrites. Under NCCL it reads nothing back;
        collective: every rank of the mesh replays with the others."""
        p = self._require()
        for piece in p.pieces:
            piece.graph.replay()
            _add_launches(piece.launches)
            if piece.cut is not None:
                with profiling.span(f"sharded.exchange.{piece.cut.what}"):
                    piece.cut.run()
        return p.out

    def rounds(self) -> list[int]:
        """Each dynspec stage's rounds in the last replay (those the JAX
        package's loop runs). Reads the device (a synchronisation) and adds
        to the launch counter the serial walks that the rounds' if nodes ran
        since the last read (one a live round)."""
        p = self._require()
        for i, f in enumerate(p.rounds):
            if f.is_cuda:       # walks in if nodes
                total = int(f[dynamics.ROUND_TOTAL])
                dynamics.serial_walk_launch_count += total - p.rounds_read[i]
                p.rounds_read[i] = total
        return dynspec.read_rounds(p.rounds)

    def walks(self) -> list[int]:
        """The walks of each ``time == 1`` dynamics stage's fixpoint in the
        last replay, as ``CapturedRender.walks`` reads them (a
        synchronisation; the while nodes' launches added)."""
        p = self._require()
        return read_fixpoints(p.fixpoints, p.fixpoints_read,
                              f"a captured sharded render of {p.key}")

    def stages(self) -> list[str]:
        """The stages between the kept program's marks, in order (a gloo
        program's pieces one after another); none where it was captured
        with tracing off."""
        return list(self._require().stages)

    def cuts(self) -> list[str]:
        """The exchanges between the kept program's pieces."""
        return [piece.cut.what for piece in self._require().pieces
                if piece.cut is not None]

    def release(self) -> None:
        """Free the kept program's graphs, buffers and memory pool. The next
        :meth:`prepare` captures again."""
        if self._program is not None:
            for piece in self._program.pieces:
                piece.graph.reset()
            self._program = None

    def _require(self) -> _Program:
        if self._program is None:
            raise RuntimeError("no program kept: prepare one first")
        return self._program


def _nothing(where) -> None:
    return None
