"""Cross-rank speculative dynamics: keep compressor / gate TIME-sharded.

Counterpart of ``pyaudiodsptools_tpu/parallel/dynspec.py``. The dynamics
automaton (``ops/dynamics.py``) is sequential in time, so a time-sharded mesh
would have to gather the time axis to run it. This module extends the
single-card speculative segments (``kernels/dynamics.py``) across the mesh's
'time' ranks:

* every rank walks its time shard from a guessed entry state (at first REST,
  the all-zeros encoding) with the serial walk (``kernels/dynamics.
  serial_walk``: one launch of the hand-written kernel on the card, a whole
  cascade in one walk);
* the exit states (``encode_state``'s one int per op and channel) hop to the
  next rank, point to point; the first rank keeps REST;
* a changed flag is all-reduced over the time group, and the walk repeats
  until no entry moves, at most ``n_time + 1`` rounds, which reproduces the
  exact serial trajectory: rank t's entry is right after t rounds at worst,
  and on real audio after 2-3, because the automaton synchronises.

The last round's output is computed from the converged entries, so the
result equals the single-card stage bit for bit (the serial walk from a
state is the speculative walks' fixpoint). Each round moves ``n_ops x C``
ints a rank.

Two routes, by the mesh (:func:`time_sharded_steps`):

* where the mesh's exchanges go through gloo, each round reads the changed
  flag back to the host (:func:`_host_rounds`): the stage is one
  :class:`~.mesh.Exchange` of the rank program, run between two CUDA graphs
  of a captured render, and :func:`dynamics_offline_time_sharded` runs it
  eagerly;
* where they go through NCCL (``Mesh.capturable``), the rounds stay on the
  device (:func:`_device_rounds`) and a captured render holds them: the
  serial walk into fixed buffers, the shift, the round step
  (``kernels/dynamics.round_step``: the next entries, the moved flag, the
  round counted on the device) and the flag's all-reduce, ``n_time`` times,
  unrolled. The JAX package keeps its rounds in a ``lax.while_loop`` inside
  the jitted program; a CUDA graph's conditional while node would be its
  counterpart, but CUDA on the H100 refused NCCL's work inside a
  conditional node's body (``chip_cards.py`` probes it). The unrolled rounds
  give the loop's bits: at the start of round r the first r time ranks walk
  from their true entries, so round ``n_time`` walks every rank from the
  fixpoint, and a round after the fixpoint walks from the same entries. The
  loop stops at the fixpoint (after ``n_time`` rounds at most, though its
  bound is ``n_time + 1``). So that the rounds past the fixpoint cost no
  walk, each round's walk sits in a conditional if node of its own, which
  holds our kernel alone, and the round gate (``round_gate``) sets its
  condition to "the loop runs this round" (``round_live``) before it: the
  walks are the loop's, and so is the round count. Played eagerly (the
  warm-up, the CPU) the host reads the flags before each round instead.

Each stage records its round flags (``ROUND_*``) with
:func:`recorded_rounds`, where the caller reads its rounds (a
synchronisation).
"""

from __future__ import annotations

import contextlib
import threading

import torch

from ..kernels import dynamics as kdyn, graph_cond
from ..kernels.dynamics import (ROUND_CHANGED, ROUND_COUNT, op_scalars,
                                round_gate, round_live, round_step,
                                serial_walk)
from ..ops.dynamics import DynamicsParams
from .mesh import Exchange, Mesh, play

_records = threading.local()


def is_dynamics_params(p) -> bool:
    """True for one DynamicsParams or a (fused-cascade) tuple of them."""
    if isinstance(p, DynamicsParams):
        return True
    return (isinstance(p, tuple) and len(p) > 0
            and all(isinstance(q, DynamicsParams) for q in p))


@contextlib.contextmanager
def recorded_rounds():
    """Collect, in the list it yields, the round flags (int32[3],
    ``ROUND_*``) of every time-sharded dynamics stage that runs on this
    thread inside the block, in order: a host tensor where the rounds read
    their flag back, a device tensor where they ran on the device (captured,
    their walks are counted by the reader: ``ROUND_TOTAL``). Read them with
    :func:`read_rounds`."""
    outer = getattr(_records, "sink", None)
    sink: list[torch.Tensor] = []
    _records.sink = sink
    try:
        yield sink
    finally:
        _records.sink = outer


def _note(flags: torch.Tensor) -> None:
    sink = getattr(_records, "sink", None)
    if sink is not None:
        sink.append(flags)


def read_rounds(flags: list) -> list[int]:
    """Each recorded stage's rounds in its last run (a synchronisation)."""
    return [int(f[ROUND_COUNT]) for f in flags]


def _host_rounds(scalars, x: torch.Tensor, mesh: Mesh, out: torch.Tensor,
                 flags: torch.Tensor) -> None:
    """The rounds with the changed flag read back each round; the output of
    the last into ``out``, the rounds into the host ``flags``."""
    rest = torch.zeros((len(scalars), x.shape[0]), dtype=torch.int32,
                       device=x.device)
    entry = rest
    rounds = 0
    for _ in range(mesh.shape["time"] + 1):
        _, exits = serial_walk(scalars, x, entry, out=out)
        rounds += 1
        came = mesh.shift(exits, "time")
        nxt = rest if came is None else came
        moved = torch.any(nxt != entry).to(torch.int32).reshape(1)
        changed = mesh.all_reduce(moved, "max", "time")
        entry = nxt
        if not bool(changed):
            break
    flags[ROUND_COUNT] = rounds


def _device_rounds(scalars, x: torch.Tensor, mesh: Mesh,
                   out: torch.Tensor) -> None:
    """``n_time`` rounds on the device, unrolled, from buffers made before
    them, each walk run where its round is live; the output of the last walk
    into ``out``. Inside a capture each walk is an if node's body and
    nothing is read back; played eagerly the host reads the flags once a
    round."""
    n_ops, C = len(scalars), x.shape[0]
    entry = torch.zeros((n_ops, C), dtype=torch.int32, device=x.device)
    exits, came = torch.empty_like(entry), torch.empty_like(entry)
    in_graph = x.is_cuda and torch.cuda.is_current_stream_capturing()
    # a capture leaves the live rounds since the last read to be zeroed by
    # the capturer; each render (each replay) zeroes its flag and count
    flags = torch.empty(3, dtype=torch.int32, device=x.device) if in_graph \
        else torch.zeros(3, dtype=torch.int32, device=x.device)
    flags[:ROUND_COUNT + 1].zero_()
    _note(flags)
    first = mesh.index("time") == 0
    changed = flags[ROUND_CHANGED:ROUND_CHANGED + 1]
    for _ in range(mesh.shape["time"]):
        if in_graph:
            handle = graph_cond.if_handle(x.device)
            round_gate(flags, handle)
            # the walk's launches depend on the data: the reader of the
            # flags counts them (``CapturedShardedRender.rounds``)
            counted = kdyn.serial_walk_launch_count
            with graph_cond.if_node(x.device, handle):
                serial_walk(scalars, x, entry, out=out, exit_state=exits)
            kdyn.serial_walk_launch_count = counted
        elif round_live(flags):                 # the host read, eagerly
            serial_walk(scalars, x, entry, out=out, exit_state=exits)
        mesh.shift_into(exits, came, "time")
        round_step(None if first else came, entry, flags, first)
        mesh.all_reduce_(changed, "max", "time")


def time_sharded_steps(params, blocks: torch.Tensor, mesh: Mesh,
                       capturable: bool):
    """The stage as a rank program (a generator, see ``mesh.play``) on this
    rank's (..., nb_local, B) shard: the rounds on the device where
    ``capturable``, else one exchange that runs them with a host read
    each."""
    plist = list(params) if isinstance(params, tuple) else [params]
    scalars = [op_scalars(p) for p in plist]
    shape = blocks.shape
    x = blocks.reshape(-1, shape[-2] * shape[-1]).to(torch.float32) \
        .contiguous()
    out = torch.empty_like(x)
    if capturable:
        _device_rounds(scalars, x, mesh, out)
    else:
        flags = torch.zeros(3, dtype=torch.int32)
        _note(flags)
        yield Exchange("dynspec rounds",
                       lambda: _host_rounds(scalars, x, mesh, out, flags))
    return out.reshape(shape)


def dynamics_offline_time_sharded(params, blocks: torch.Tensor,
                                  mesh: Mesh) -> torch.Tensor:
    """Time-sharded offline dynamics (single op or fused cascade) of this
    rank's (..., nb_local, B) shard; collective over the time axis. The
    rounds read their flag back each round (the eager reference)."""
    return play(time_sharded_steps(params, blocks, mesh, capturable=False))
