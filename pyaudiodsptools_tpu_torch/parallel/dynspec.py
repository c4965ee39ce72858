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
ints a rank and reads one flag back.
"""

from __future__ import annotations

import torch

from ..kernels.dynamics import op_scalars, serial_walk
from ..ops.dynamics import DynamicsParams
from .mesh import Mesh


def is_dynamics_params(p) -> bool:
    """True for one DynamicsParams or a (fused-cascade) tuple of them."""
    if isinstance(p, DynamicsParams):
        return True
    return (isinstance(p, tuple) and len(p) > 0
            and all(isinstance(q, DynamicsParams) for q in p))


def dynamics_offline_time_sharded(params, blocks: torch.Tensor,
                                  mesh: Mesh) -> torch.Tensor:
    """Time-sharded offline dynamics (single op or fused cascade) of this
    rank's (..., nb_local, B) shard; collective over the time axis."""
    plist = list(params) if isinstance(params, tuple) else [params]
    scalars = [op_scalars(p) for p in plist]
    shape = blocks.shape
    x = blocks.reshape(-1, shape[-2] * shape[-1]).to(torch.float32) \
        .contiguous()
    rest = torch.zeros((len(plist), x.shape[0]), dtype=torch.int32,
                       device=x.device)
    entry = rest
    for _ in range(mesh.shape["time"] + 1):
        out, exits = serial_walk(scalars, x, entry)
        came = mesh.shift(exits, "time")
        nxt = rest if came is None else came
        moved = torch.any(nxt != entry).to(torch.int32).reshape(1)
        changed = mesh.all_reduce(moved, "max", "time")
        entry = nxt
        if not bool(changed):
            break
    return out.reshape(shape)
