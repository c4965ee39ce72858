"""Time-sharded linear recurrences: the biquad EQ over a sharded time axis.

Counterpart of ``pyaudiodsptools_tpu/parallel/timescan.py``: the blocked
scan over the mesh's 'time' ranks, in this port's float64 (the JAX package
carries float32 pairs because a TPU has no float64). Per band:

1. **halo**: each rank sends its last 3 input samples to its right
   neighbour, which keeps the reference's one-sample input delay
   (``y[n] = b0 x[n-1] + b1 x[n-2] + b2 x[n-3] - a1 y[n-1] - a2 y[n-2]``,
   ``ops/eq3band.py``); the first rank takes zeros;
2. **local scan from zero**: ``ops/eq3band._allpole`` (the band's two
   first-order sections, each over chunks joined by a doubling scan) over
   the forcing from silence, plus the two homogeneous responses to
   ``y[-1] = 1`` and ``y[-2] = 1`` over the shard, so that
   ``s[n] = A[n] s_in + b[n]`` with ``s = (y[n], y[n-1])``;
3. **carry exchange**: each rank's summary (its end state from zero and the
   2x2 map of its whole shard) is all-gathered over the time axis, and each
   rank folds the summaries of the ranks before it into its entry state;
4. **correction**: ``y = b + A s_in``, local.

The next band takes this band's float64 output; the result is rounded to
float32 once, at the end, as the single-card recurrence rounds it. The two
exchanges of a band write into buffers the stage made before them
(``Mesh.shift_into``, ``Mesh.all_gather_into``), each yielded as an
:class:`~.mesh.Exchange` of the rank program (:func:`eq3band_steps`).
"""

from __future__ import annotations

import torch

from ..ops.eq3band import EQ3BandParams, _allpole
from .mesh import Exchange, Mesh, play


def _band_steps(params: EQ3BandParams, band: int, x: torch.Tensor,
                mesh: Mesh, axis: str):
    """One biquad band over this rank's float64 (R, T) shard of the time
    axis (a rank program)."""
    b0, b1, b2, _, _ = params.coeffs[band].tolist()
    R, T = x.shape
    tail = x[:, -3:].contiguous()
    halo = x.new_zeros((R, 3))         # the first rank's: silence
    yield Exchange(f"timescan band {band}: halo",
                   lambda: mesh.shift_into(tail, halo, axis))
    xe = torch.cat([halo, x], dim=-1)              # x[-3] .. x[T-1]
    c = b0 * xe[:, 2:-1] + b1 * xe[:, 1:-2] + b2 * xe[:, :-3]
    zero = x.new_zeros((R,))
    b = _allpole(c, zero, zero, params, band)       # from silence
    unit = torch.eye(2, dtype=x.dtype, device=x.device)
    h = _allpole(x.new_zeros((2, T)), unit[0], unit[1], params, band)
    # summary: end state from zero and the map of the whole shard
    A = torch.stack([h[:, T - 1], h[:, T - 2]])    # (2, 2): columns y1, y2
    summary = torch.cat([b[:, T - 2:].flip(-1),      # y[T-1], y[T-2]
                         A.reshape(1, 4).expand(R, 4)], dim=1)
    parts = summary.new_empty((mesh.shape[axis],) + tuple(summary.shape))
    yield Exchange(f"timescan band {band}: summaries",
                   lambda: mesh.all_gather_into(summary, parts, axis))
    s = x.new_zeros((R, 2))
    for part in parts[:mesh.index(axis)].unbind(0):
        s = s @ part[0, 2:].reshape(2, 2).T + part[:, :2]
    return b + s[:, :1] * h[0] + s[:, 1:] * h[1]


def eq3band_steps(params: EQ3BandParams, blocks: torch.Tensor, mesh: Mesh,
                  axis: str = "time"):
    """Time-sharded equivalent of ``ops.eq3band.offline`` on this rank's
    (..., nb_local, B) shard, as a rank program; collective over ``axis``."""
    shape = blocks.shape
    x = blocks.reshape(-1, shape[-2] * shape[-1]).to(torch.float64)
    for band in range(params.n_bands):
        x = yield from _band_steps(params, band, x, mesh, axis)
    return x.to(torch.float32).reshape(shape)


def eq3band_offline_sharded(params: EQ3BandParams, blocks: torch.Tensor,
                            mesh: Mesh, axis: str = "time") -> torch.Tensor:
    """:func:`eq3band_steps` run eagerly."""
    return play(eq3band_steps(params, blocks, mesh, axis))
