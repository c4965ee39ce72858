"""CreateTremolo: one LFO period of ``sr / lfo_hz`` samples (that length
taken through float32, as upstream builds it with ``np.arange``) of
``(sin(2 pi f t / sr) / 2 + 0.5) * depth + 1 - depth``, consumed a chunk
at a time from a rolling copy that is topped up with whole periods. When
the copy's remaining length equals the chunk exactly, upstream's slice
``[-0:]`` keeps the whole copy: the phase stops there and that chunk of
the LFO repeats from then on."""

import numpy as np
import torch


def block_phases(L: int, num_blocks: int, B: int) -> np.ndarray:
    phase, avail = 0, L
    out = np.empty(num_blocks, dtype=np.int64)
    for i in range(num_blocks):
        out[i] = phase
        if avail < B:
            avail += L * (-(-(B - avail) // L))
        if avail != B:
            phase, avail = (phase + B) % L, avail - B
    return out


def apply(x, ctx, depth: float, lfo_hz: float):
    sr, B = ctx.sample_rate, ctx.block_size
    L = int(np.arange(np.float32(sr / lfo_hz)).shape[0])
    t = np.arange(L)
    lfo = ((np.sin(2 * np.pi * lfo_hz * t / sr) / 2) + 0.5) * depth \
        + (1 - depth)
    nb = x.shape[-1] // B
    idx = (block_phases(L, nb, B)[:, None] + np.arange(B)[None, :]) % L
    gains = ctx.rnd(torch.as_tensor(lfo[idx.reshape(-1)]).to(
        device=x.device, dtype=ctx.work))
    return x * gains
