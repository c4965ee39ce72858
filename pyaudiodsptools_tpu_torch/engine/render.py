"""Offline rendering: signal/file -> chain -> signal/file.

Counterpart of ``pyaudiodsptools_tpu/engine/render.py``: block the signal,
render the whole chain (at once through the offline kernels, or segment by
segment through the streaming step), deblock. Output length is padded to
whole blocks unless ``trim=True``.

On the card both are the JAX package's compiled programs' counterparts:
:func:`render` replays the chain's captured render (``Chain.captured_render``,
kept with the chain; ``render`` keeps the graph of the last blocks shape it
rendered and releases the others) and writes the padded signal straight
into the graph's input buffer, as the JAX render donates its padded blocks; :func:`render_segmented` folds the chain's captured step
(``engine/resumable.render_segment``). On the CPU, and with
``use_kernels=False``, the render runs eagerly (``Chain.render_blocks``).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .. import profiling
from ..core import block as blk
from ..core import wavio
from ..core.config import EngineConfig
from .chain import Chain
from .resumable import render_segment

_renders = itertools.count()   # the sequence numbers of the render spans


def render(chain: Chain, signal, cfg: EngineConfig, trim: bool = False,
           use_kernels: bool = True) -> torch.Tensor:
    """Render ``(..., n)`` audio through the chain on the chain's device.
    Leading axes are channels. ``signal`` may be a tensor (moved to the
    chain's device if it is elsewhere) or anything ``torch.as_tensor`` takes.
    ``use_kernels=False`` asks for the plain PyTorch versions throughout.
    On the card the render replays a CUDA graph (captured at the first
    render of a shape; the chain keeps the last shape's graph only) and
    returns a tensor of its own. The call is the span ``render`` when
    tracing is on (``profiling``)."""
    with profiling.span("render", next(_renders)):
        signal = torch.as_tensor(signal, dtype=cfg.dtype).to(chain.device)
        n = signal.shape[-1]
        if chain.device.type == "cuda" and use_kernels:
            out = chain.captured_render().render(signal, cfg.block_size)
        else:
            blocks = blk.make_blocks(signal, cfg.block_size)
            out = chain.render_blocks(blocks, use_kernels=use_kernels)
        return blk.combine_blocks(out, n if trim else None)


def render_segmented(chain: Chain, signal, cfg: EngineConfig,
                     segment_blocks: int = 512,
                     trim: bool = False) -> torch.Tensor:
    """Bounded-memory exact render for signals too long to render at once.

    ``render`` keeps the whole signal plus several intermediates in device
    memory; this path folds the chain's streaming step over
    ``segment_blocks``-block segments with the state carried across and
    moves each finished segment to the host, so the device holds the signal,
    one segment and the state. The result is exactly the streaming fold (the
    step path IS the op semantics), which on the card is far slower than the
    offline kernels: use it when memory, not time, is the constraint."""
    if segment_blocks < 1:
        raise ValueError(f"segment_blocks must be >= 1, got {segment_blocks}")
    signal = torch.as_tensor(signal, dtype=cfg.dtype).to(chain.device)
    n = signal.shape[-1]
    blocks = blk.make_blocks(signal, cfg.block_size)
    nb = blocks.shape[-2]
    state = chain.init_state(tuple(blocks.shape[:-2]))
    outs = []
    for lo in range(0, nb, segment_blocks):
        hi = min(lo + segment_blocks, nb)
        state, out = render_segment(chain, state, blocks[..., lo:hi, :])
        outs.append(out.cpu())
    out = torch.cat(outs, dim=-2).to(chain.device)
    return blk.combine_blocks(out, n if trim else None)


def render_file(chain: Chain, in_path: str, out_path: str, cfg: EngineConfig,
                trim: bool = False) -> np.ndarray:
    """wav -> chain -> wav (mono or multichannel)."""
    audio, _rate = wavio.read_wav(in_path)
    out = render(chain, audio, cfg, trim=trim).cpu().numpy()
    wavio.write_wav(out_path, out, cfg.sample_rate)
    return out
