"""Offline rendering: signal/file -> chain -> signal/file.

Counterpart of ``pyaudiodsptools_tpu/engine/render.py``: block the signal,
render the whole chain, deblock. Output length is padded to whole blocks
unless ``trim=True``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import block as blk
from ..core import wavio
from ..core.config import EngineConfig
from .chain import Chain


def render(chain: Chain, signal, cfg: EngineConfig, trim: bool = False,
           use_kernels: bool = True) -> torch.Tensor:
    """Render ``(..., n)`` audio through the chain on the chain's device.
    Leading axes are channels. ``signal`` may be a tensor (moved to the
    chain's device if it is elsewhere) or anything ``torch.as_tensor`` takes.
    ``use_kernels=False`` asks for the plain PyTorch versions throughout."""
    signal = torch.as_tensor(signal, dtype=cfg.dtype).to(chain.device)
    n = signal.shape[-1]
    blocks = blk.make_blocks(signal, cfg.block_size)
    out = chain.render_blocks(blocks, use_kernels=use_kernels)
    return blk.combine_blocks(out, n if trim else None)


def render_file(chain: Chain, in_path: str, out_path: str, cfg: EngineConfig,
                trim: bool = False) -> np.ndarray:
    """wav -> chain -> wav (mono or multichannel)."""
    audio, _rate = wavio.read_wav(in_path)
    out = render(chain, audio, cfg, trim=trim).cpu().numpy()
    wavio.write_wav(out_path, out, cfg.sample_rate)
    return out
