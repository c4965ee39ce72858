"""Blocking / deblocking of audio signals.

Counterpart of ``pyaudiodsptools_tpu/core/block.py``: signals are dense
``(..., num_blocks, block_size)`` tensors. ``make_blocks`` always pads to a
multiple of ``block_size``.
"""

from __future__ import annotations

import torch


def num_blocks(n_samples: int, block_size: int) -> int:
    return -(-n_samples // block_size)


def make_blocks(signal: torch.Tensor, block_size: int) -> torch.Tensor:
    """Split ``(..., n)`` into ``(..., num_blocks, block_size)``, zero-padding
    the tail."""
    n = signal.shape[-1]
    nb = num_blocks(n, block_size)
    pad = nb * block_size - n
    if pad:
        signal = torch.nn.functional.pad(signal, (0, pad))
    return signal.reshape(signal.shape[:-1] + (nb, block_size))


def combine_blocks(blocks: torch.Tensor,
                   n_samples: int | None = None) -> torch.Tensor:
    """Inverse of :func:`make_blocks`: ``(..., nb, B) -> (..., nb*B)``,
    optionally truncated to the original length."""
    out = blocks.reshape(blocks.shape[:-2] + (-1,))
    if n_samples is not None:
        out = out[..., :n_samples]
    return out
