"""Blocking / deblocking of audio signals.

Counterpart of ``pyaudiodsptools_tpu/core/block.py``: signals are dense
``(..., num_blocks, block_size)`` tensors. ``make_blocks`` always pads to a
multiple of ``block_size``.

The reference's ``MakeChunks`` (pyAudioDspTools ``Utility.py:8-28``) pads
only when the length is not a multiple of the chunk COUNT (``Utility.py:23``),
so e.g. a 1000-sample signal with chunk_size=512 yields 2 chunks of 500;
:func:`legacy_chunk_sizes` gives that exact partition for compatibility.
"""

from __future__ import annotations

import math

import numpy as np
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


def legacy_chunk_sizes(n_samples: int, chunk_size: int) -> list[int]:
    """The exact chunk partition the reference's ``MakeChunks`` produces,
    including the ``Utility.py:23`` quirk (pad only when
    ``n % num_chunks != 0``)."""
    count = math.ceil(np.float32(n_samples / chunk_size))
    if n_samples % count != 0:
        padded = n_samples + (chunk_size - (n_samples % chunk_size))
    else:
        padded = n_samples
    if padded % count != 0:  # the reference's MakeChunks fails here too
        raise ValueError("reference MakeChunks would fail on this shape")
    return [padded // count] * count


def padded_length(n_samples: int, block_size: int) -> int:
    return num_blocks(n_samples, block_size) * block_size
