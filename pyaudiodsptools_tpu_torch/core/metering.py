"""Per-block and whole-signal meters.

Counterpart of ``pyaudiodsptools_tpu/core/metering.py``. The reference's only
metering is print-based average level (``InfodBV``, Utility.py:122-168);
these are plain reductions over tensors, computed where the tensor lies.
"""

from __future__ import annotations

import torch


def block_meters(blocks: torch.Tensor) -> dict:
    """Per-block peak and RMS over ``(..., num_blocks, block_size)``."""
    return {"peak": torch.amax(torch.abs(blocks), dim=-1),
            "rms": torch.sqrt(torch.mean(torch.square(blocks), dim=-1))}


def summary_meters(signal: torch.Tensor) -> dict:
    """Whole-signal meters: peak, RMS, mean |x| in dB (InfodBV-compatible),
    clip count."""
    absx = torch.abs(signal)
    return {"peak": torch.amax(absx),
            "rms": torch.sqrt(torch.mean(torch.square(signal))),
            "dbv": 20.0 * torch.log10(torch.mean(absx)),
            "clipped": torch.sum(absx >= 1.0)}
