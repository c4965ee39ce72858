"""CreateSoftClipper: ``sign(x) * (1 - |min(|x|, 1) - 1| ** (drive + 1))``."""

import torch


def apply(x, ctx, drive: float):
    a = torch.clamp(x.abs(), max=1.0)
    a = 1.0 - ctx.rnd((a - 1.0).abs() ** (drive + 1.0))
    return torch.where(x < 0, -a, a)
