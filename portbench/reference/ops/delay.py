"""CreateDelay: the dry signal plus ``feedback_loops`` echoes, echo k
(from 1) ``k * time`` samples late at a gain from
``linspace(0.5, 0.1, feedback_loops)``."""

import numpy as np
import torch


def apply(x, ctx, time_in_ms: float, feedback_loops: int):
    d = int(time_in_ms * (ctx.sample_rate / 1000))
    gains = np.linspace(0.5, 0.1, num=feedback_loops)
    T = x.shape[-1]
    y = x.clone()
    for k in range(feedback_loops):
        lag = d * (k + 1)
        if lag < T:
            g = ctx.rnd(torch.tensor(float(gains[k]), dtype=ctx.work))
            y[:, lag:] += ctx.rnd(g.to(x.device) * x[:, :T - lag])
    return y
