"""Whether what the timed path produced is right: the sampled outputs
held against the plain reference (``reference/``), each number compared
with its limit from ``limits/<cell>.json``.

Per sampled channel of a sampled answer (a job, or the whole stream), the
relative error ``||program - reference|| / ||reference||`` (2-norms over
the channel's unpadded samples, the reference in float64). A run compares
two numbers:

* ``worst_channel_rel_err``, the largest over every channel compared: a
  channel gone wrong shows in it, and so does a compressor's or a gate's
  mask bit that flips on a sample within rounding of its threshold (the
  program's float32 filters against the reference's float64), which
  moves a ramp by a few samples in one channel;
* ``median_channel_rel_err``, the largest over the answers of the median
  over their channels: a flip in one channel does not move it, a
  systematic error (a lower precision, a stage left out) does.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from portbench import reference as ref
from portbench.signals import seed_for

REL_ERR = "worst_channel_rel_err"
MEDIAN_REL_ERR = "median_channel_rel_err"


def sample_channels(channels: int, groups: int, seed: int) -> list[int]:
    """One channel from each of ``groups`` equal runs of the channels
    (each shard of a channel mesh, each half of a batch), drawn from the
    seed."""
    rng = np.random.default_rng(seed_for(seed, 101))
    groups = max(1, min(groups, channels))
    edges = np.linspace(0, channels, groups + 1).astype(int)
    return [int(rng.integers(edges[g], edges[g + 1])) for g in range(groups)]


def sample_jobs(count: int, upto: int, seed: int) -> list[int]:
    """``count`` distinct job indices below ``upto``, drawn from the seed."""
    rng = np.random.default_rng(seed_for(seed, 102))
    upto = max(upto, count)
    return sorted(int(i) for i in rng.choice(upto, size=count,
                                             replace=False))


def rel_errs(got: torch.Tensor, want: torch.Tensor) -> list[float]:
    """Each row's ``||got - want|| / ||want||``."""
    got = got.to(torch.float64)
    want = want.to(torch.float64)
    num = torch.linalg.vector_norm(got - want, dim=-1)
    den = torch.linalg.vector_norm(want, dim=-1).clamp_min(1e-300)
    return (num / den).tolist()


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst row's ``||got - want|| / ||want||``."""
    return max(rel_errs(got, want))


def numbers(per_answer: list[list[float]]) -> dict:
    """The two compared numbers from each answer's channel errors; None
    (not correct) where no answer was compared."""
    if not per_answer:
        return {REL_ERR: None, MEDIAN_REL_ERR: None}
    return {REL_ERR: max(max(e) for e in per_answer),
            MEDIAN_REL_ERR: max(statistics.median(e) for e in per_answer)}


def error_share(got: torch.Tensor, want: torch.Tensor,
                fraction: float = 1e-4) -> float:
    """The share of the squared error that the worst ``fraction`` of the
    samples carry (near 1: a few short stretches, as where a compressor's
    or a gate's mask flips on a sample within rounding of its threshold;
    near ``fraction``: rounding spread everywhere)."""
    e = (got.to(torch.float64) - want.to(torch.float64)).flatten() ** 2
    total = float(e.sum())
    if total == 0.0:
        return 0.0
    k = max(1, int(fraction * e.numel()))
    return float(torch.topk(e, k).values.sum()) / total


def reference(config: dict, x: torch.Tensor, block_size: int,
              precision: str = "float64") -> torch.Tensor:
    """The reference's output for (C, T) input ``x`` (T whole blocks)."""
    return ref.render(config["effects"], x.to(torch.float64),
                      int(config["sample_rate"]), block_size, precision)


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a reading (None) fails."""
    shown, ok = {}, True
    for name, lim in limits.items():
        v = numbers.get(name)
        shown[name] = {"value": v, "limit": lim["limit"]}
        if v is None or not v <= lim["limit"]:
            ok = False
    for name in numbers:
        if name not in limits:
            raise KeyError(f"{name!r} is compared but has no limit")
    return ok, shown
