"""The plain reference of the benchmark's chains: the effects of
pyAudioDspTools (upstream ``pyAudioDspTools``: ``CreateLowCutFilter``,
``CreateHighCutFilter``, ``EffectEQ3BandFFT``, ``CreateCompressor``,
``CreateGate``, ``CreateDelay``, ``CreateTremolo``, ``CreateSoftClipper``)
written from their definitions in plain PyTorch and NumPy, float64.

It designs every filter, ramp and LFO table itself and takes nothing from
the program under test: it imports neither the port nor the JAX package.
Each effect is a module of its own, ``reference/ops/<op>.py``, found by the
``op`` name a configuration file gives, with one function::

    apply(x, ctx, **params) -> y      # x, y: (channels, samples) tensors

``render`` runs a configuration's effect list in order. ``precision``
``"bfloat16"`` is the control: the same arithmetic with every signal,
table and product rounded to bfloat16 (work in float32), the nearest
precision below the float32 the configurations state.
"""

from __future__ import annotations

import importlib.util
import os
from dataclasses import dataclass
from typing import Callable

import torch

OPS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ops")


@dataclass(frozen=True)
class Ctx:
    sample_rate: int
    block_size: int
    work: torch.dtype                           # arithmetic dtype
    rnd: Callable[[torch.Tensor], torch.Tensor]  # storage rounding

    def ms_to_samples(self, ms: float) -> int:
        return int((self.sample_rate / 1000) * ms)


def make_ctx(sample_rate: int, block_size: int,
             precision: str = "float64") -> Ctx:
    if precision == "float64":
        return Ctx(sample_rate, block_size, torch.float64, lambda t: t)
    if precision == "bfloat16":
        return Ctx(sample_rate, block_size, torch.float32,
                   lambda t: t.to(torch.bfloat16).to(torch.float32))
    raise ValueError(f"no reference precision {precision!r}")


def load_op(name: str):
    """The module ``reference/ops/<name>.py``."""
    path = os.path.join(OPS_DIR, f"{name}.py")
    if not os.path.isfile(path):
        raise ValueError(f"the reference has no effect {name!r} "
                         f"(no {path})")
    spec = importlib.util.spec_from_file_location(f"_ref_op_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def render(effects: list[dict], x: torch.Tensor, sample_rate: int,
           block_size: int, precision: str = "float64") -> torch.Tensor:
    """Every effect of ``effects`` (``{"op": name, **params}``) over the
    (channels, samples) signal ``x``, whose length is whole blocks (the
    tremolo's table is walked a block at a time, as the upstream chunk loop
    does). Returns the output in the work dtype."""
    ctx = make_ctx(sample_rate, block_size, precision)
    if x.shape[-1] % block_size:
        raise ValueError(f"{x.shape[-1]} samples are not whole blocks of "
                         f"{block_size}")
    y = ctx.rnd(x.to(ctx.work))
    for e in effects:
        params = {k: v for k, v in e.items() if k != "op"}
        y = ctx.rnd(load_op(e["op"]).apply(y, ctx, **params))
    return y
