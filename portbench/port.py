"""The system under test, as the benchmark drives it: the chain a
configuration names, built from ``pyaudiodsptools_tpu_torch``'s op
factories, and the program's counters the readers may use. The only
module of the benchmark that imports the program."""

from __future__ import annotations

import pyaudiodsptools_tpu_torch as pt


def engine_config(config: dict, block_size: int):
    return pt.EngineConfig(int(config["sample_rate"]), int(block_size))


def chain(config: dict, block_size: int, device):
    """The configuration's effect list as a ``Chain`` on ``device``."""
    cfg = engine_config(config, block_size)
    effects = []
    for e in config["effects"]:
        params = {k: v for k, v in e.items() if k != "op"}
        effects.append(getattr(pt.ops, e["op"])(cfg, device=device,
                                                **params))
    return pt.Chain(effects, device=device), cfg


def walks_of(chain_) -> int:
    """The dynamics walks of the captured render's last replay, over its
    stages (reads the device)."""
    return sum(sum(w) for w in chain_.captured_render().walks().values())
