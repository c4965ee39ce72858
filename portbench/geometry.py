"""The shapes a run's kernels work on, from the configuration and the
traffic alone: what the roofline readers turn into bytes and operations."""

from __future__ import annotations

from functools import reduce

import numpy as np

from portbench import reference as ref

FILTERS = ("lowcut", "highcut", "eq3band_fft")
DYNAMICS = ("compressor", "gate")
TAIL = ("delay", "tremolo", "softclipper", "saturator", "harddistortion",
        "bitcrusher")


def runs(effects: list[dict], kinds: tuple) -> list[list[dict]]:
    """Maximal runs of consecutive effects whose op is in ``kinds``."""
    out, cur = [], []
    for e in effects + [{"op": None}]:
        if e["op"] in kinds:
            cur.append(e)
        elif cur:
            out.append(cur)
            cur = []
    return out


def stripped_taps(run: list[dict], sample_rate: int, block_size: int) -> int:
    """Taps of a filter run's cascade without its leading zeros."""
    ctx = ref.make_ctx(sample_rate, block_size)
    k = reduce(np.convolve, [
        ref.load_op(e["op"]).kernel(ctx, **{a: v for a, v in e.items()
                                            if a != "op"})
        for e in run])
    nz = np.flatnonzero(k)
    return len(k) - int(nz[0])


def tail_stages(run: list[dict]) -> list[tuple]:
    stages = []
    for e in run:
        if e["op"] == "delay":
            stages.append(("taps", int(e["feedback_loops"])))
        elif e["op"] == "tremolo":
            stages.append(("gain",))
        else:
            stages.append(("map", e["op"]))
    return stages


def of(config: dict, block_size: int, channels: int, n: int) -> dict:
    """C, T (padded to whole blocks), the filter runs' stripped taps, the
    dynamics runs' op counts and the tail runs' stages (runs of two or
    more effects: a lone one runs as a plain op)."""
    effects = config["effects"]
    sr = config["sample_rate"]
    nb = -(-n // block_size)
    return {
        "C": channels, "T": nb * block_size, "n": n, "B": block_size,
        "fir_taps": [stripped_taps(r, sr, block_size)
                     for r in runs(effects, FILTERS)],
        "dynamics_ops": [len(r) for r in runs(effects, DYNAMICS)],
        "tail_stages": [tail_stages(r) for r in runs(effects, TAIL)
                        if len(r) >= 2],
    }
