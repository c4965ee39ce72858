"""The streamed FIR (``convpairs_kernel``): the frozen roofline's least
time of the traced steps' FIR over the kernel's profiler time in the
traced window.

The cost is frozen here, in bytes alone and independent of the windows,
partitions and launches the program picks, so that no later algorithm can
push the share past 100 %. A step of R channels of B samples through the
cell's one maximal run of LTI effects (the filters of ``geometry.FILTERS``
and the reverb), of K stripped taps (``geometry.stripped_taps``), reads
the K - 1 samples of history a channel and the block, and writes the
block into the state and the output: ``4 R (K - 1 + 3 B)`` bytes at the
HBM peak of ``portbench/roofline.py``. That bound assumes the history is
read from HBM every step; a program that keeps it resident in L2 would
need a benchmark change to reckon with. None off the stream loop, without
a traced launch or step, or without exactly one LTI run."""

import os
from functools import lru_cache

from portbench import geometry, roofline, spec
from portbench.readers import kernel, one, roofline_pct

LTI = geometry.FILTERS + ("reverb",)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def step_bytes(R: int, B: int, taps: int) -> int:
    """The bytes one step of the streamed FIR has to move at least."""
    return 4 * R * (taps - 1 + 3 * B)


@lru_cache(maxsize=None)
def lti_taps(cell: str, root: str, block_size: int) -> int | None:
    """The stripped taps of the cell's one LTI run (None: none, or more)."""
    config = spec.cell(cell, root=root).config
    run = one(geometry.runs(config["effects"], LTI))
    if run is None:
        return None
    return geometry.stripped_taps(run, config["sample_rate"], block_size)


def read(rec):
    k = kernel(rec, "convpairs_kernel")
    if rec.loop != "stream" or k is None or not rec.traced_units:
        return None
    g = rec.geometry
    taps = lti_taps(rec.cell, ROOT, g["B"])
    if taps is None:
        return None
    c = roofline.cost(step_bytes(g["C"], g["B"], taps), 0.0)
    return roofline_pct(
        rec.traced_units * roofline.bound_s(c, rec.device_name), k[1])
