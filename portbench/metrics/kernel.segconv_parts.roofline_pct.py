"""The offline FIR in partitions (``segconv_kernel``): the frozen
roofline's least time of each job's partitions over their profiler time
in the traced window.

The cell's one maximal run of LTI effects (the filters of
``geometry.FILTERS`` and the reverb) has the stripped length
``geometry.stripped_taps`` gives (through the reference's ``kernel``). The
partition plan frozen here cuts it into ``P`` partitions, each costed by
the frozen ``roofline.conv_cost`` at its own taps; every partition after
the first also reads the output back (its accumulate mode), ``4 C T``
bytes more. The least time is ``(launches / P)`` times the partitions'
sum. None unless the launches are a whole number of jobs' partitions."""

import os
from functools import lru_cache

from portbench import geometry, roofline, spec
from portbench.readers import kernel, one, roofline_pct

# The partition plan when this metric was defined
# (ops/fft_filter.plan_partitions): a stripped kernel whose halo (its reach
# rounded up to roofline.HALO_STEP samples) is at most half of the largest
# window, 65,536, is one partition; a longer one is cut into consecutive
# slices of 16,385 taps, the last one shorter.
MAX_WINDOW = 65536
PARTITION_TAPS = 16385
LTI = geometry.FILTERS + ("reverb",)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def partitions(taps: int) -> list[int]:
    """Each partition's taps under the frozen plan."""
    step = roofline.HALO_STEP
    halo = step * max(1, -(-(taps - 1) // step))
    if 2 * halo <= MAX_WINDOW:
        return [taps]
    return [min(PARTITION_TAPS, taps - o)
            for o in range(0, taps, PARTITION_TAPS)]


def job_bound_s(C: int, T: int, taps: int, device_name: str) -> float:
    """The least time of one job's partitions over (C, T)."""
    total = 0.0
    for p, t in enumerate(partitions(taps)):
        c = roofline.conv_cost(C, T, t)
        if p:
            c = roofline.cost(c["bytes"] + 4 * C * T, c["fp32_flops"])
        total += roofline.bound_s(c, device_name)
    return total


@lru_cache(maxsize=None)
def lti_taps(cell: str, root: str, block_size: int) -> int | None:
    """The stripped taps of the cell's one LTI run (None: none, or more)."""
    config = spec.cell(cell, root=root).config
    run = one(geometry.runs(config["effects"], LTI))
    if run is None:
        return None
    return geometry.stripped_taps(run, config["sample_rate"], block_size)


def read(rec):
    k = kernel(rec, "segconv_kernel")
    if rec.loop != "offline" or k is None:
        return None
    g = rec.geometry
    taps = lti_taps(rec.cell, ROOT, g["B"])
    if taps is None:
        return None
    launches, seconds = k
    P = len(partitions(taps))
    if launches % P:
        return None
    return roofline_pct(
        launches // P * job_bound_s(g["C"], g["T"], taps, rec.device_name),
        seconds)
