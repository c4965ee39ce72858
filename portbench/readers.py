"""Arithmetic the metric readers (``metrics/<name>.py``) share."""

from __future__ import annotations

import statistics

from portbench import roofline


def mean(values) -> float | None:
    values = list(values)
    return statistics.fmean(values) if values else None


def percentile(values, q: float) -> float | None:
    """The q-th percentile, linear between the two nearest ranks."""
    v = sorted(values)
    if not v:
        return None
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def kernel(rec, name: str) -> tuple[int, float] | None:
    """(launches, seconds) of the kernel ``name`` in the traced window."""
    if rec.profile is None:
        return None
    hit = rec.profile["by_name"].get(name)
    return (int(hit[0]), float(hit[1])) if hit and hit[0] else None


def roofline_pct(bound_s: float, seconds: float) -> float:
    """The least time over the measured time, in percent."""
    return 100.0 * bound_s / seconds


def one(values: list):
    """The only entry of ``values``, else None (a reader that cannot tell
    which of several stages a launch belongs to reads nothing)."""
    return values[0] if len(values) == 1 else None


def segconv_bound_s(rec) -> float | None:
    g = rec.geometry
    taps = one(g.get("fir_taps", []))
    if taps is None:
        return None
    return roofline.bound_s(roofline.conv_cost(g["C"], g["T"], taps),
                            rec.device_name)


def tail_bound_s(rec) -> float | None:
    g = rec.geometry
    stages = one(g.get("tail_stages", []))
    if stages is None:
        return None
    return roofline.bound_s(roofline.tail_cost(g["C"], g["T"], stages),
                            rec.device_name)
