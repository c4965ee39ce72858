"""The fused tail (``tail_kernel``): the frozen roofline's least time of
every launch in the traced window over their profiler time."""

from portbench.readers import kernel, roofline_pct, tail_bound_s


def read(rec):
    k = kernel(rec, "tail_kernel")
    bound = tail_bound_s(rec)
    if k is None or bound is None:
        return None
    launches, seconds = k
    return roofline_pct(launches * bound, seconds)
