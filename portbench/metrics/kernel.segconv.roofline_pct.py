"""The offline conv (``segconv_kernel``): the frozen roofline's least time
of every launch in the traced window over their profiler time."""

from portbench.readers import kernel, roofline_pct, segconv_bound_s


def read(rec):
    k = kernel(rec, "segconv_kernel")
    bound = segconv_bound_s(rec)
    if k is None or bound is None:
        return None
    launches, seconds = k
    return roofline_pct(launches * bound, seconds)
