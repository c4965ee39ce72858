"""``convpairs_kernel`` launches in the traced window over the steps in
it: the streamed FIR's launches a step, one a part of its stream plan
(a partition of its kernel, or a sub-block). A change of the stream plan
shows here first."""

from portbench.readers import kernel


def read(rec):
    k = kernel(rec, "convpairs_kernel")
    if rec.loop != "stream" or k is None or not rec.traced_units:
        return None
    return k[0] / rec.traced_units
