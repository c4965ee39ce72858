"""``segconv_kernel`` launches in the traced window over the jobs in it:
the offline FIR's launches a job, one a partition of its kernel. A change
of the partition plan shows here first."""

from portbench.readers import kernel


def read(rec):
    k = kernel(rec, "segconv_kernel")
    if rec.loop != "offline" or k is None or not rec.traced_units:
        return None
    return k[0] / rec.traced_units
