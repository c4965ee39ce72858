"""100 minus the union of the kernel, memcpy and memset intervals over
the traced window, in percent (stream loop)."""


def read(rec):
    if rec.loop != "stream" or rec.profile is None:
        return None
    return rec.profile["idle_pct"]
