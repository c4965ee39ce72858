"""100 minus the union of the kernel, memcpy and memset intervals over
the traced window, in percent (offline loop)."""


def read(rec):
    if rec.loop != "offline" or rec.profile is None:
        return None
    return rec.profile["idle_pct"]
