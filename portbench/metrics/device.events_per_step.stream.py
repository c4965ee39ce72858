"""Kernel, memcpy and memset events on the device in the traced window,
over the steps in it (a count)."""


def read(rec):
    if rec.loop != "stream" or rec.profile is None or not rec.traced_units:
        return None
    return rec.profile["device_events"] / rec.traced_units
