"""The streaming window's milliseconds over the steps it completed."""


def read(rec):
    if rec.loop != "stream" or not rec.units:
        return None
    return rec.window_s * 1e3 / rec.units
