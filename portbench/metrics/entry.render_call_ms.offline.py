"""Host clock around the ``render`` call until it returns (before the
synchronisation), mean over the window's jobs: the entry's host cost."""

from portbench.readers import mean


def read(rec):
    if rec.loop != "offline":
        return None
    return mean(rec.call_ms)
