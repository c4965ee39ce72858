"""CUDA events around each traced ``process`` (the block's copy in, the
replay, the copy out), mean."""

from portbench.readers import mean


def read(rec):
    if rec.loop != "stream":
        return None
    return mean(rec.device_ms)
