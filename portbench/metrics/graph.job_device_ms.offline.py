"""CUDA events on the stream around each job's ``render`` (the input
written into the graph's buffer, the replay, the output's copy), mean."""

from portbench.readers import mean


def read(rec):
    if rec.loop != "offline":
        return None
    return mean(rec.device_ms)
