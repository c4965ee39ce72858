"""The slowest rank's mean CUDA-event job time over the fastest rank's,
less one, in percent."""


def read(rec):
    if rec.loop != "sharded" or not rec.ranks:
        return None
    times = [r["device_ms_mean"] for r in rec.ranks]
    if None in times or min(times) <= 0:
        return None
    return 100.0 * (max(times) / min(times) - 1.0)
