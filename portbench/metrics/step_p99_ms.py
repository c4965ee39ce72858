"""The 99th percentile of every untraced step's host-clock time, from
handing the block to ``process`` until its numpy output is back (a traced
run's first ``trace_seconds`` run under the profiler and are left out)."""

from portbench.readers import percentile


def read(rec):
    if rec.loop != "stream" or len(rec.host_ms) <= rec.traced_units:
        return None
    return percentile(rec.host_ms[rec.traced_units:], 99.0)
