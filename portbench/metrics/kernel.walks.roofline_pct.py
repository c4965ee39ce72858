"""The offline dynamics walks (``walk_kernel``): one state walk a job and
the audio walks after it, each at the frozen roofline's least time for the
job's shape, over the walk kernels' profiler time in the traced window.
The launches are the trace's; they equal the walks the device counted."""

from portbench import roofline
from portbench.readers import kernel, one, roofline_pct


def read(rec):
    k = kernel(rec, "walk_kernel")
    ops = one(rec.geometry.get("dynamics_ops", []))
    if k is None or ops is None or rec.loop != "offline":
        return None
    launches, seconds = k
    g = rec.geometry
    state = roofline.bound_s(roofline.walk_cost(g["C"], g["T"], ops, False),
                             rec.device_name)
    audio = roofline.bound_s(roofline.walk_cost(g["C"], g["T"], ops, True),
                             rec.device_name)
    jobs = rec.traced_units
    return roofline_pct(jobs * state + (launches - jobs) * audio, seconds)
