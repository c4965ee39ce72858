"""The traced window: ``torch.profiler`` over the window of a ``--trace 1``
run, reduced to what the per-layer readers and the result's ``breakdown``
need.

The device's work is every kernel, memcpy and memset the profiler saw
(CUPTI), the interval the harness's own ``portbench.window`` span covers
is the window. Busy time is the union of the device intervals inside it;
an idle gap is a stretch of the window with none, labelled by the
shortest host event (a PyTorch op, a CUDA runtime call or a harness span)
that covers its middle, "python" where none does.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from contextlib import contextmanager

import torch

WINDOW_SPAN = "portbench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation")
TOP = 10
# host events looked at, back from a gap's middle, for the one covering it
LOOK_BACK = 256


def kernel_name(name: str) -> str:
    """``void walk_kernel<true>(float const*, ...)`` -> ``walk_kernel``;
    memcpy and memset names stay as the profiler gives them."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    base = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                  "")
    base = base.split("(")[0].split("<")[0].strip()
    return base.rsplit("::", 1)[-1] or name


class Profile:
    """A profiler over a block of code; :meth:`summary` after it."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    @contextmanager
    def window(self):
        """Profile what runs inside, marked as the window."""
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile, record_function
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        with self.prof:
            with record_function(WINDOW_SPAN):
                yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()

    def summary(self) -> dict:
        return summarise(self.prof.profiler.kineto_results.events())


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def kind_of(e) -> str:
    """The event's activity kind, from its device and name."""
    note = hasattr(e, "is_user_annotation") and e.is_user_annotation()
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        name = e.name()
        if note or name == WINDOW_SPAN:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if note or e.name() == WINDOW_SPAN:
        return "user_annotation"
    return "cpu_op"


def summarise(events) -> dict:
    """Window, busy and idle time, each device operation's count and time,
    and the breakdown (the operations that took most time, the idle time
    by what the host was doing) of a profiler's events."""
    spans = []
    dev, host = [], []
    for e in events:
        kind = kind_of(e)
        if kind in DEVICE_KINDS:
            dev.append((e.start_ns(), e.end_ns(), kernel_name(e.name())))
        elif kind in HOST_KINDS:
            if e.name() == WINDOW_SPAN:
                spans.append((e.start_ns(), e.end_ns()))
            else:
                host.append((e.start_ns(), e.end_ns(), e.name()))
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    # the host's span: the longest (a device-side copy of it, where the
    # profiler gives one, lies within it)
    w0, w1 = max(spans, key=lambda ab: ab[1] - ab[0])
    by_name: dict = defaultdict(lambda: [0, 0.0])
    clipped = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        clipped.append((a, b))
        by_name[name][0] += 1
        by_name[name][1] += (b - a) * 1e-9
    busy = _union(clipped)
    busy_s = sum(b - a for a, b in busy) * 1e-9
    window_s = (w1 - w0) * 1e-9
    gaps, last = [], w0
    for a, b in busy:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if w1 > last:
        gaps.append((last, w1))
    host.sort()
    starts = [h[0] for h in host]
    idle_by: dict = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid)
        best = None
        for h in host[max(0, i - LOOK_BACK):i][::-1]:
            if h[1] >= mid and (best is None
                                or h[1] - h[0] < best[1] - best[0]):
                best = h
        idle_by[best[2] if best else "python"] += (b - a) * 1e-9
    ops = sorted(((k, v[1]) for k, v in by_name.items()),
                 key=lambda kv: -kv[1])
    return {
        "window_s": window_s, "busy_s": busy_s,
        "idle_pct": 100.0 * (1.0 - busy_s / window_s),
        "device_events": sum(v[0] for v in by_name.values()),
        "by_name": {k: list(v) for k, v in by_name.items()},
        "breakdown": {
            "device_ops": [[k, s] for k, s in ops[:TOP]],
            "idle_gaps": [[k, s] for k, s in sorted(
                idle_by.items(), key=lambda kv: -kv[1])[:TOP]]},
    }
