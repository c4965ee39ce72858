"""Profiling: the program's spans and stage marks, per-effect scopes and a
TensorBoard trace.

Counterpart of ``pyaudiodsptools_tpu/profiling.py``, and beyond it:

* ``enable`` switches the program's own tracing on (off by default) and
  ``trace`` turns it on for its duration. With it on:

  - ``span(name)`` records a host span, a ``torch.profiler.record_function``
    scope, while a profiler records (with none recording it costs one more
    flag check). The top span of each call carries the call's sequence
    number (``render#12``), and its parts nest inside it by time on one
    thread. The names are ``<layer>.<part>``: ``graph.capture``; ``render``
    with ``render.copy_in``, ``render.replay``, ``render.copy_out``;
    ``step`` with ``step.to_tensor``, ``step.copy_in``, ``step.replay``,
    ``step.copy_out``; ``sharded.render`` with ``sharded.copy_in``,
    ``sharded.replay``, ``sharded.copy_out`` and, where the mesh's
    exchanges run between graphs (gloo), ``sharded.exchange.<what>``.
  - a graph captured while it is on (``engine/graph.py``,
    ``parallel/captured.py``) records ``mark()``, one launch of the no-op
    ``trace_mark_kernel``, at each boundary of its stages: before the first
    executed effect, between two, after the last, after the streaming
    step's state write-back, and around each exchange of a sharded program
    (under NCCL the mark after it waits for the collective, peers
    included). A FIR of two or more partitions also marks between its
    partitions (``part``; the render's segconv launches, the streaming
    step's convpairs launches), its stages named ``<effect>.part0``,
    ``<effect>.part1``, ... The graphs' ``stages()``
    give the stage names in order. A
    replay runs the marks with it, so the trace's device clock puts every
    operation of a replay, and every idle gap between its first and last
    mark, in one stage. Marks never go inside a conditional node.

  Tracing has to be on before a graph is captured: a graph captured with it
  off has no mark and launches exactly what it launched before marks
  existed, and one captured with it on keeps its marks. ``attribute``
  reads spans and stages back from a profiler.
* ``annotate_chain`` wraps each op's ``step`` and ``offline`` in a named
  scope (``effect.<name>.step``, ``effect.<name>.offline``), so that a trace
  of the eager chain attributes the kernels an op launches to the user's
  effect.
* ``trace`` is a context manager around ``torch.profiler.profile`` that
  writes a TensorBoard-readable trace directory and yields the profiler.

For Nsight Systems, run the code under
``torch.autograd.profiler.emit_nvtx()``: the scopes become NVTX ranges.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import threading
from collections import defaultdict

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)

from .core.config import DEFAULT_DEVICE, resolve_device

MARK_KERNEL = "trace_mark_kernel"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_KINDS = ("cuda_runtime", "cuda_driver")

_enabled = False
_profiler_enabled = torch._C._autograd._profiler_enabled


def enable(on: bool = True) -> None:
    """Switch the program's spans and marks on (or off). Graphs capture
    their marks when they are captured: switch it on before the first
    render or step."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


class _NoSpan:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str, seq: int | None = None):
    """A host span named ``name`` (``name#seq`` for a call's top span):
    the shared no-op unless tracing is on and a profiler records."""
    if not _enabled or not _profiler_enabled():
        return _NO_SPAN
    return record_function(name if seq is None else f"{name}#{seq}")


def mark(device=None) -> None:
    """Launch the no-op ``trace_mark_kernel`` (one thread) on ``device``'s
    current stream: a stage boundary of the graph being captured."""
    from .kernels import _build

    stream = torch.cuda.current_stream(device)
    err = _build.launcher("trace_mark", "trace_mark_launch",
                          [ctypes.c_void_p])(stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"trace_mark_kernel failed with CUDA error {err}")


class _Parts(threading.local):
    found = None     # a list while a traced stage is being recorded


_parts = _Parts()


@contextlib.contextmanager
def stage_parts(on: bool = True):
    """Around one stage of a graph captured with tracing on: yields a list
    that gets an entry at each boundary between two parts of the stage
    that the code inside marks with :func:`part`. Off (``on`` False) it
    yields an empty list and nothing inside marks."""
    outer = _parts.found
    _parts.found = [] if on else None
    try:
        yield _parts.found if on else []
    finally:
        _parts.found = outer


def part(device=None) -> None:
    """A boundary between two parts of one stage (the partitions of a
    FIR): a :func:`mark` inside :func:`stage_parts` on this thread, else
    nothing."""
    if _parts.found is not None:
        mark(device)
        _parts.found.append(device)


def stage_names(name: str, boundaries: int) -> list[str]:
    """The stage ``name``, or with part boundaries inside it its parts
    ``name.part0``, ``name.part1``, ..."""
    if not boundaries:
        return [name]
    return [f"{name}.part{i}" for i in range(boundaries + 1)]


def unique(names) -> list[str]:
    """``names`` with a repeated name numbered (``tail``, ``tail.1``): one
    stage name a stage."""
    seen: dict[str, int] = {}
    out = []
    for n in names:
        k = seen.get(n, 0)
        seen[n] = k + 1
        out.append(n if k == 0 else f"{n}.{k}")
    return out


def _wrap(eff):
    name = eff.name
    inner_step, inner_offline = eff.step, eff.offline

    # every argument passes through: a FIR step's use_kernels, the tremolo's
    # first_block, a sharded render's keywords
    def step(*args, **kwargs):
        with record_function(f"effect.{name}.step"):
            return inner_step(*args, **kwargs)

    offline = None
    if inner_offline is not None:
        def offline(*args, **kwargs):
            with record_function(f"effect.{name}.offline"):
                return inner_offline(*args, **kwargs)

    # _replace keeps reach, block_indexed, lti_kernel and device
    return eff._replace(step=step, offline=offline)


def annotate_chain(chain):
    """A copy of the chain whose ops carry named profiler scopes.

    Fusion is disabled so each op stays a separately scoped region (the
    point of profiling is per-op attribution; the production chain fuses).
    The copy runs on the chain's device and renders the same bits as
    ``Chain(chain.effects, fuse=False)``."""
    from .engine.chain import Chain

    return Chain([_wrap(e) for e in chain.effects], fuse=False,
                 device=chain.device)


@contextlib.contextmanager
def trace(log_dir: str, device=DEFAULT_DEVICE):
    """Capture a profiler trace into ``log_dir``, the program's tracing on
    for the duration: ``with profiling.trace('/tmp/tb') as prof:``. Yields
    the profiler (``attribute(prof)`` once the block has ended). On a card
    it records CPU and CUDA activity (raises without a card);
    ``device="cpu"`` records the CPU's."""
    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    was = _enabled
    enable()
    try:
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(log_dir)) as p:
            yield p
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    finally:
        enable(was)


# -- reading spans and stages back ---------------------------------------------


def _union(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class _Measure:
    """Overlap of any interval with a sorted union of disjoint intervals."""

    def __init__(self, union):
        self.starts = [a for a, _ in union]
        self.union = union
        self.prefix = [0]
        for a, b in union:
            self.prefix.append(self.prefix[-1] + b - a)

    def __call__(self, lo: int, hi: int) -> int:
        j = bisect.bisect_left(self.starts, hi)
        if hi <= lo or j == 0:
            return 0
        i = max(bisect.bisect_right(self.starts, lo) - 1, 0)
        total = self.prefix[j] - self.prefix[i]
        a, b = self.union[i]                 # the first may start before lo
        total -= max(0, min(b, lo) - a)
        a, b = self.union[j - 1]             # the last may end after hi
        total -= max(0, b - max(a, hi))
        return total


class _Spans:
    """User-annotation spans by thread, nested by time, each with its
    parent."""

    def __init__(self, spans):
        self.by_thread: dict = defaultdict(list)
        for s in spans:
            self.by_thread[s["thread"]].append(s)
        self.starts = {}
        for th, items in self.by_thread.items():
            items.sort(key=lambda s: (s["t0"], -s["t1"]))
            stack: list = []
            for s in items:
                while stack and stack[-1]["t1"] < s["t1"]:
                    stack.pop()
                s["parent"] = stack[-1] if stack else None
                if stack:
                    stack[-1]["child_ns"] += s["t1"] - s["t0"]
                stack.append(s)
            self.starts[th] = [s["t0"] for s in items]

    def innermost(self, t: int):
        """The shortest span holding ``t``, on any thread."""
        best = None
        for th, items in self.by_thread.items():
            i = bisect.bisect_right(self.starts[th], t) - 1
            s = items[i] if i >= 0 else None
            while s is not None and s["t1"] < t:
                s = s["parent"]
            if s is not None and (best is None or s["t1"] - s["t0"]
                                  < best["t1"] - best["t0"]):
                best = s
        return best


def _base(name: str) -> str:
    return name.split("#", 1)[0]


def _kind(e) -> str:
    """The event's activity kind (``kernel``, ``cuda_runtime``,
    ``user_annotation``, ...) from its device and name (the runtime's and
    the driver's calls are ``cu...``)."""
    note = e.is_user_annotation()
    name = e.name()
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        if note:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if note:
        return "user_annotation"
    return "cuda_runtime" if name.startswith("cu") else "cpu_op"


def attribute(events, stages=None, window=None) -> dict:
    """Spans and stages of a profiler's events (a ``torch.profiler.profile``
    after its block, or its ``profiler.kineto_results.events()``).

    Returns ``{"spans", "stages", "idle_by", "replay_busy_s",
    "staged_busy_s", "window_s", "busy_s"}``, seconds throughout:

    * ``spans``: for each user-annotation name (a top span's ``#seq``
      dropped) its ``count``, ``host_s``, ``self_s`` (less its child
      spans), ``idle_s`` (the device idle inside it) and ``device_s`` (the
      device operations whose runtime call lies inside it, matched by
      correlation id; a graph's replay holds all its nodes);
    * ``stages``: for each stage name, the ``replays`` and the mean
      ``busy_s`` and ``idle_s`` a replay between its two marks. A replay's
      marks are the ``trace_mark_kernel`` launches of one graph launch
      (one correlation id); ``stages`` (a graph's ``stages()``) names the
      gaps between them in order, each replay taking the next names
      (several graphs a call, as a gloo program's pieces, in turn);
      without it they are ``stage.<i>``;
    * ``idle_by``: the idle time inside ``window`` ((start, end) ns; the
      trace's extent without it), ``stage:<name>`` inside a stage (a stage
      runs from its mark's start to the next mark's, its mark's own time
      idle in it), elsewhere by the innermost span holding a gap's middle,
      else ``"none"``;
    * ``replay_busy_s``: the busy time of the operations that graph
      launches ran, and ``staged_busy_s`` the part of it between marks.

    Marks are left out of every device sum."""
    if hasattr(events, "profiler"):
        events = events.profiler.kineto_results.events()
    spans, runtime, device, marks = [], {}, [], []
    lo, hi = None, None
    for e in events:
        kind = _kind(e)
        t0, t1 = e.start_ns(), e.end_ns()
        if kind in DEVICE_KINDS:
            if MARK_KERNEL in e.name():
                marks.append((t0, t1, e.correlation_id()))
            else:
                device.append((t0, t1, e.correlation_id()))
        elif kind in RUNTIME_KINDS:
            runtime[e.correlation_id()] = (t0, e.name())
        elif kind == "user_annotation":
            spans.append({"name": _base(e.name()), "t0": t0, "t1": t1,
                          "thread": e.start_thread_id(), "child_ns": 0,
                          "device_ns": 0})
        else:
            continue
        lo = t0 if lo is None else min(lo, t0)
        hi = t1 if hi is None else max(hi, t1)
    w0, w1 = window if window is not None else (lo or 0, hi or 0)
    busy = _union((max(a, w0), min(b, w1)) for a, b, _ in device
                  if min(b, w1) > max(a, w0))
    busy_in = _Measure(busy)
    gaps, last = [], w0
    for a, b in busy:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if w1 > last:
        gaps.append((last, w1))
    idle_in = _Measure(gaps)
    tree = _Spans(spans)

    # device operations to the spans that hold their runtime call
    replay_ops = []
    for a, b, corr in device:
        call = runtime.get(corr)
        if call is None:
            continue
        if call[1].startswith("cudaGraphLaunch"):
            replay_ops.append((a, b))
        # by time alone: CUPTI's thread ids need not be the profiler's
        s = tree.innermost(call[0])
        while s is not None:
            s["device_ns"] += b - a
            s = s["parent"]

    # stages between each replay's marks
    by_replay: dict = defaultdict(list)
    for m in marks:
        by_replay[m[2]].append(m)
    names = list(stages or [])
    cursor = 0
    stage_rows: dict = defaultdict(lambda: [0, 0, 0])
    stage_spans = []
    for group in sorted(by_replay.values(), key=min):
        group.sort()
        k = len(group) - 1
        if names and cursor + k > len(names):
            cursor = 0
        for i in range(k):
            # a stage from its mark's start to the next mark's: the stages
            # tile the replay, the marks' own time idle in them
            a, b = group[i][0], group[i + 1][0]
            name = names[cursor + i] if names and cursor + i < len(names) \
                else f"stage.{i}"
            row = stage_rows[name]
            row[0] += 1
            row[1] += busy_in(a, b)
            row[2] += idle_in(a, b)
            stage_spans.append((a, b, name))
        cursor = (cursor + k) % len(names) if names else 0
    stage_spans.sort()
    stage_starts = [s[0] for s in stage_spans]
    replay_busy = _union(replay_ops)
    staged = _Measure(_union((a, b) for a, b, _ in stage_spans))

    # each gap cut at the stages' bounds: a part in a stage is the stage's,
    # another part goes to the innermost span holding its middle
    idle_by: dict = defaultdict(int)
    for a, b in gaps:
        i = max(bisect.bisect_right(stage_starts, a) - 1, 0)
        while a < b:
            while i < len(stage_spans) and stage_spans[i][1] <= a:
                i += 1
            if i < len(stage_spans) and stage_spans[i][0] <= a:
                end = min(b, stage_spans[i][1])
                label = "stage:" + stage_spans[i][2]
            else:
                end = min(b, stage_spans[i][0]) if i < len(stage_spans) \
                    else b
                s = tree.innermost((a + end) // 2)
                label = s["name"] if s is not None else "none"
            idle_by[label] += end - a
            a = end

    span_rows: dict = {}
    for s in spans:
        row = span_rows.setdefault(s["name"], [0, 0, 0, 0, 0])
        row[0] += 1
        row[1] += s["t1"] - s["t0"]
        row[2] += s["t1"] - s["t0"] - s["child_ns"]
        row[3] += idle_in(s["t0"], s["t1"])
        row[4] += s["device_ns"]
    ns = 1e-9
    return {
        "window_s": (w1 - w0) * ns,
        "busy_s": sum(b - a for a, b in busy) * ns,
        "spans": {name: {"count": r[0], "host_s": r[1] * ns,
                         "self_s": r[2] * ns, "idle_s": r[3] * ns,
                         "device_s": r[4] * ns}
                  for name, r in span_rows.items()},
        "stages": {name: {"replays": r[0], "busy_s": r[1] * ns / r[0],
                          "idle_s": r[2] * ns / r[0]}
                   for name, r in stage_rows.items()},
        "idle_by": {k: v * ns for k, v in sorted(idle_by.items(),
                                                 key=lambda kv: -kv[1])},
        "replay_busy_s": sum(b - a for a, b in replay_busy) * ns,
        "staged_busy_s": sum(staged(a, b) for a, b in replay_busy) * ns,
    }
