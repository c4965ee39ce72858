"""Conditional while and if nodes in a CUDA graph being captured, and the
record of the dynamics fixpoints that run in one.

PyTorch's ``CUDAGraph`` builds *if* nodes only, on handles of its own;
``csrc/graph_cond.cu`` builds both kinds, so that the offline render's one
loop whose trip count depends on the data, the dynamics fixpoint
(``kernels/dynamics.dynamics_offline``), runs inside the captured render as
the JAX package's ``lax.while_loop`` runs inside its jitted render, and a
captured sharded render skips dynspec's walks once its rounds settled
(``parallel/dynspec.py``). :func:`while_node` adds a while node and captures
its body; a kernel of the body sets the node's condition on the card (the
settle step of ``dynamics.cu``). :func:`if_node` adds an if node on a handle
made before it (:func:`if_handle`), which a kernel captured before the node
sets (the round gate of ``dynamics.cu``).

A fixpoint records its settle flags (``dynamics.FLAG_*``) with
:func:`note_fixpoint`; a caller that wants them (``engine/graph.py``'s
``CapturedRender``, to read a replay's walks) opens :func:`fixpoints` around
the code that runs them. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from . import _build


class CaptureError(RuntimeError):
    """A step or a render could not be captured in a CUDA graph."""


_body_streams: dict[int, torch.cuda.ExternalStream] = {}
_fixpoints = threading.local()


def _fn(name: str, argtypes: list):
    return _build.launcher("graph_cond", name, argtypes)


def cuda_versions() -> tuple[int, int]:
    """(driver, runtime) CUDA versions as ``cudaDriverGetVersion`` gives
    them (12040 is 12.4): a while node needs 12.4 or later of both."""
    driver, runtime = ctypes.c_int(), ctypes.c_int()
    err = _fn("graph_cond_versions", [ctypes.c_void_p] * 2)(
        ctypes.byref(driver), ctypes.byref(runtime))
    if err != 0:
        raise RuntimeError(f"cudaDriverGetVersion failed with {err}")
    return driver.value, runtime.value


def body_stream(device: torch.device) -> torch.cuda.ExternalStream:
    """The stream that captures while-node bodies on ``device``, made once
    (a stream of PyTorch's pool may be handed to other code, whose launches
    would then be captured into a body). Call it before a capture begins:
    it loads ``graph_cond``'s library and creates the stream."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = _body_streams.get(index)
    if stream is None:
        raw = ctypes.c_void_p()
        with torch.cuda.device(index):
            err = _fn("graph_body_stream_create", [ctypes.c_void_p])(
                ctypes.byref(raw))
        if err != 0:
            raise CaptureError(f"creating a stream for while-node bodies "
                               f"failed with CUDA error {err}")
        stream = _body_streams[index] = torch.cuda.ExternalStream(
            raw.value, device=torch.device("cuda", index))
    return stream


def _allocations(device) -> int:
    return torch.cuda.memory_stats(device).get("allocation.all.allocated", 0)


def _handle(device, default: int) -> int:
    """A conditional handle in the graph being captured on ``device``'s
    current stream, reset to ``default`` at every launch of the graph."""
    handle = ctypes.c_ulonglong()
    err = _fn("graph_cond_handle",
              [ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p])(
        torch.cuda.current_stream(device).cuda_stream, default,
        ctypes.byref(handle))
    if err != 0:
        driver, runtime = cuda_versions()
        raise CaptureError(
            f"making a conditional handle failed with CUDA error {err} "
            f"(driver {driver}, runtime {runtime}; conditional nodes need "
            "12040 or later of both, and a capture in progress on the "
            "current stream)")
    return handle.value


def if_handle(device) -> int:
    """A handle for an :func:`if_node` of the graph being captured on
    ``device``'s current stream: 0 at every launch of the graph, so that a
    kernel captured before the node must set it (``cudaGraphSetConditional``,
    1: run the body) for the body to run."""
    return _handle(torch.device(device), 0)


@contextlib.contextmanager
def _conditional(device, handle: int, is_while: bool):
    kind = "while" if is_while else "if"
    outer = torch.cuda.current_stream(device)
    body = body_stream(device)
    err = _fn("graph_cond_begin",
              [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong,
               ctypes.c_int])(outer.cuda_stream, body.cuda_stream, handle,
                              int(is_while))
    if err != 0:
        raise CaptureError(f"adding a conditional {kind} node failed with "
                           f"CUDA error {err}")
    allocated = _allocations(device)
    failed = None
    try:
        with torch.cuda.stream(body):
            yield handle
    except Exception as exc:
        failed = exc
    err = _fn("graph_cond_end", [ctypes.c_void_p])(body.cuda_stream)
    if failed is not None:
        raise failed
    if err != 0:
        raise CaptureError(f"ending the capture of a {kind} node's body "
                           f"failed with CUDA error {err}")
    if _allocations(device) != allocated:
        raise CaptureError(f"a tensor was allocated inside a {kind} node's "
                           "body: it would lie outside the graph's pool")


@contextlib.contextmanager
def while_node(device):
    """Inside a capture on ``device``'s current stream: add a conditional
    while node to the graph being captured and capture the ``with`` body
    into the node's body graph, on a stream of its own that is current
    inside. Yields the node's conditional handle (an int), which a kernel of
    the body sets with ``cudaGraphSetConditional`` (1: run the body again).
    The handle is 1 at every launch of the graph, so the body runs at least
    once. What the outer stream captures after the block runs after the
    loop. The body may allocate no tensor (it would come from outside the
    graph's private pool): every buffer it touches is made before it, and
    an allocation inside raises :class:`CaptureError`, as does a driver or
    runtime older than CUDA 12.4."""
    device = torch.device(device)
    with _conditional(device, _handle(device, 1), True) as handle:
        yield handle


@contextlib.contextmanager
def if_node(device, handle: int):
    """Inside a capture on ``device``'s current stream: add a conditional if
    node on ``handle`` (:func:`if_handle`, set by a kernel captured before
    the node) and capture the ``with`` body into its body graph, as
    :func:`while_node` does; the body runs once where the handle is 1 when
    the node is reached, else not at all."""
    with _conditional(torch.device(device), handle, False):
        yield


# -- the record of fixpoints ---------------------------------------------------


@contextlib.contextmanager
def fixpoints():
    """Collect, in the list it yields, the settle flags (int32[4],
    ``dynamics.FLAG_*``) of every dynamics fixpoint that runs on this thread
    inside the block, eager or captured, in order. Reading them is the
    caller's (a synchronisation): an eager fixpoint's flags hold its walks
    when it returns, a captured one's those of the graph's last replay."""
    outer = getattr(_fixpoints, "sink", None)
    sink: list[torch.Tensor] = []
    _fixpoints.sink = sink
    try:
        yield sink
    finally:
        _fixpoints.sink = outer


def note_fixpoint(flags: torch.Tensor) -> None:
    """Called by a dynamics fixpoint with its settle flags: kept where a
    :func:`fixpoints` block is open on this thread, else dropped."""
    sink = getattr(_fixpoints, "sink", None)
    if sink is not None:
        sink.append(flags)
