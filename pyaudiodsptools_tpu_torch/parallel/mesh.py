"""The ('channel', 'time') mesh over ``torch.distributed`` ranks.

Counterpart of ``pyaudiodsptools_tpu/parallel/mesh.py``. The axes are the
JAX package's:

* ``channel`` -- independent audio channels, embarrassingly parallel, no
  communication;
* ``time`` -- audio blocks sharded along time; FIR / tail windows take a left
  halo of whole blocks from the ranks before, the recurrent stages exchange
  states.

JAX runs one controller over a mesh of devices and GSPMD inserts the
exchanges. PyTorch runs one process a device, so a :class:`Mesh` is this
rank's view: the mesh's shape, this rank's (channel, time) coordinates, its
device, and a process group for each axis of size > 1 (made with
``torch.distributed.new_group``) and one for the whole mesh. Rank
``c * time + t`` holds shard (c, t), as JAX's ``reshape(channel, time)`` of
the device list lays them out. An axis of size 1 has no group, so
:func:`single_device_mesh` and a 1x1 mesh need no process group at all.

Every exchange is a method here and is explicit. NCCL takes CUDA tensors as
they are; gloo's collectives and point-to-point calls take CPU tensors only,
so where a group's backend is gloo each exchanged tensor is staged through
host memory and the result moved back to the rank's device. That is
transport, not a fallback: the compute stays on the rank's device. It is
also how several ranks share one card, which NCCL refuses.

Each exchange has a form that writes into buffers the caller made
(:meth:`Mesh.all_gather_into`, :meth:`Mesh.all_reduce_`,
:meth:`Mesh.shift_into`): under NCCL it allocates nothing and reads nothing
back to the host, so a CUDA graph can hold it (:attr:`Mesh.capturable`),
once :meth:`Mesh.warmup` has made NCCL's communicators outside any capture.
``all_reduce`` and ``shift``, which return new tensors, are built on
them. A rank program
(``parallel/sharding.py``) yields each exchange as an :class:`Exchange`,
which whoever runs the program runs at once (:func:`play`, or inside a
capture where the mesh is capturable) or between two CUDA graphs (gloo).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..core.config import DEFAULT_DEVICE, resolve_device

AXES = ("channel", "time")
_REDUCE_OPS = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}


def _world() -> tuple[int, int]:
    """(world size, this rank): (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def rank_device(device: Any = None) -> torch.device:
    """This rank's device: ``device`` (default ``"cuda"``), a CUDA device
    without an index taking the current one (``init_distributed`` sets it
    to the rank's own card under NCCL)."""
    dev = resolve_device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a ('channel', 'time') mesh (see the module
    docstring). ``coords`` is None on a rank outside the mesh."""

    shape: dict                    # {"channel": c, "time": t}
    coords: tuple[int, int] | None
    device: torch.device
    groups: dict                   # axis -> process group, None at size 1
    group: Any                     # the whole mesh's group, None for one rank
    ranks: tuple[int, ...]         # global ranks in mesh order

    @property
    def size(self) -> int:
        return self.shape["channel"] * self.shape["time"]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        if self.coords is None:
            raise ValueError("this rank is not part of the mesh")
        return self.coords[AXES.index(axis)]

    def _group(self, axis: str | None):
        return self.group if axis is None else self.groups[axis]

    def _peer(self, axis: str, i: int) -> int:
        """The global rank at coordinate ``i`` along ``axis`` from here."""
        c, t = self.coords
        c, t = (i, t) if axis == "channel" else (c, i)
        return self.ranks[c * self.shape["time"] + t]

    def _host_staged(self, group, x: torch.Tensor) -> bool:
        """Whether ``x`` goes through host memory: a CUDA tensor and gloo."""
        return x.is_cuda and dist.get_backend(group) == "gloo"

    @property
    def capturable(self) -> bool:
        """True where every group the mesh uses is NCCL (a mesh of one rank
        uses none): its exchanges can be captured in a CUDA graph. False
        where any is gloo, whose exchanges stage through host memory."""
        return all(dist.get_backend(g) == "nccl"
                   for g in (*self.groups.values(), self.group)
                   if g is not None)

    def all_gather_into(self, x: torch.Tensor, out: torch.Tensor,
                        axis: str | None = None) -> torch.Tensor:
        """Every rank's ``x`` (equal shapes) along ``axis`` (the whole mesh
        for None) written into ``out``, shaped ``(ranks,) + x.shape``, in
        coordinate (for the whole mesh: rank) order. Returns ``out``."""
        group = self._group(axis)
        if group is None:
            return out.copy_(x.unsqueeze(0))
        if self._host_staged(group, x):
            host = torch.empty(out.shape, dtype=out.dtype)
            dist.all_gather(list(host.unbind(0)), x.cpu(), group=group)
            return out.copy_(host)
        if out.is_cuda:
            dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        else:
            dist.all_gather(list(out.unbind(0)), x.contiguous(), group=group)
        return out

    def all_reduce_(self, x: torch.Tensor, op: str,
                    axis: str | None = None) -> torch.Tensor:
        """``x`` (contiguous) reduced (``"max"`` or ``"sum"``) over ``axis``
        (the whole mesh for None) in place. Returns ``x``."""
        group = self._group(axis)
        if group is None:
            return x
        if self._host_staged(group, x):
            host = x.cpu()
            dist.all_reduce(host, op=_REDUCE_OPS[op], group=group)
            return x.copy_(host)
        dist.all_reduce(x, op=_REDUCE_OPS[op], group=group)
        return x

    def all_reduce(self, x: torch.Tensor, op: str,
                   axis: str | None = None) -> torch.Tensor:
        """``x`` reduced (``"max"`` or ``"sum"``) over ``axis`` (the whole
        mesh for None); a new tensor on this rank's device."""
        return self.all_reduce_(x.clone(memory_format=torch.contiguous_format),
                                op, axis)

    def shift_into(self, x: torch.Tensor, out: torch.Tensor,
                   axis: str = "time") -> bool:
        """Point to point: send ``x`` to the next rank along ``axis`` and
        receive the previous rank's into ``out`` (same shape). The first
        rank receives nothing and leaves ``out`` as it is; returns whether
        ``out`` was written."""
        group = self.groups[axis]
        if group is None:
            return False
        i, n = self.index(axis), self.shape[axis]
        staged = self._host_staged(group, x)
        src = x.cpu() if staged else x.contiguous()
        buf = torch.empty(out.shape, dtype=out.dtype) if staged else out
        ops = []
        if i + 1 < n:
            ops.append(dist.P2POp(dist.isend, src, self._peer(axis, i + 1),
                                  group))
        if i > 0:
            ops.append(dist.P2POp(dist.irecv, buf, self._peer(axis, i - 1),
                                  group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if staged and i > 0:
            out.copy_(buf)
        return i > 0

    def shift(self, x: torch.Tensor, axis: str = "time"
              ) -> torch.Tensor | None:
        """Point to point: send ``x`` to the next rank along ``axis`` and
        return the previous rank's (same shape), or None on the first rank
        (which sends only)."""
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        return out if self.shift_into(x, out, axis) else None

    def warmup(self) -> None:
        """Run each exchange this rank makes, on each of its groups, once
        on a tiny tensor, and the shift along time: NCCL makes its
        communicators (and the shift's point-to-point links) at first use,
        which must happen outside any capture. Collective: every rank of
        the job calls it, in the same order."""
        if self.coords is None:
            return
        x = torch.zeros(1, dtype=torch.int32, device=self.device)
        for axis in ("time", "channel", None):
            group = self._group(axis)
            if group is None:
                continue
            n = dist.get_world_size(group)
            self.all_gather_into(x, x.new_empty((n, 1)), axis)
            self.all_reduce_(x.clone(), "max", axis)
        if self.groups["time"] is not None:
            self.shift_into(x, x.clone(), "time")


@dataclasses.dataclass(frozen=True)
class Exchange:
    """An exchange of a rank program, between buffers the program made:
    ``run()`` performs it. Whoever runs the program runs it at once
    (:func:`play`; inside a capture where the mesh is capturable) or between
    two CUDA graphs (gloo: it reads and writes host memory). ``what`` names
    it (``sharding.plan_cuts`` lists them)."""

    what: str
    run: Callable[[], Any]


def play(program, exchanged: list | None = None):
    """Run a rank program (a generator that yields :class:`Exchange` s and
    returns its output) eagerly, each exchange at once; returns the output.
    ``exchanged``, if given, receives each exchange's ``what``."""
    while True:
        try:
            ex = program.send(None)
        except StopIteration as stop:
            return stop.value
        ex.run()
        if exchanged is not None:
            exchanged.append(ex.what)


def make_mesh(channel: int | None = None, time: int = 1,
              device: Any = None) -> Mesh:
    """Build a ('channel', 'time') mesh over the job's ranks (one device a
    rank), collectively: every rank of the job calls it with the same
    arguments. With no arguments, all ranks go to the channel axis (pure DP,
    the right default for many-channel workloads). Ranks
    ``0 .. channel*time - 1`` form the mesh."""
    n, rank = _world()
    if channel is None:
        channel = n // time
    if channel * time > n:
        raise ValueError(f"mesh {channel}x{time} needs more than {n} devices")
    if channel < 1 or time < 1:
        raise ValueError(f"mesh {channel}x{time} has no device")
    dev = rank_device(device)
    groups = {"channel": None, "time": None}
    # new_group is collective over the whole job: every rank creates every
    # group, in the same order, and keeps its own.
    if time > 1:
        for c in range(channel):
            members = [c * time + t for t in range(time)]
            g = dist.new_group(members)
            if rank in members:
                groups["time"] = g
    if channel > 1:
        for t in range(time):
            members = [c * time + t for c in range(channel)]
            g = dist.new_group(members)
            if rank in members:
                groups["channel"] = g
    size = channel * time
    whole = None
    if size > 1:
        whole = dist.group.WORLD if size == n \
            else dist.new_group(list(range(size)))
    if whole is not None and dev.type != "cuda" \
            and dist.get_backend(whole) == "nccl":
        raise ValueError("an NCCL process group exchanges CUDA tensors: "
                         f"a mesh on {dev} needs gloo")
    inside = rank < size
    return Mesh(shape={"channel": channel, "time": time},
                coords=divmod(rank, time) if inside else None,
                device=dev, groups=groups if inside else
                {"channel": None, "time": None},
                group=whole if inside else None,
                ranks=tuple(range(size)))


def single_device_mesh(device: Any = None) -> Mesh:
    """A 1x1 mesh of this rank alone: no process group, no exchange."""
    _, rank = _world()
    return Mesh(shape={"channel": 1, "time": 1}, coords=(0, 0),
                device=rank_device(device),
                groups={"channel": None, "time": None}, group=None,
                ranks=(rank,))
