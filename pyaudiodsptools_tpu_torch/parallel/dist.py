"""Multi-process runtime: process groups, the global mesh, per-rank channel
I/O and sharded meters.

Counterpart of ``pyaudiodsptools_tpu/parallel/dist.py``. JAX joins one
controller per host to a coordination service and spans a mesh over every
host's chips; PyTorch runs one process a device, so here a rank is a device:
:func:`init_distributed` joins ``torch.distributed``, :func:`global_mesh`
spans all ranks, and a rank feeds and drains only its own channels
(:func:`host_channel_slice`, :func:`render_local_channels`).

Starting the ranks: with ``torchrun --nproc-per-node=N script.py`` on a host
with N cards, ``init_distributed()`` reads torchrun's variables and picks
NCCL; with an address, ``init_distributed("localhost:29500", num_processes=N,
process_id=i)``. Where the ranks outnumber the cards (several ranks on one
card, or the CPU) the backend is gloo, whose exchanges stage through host
memory (``parallel/mesh.py``).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..core import block as blk
from ..core.config import EngineConfig
from ..engine.chain import Chain
from .mesh import Exchange, Mesh, _world, make_mesh, play
from .sharding import ShardedRenderer, shard_steps


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> None:
    """Join the job's process group. With an address (``host:port`` or a
    ``tcp://`` URL) the other two arguments give the world size and this
    rank; without one, torchrun's environment (``env://``) gives all three.
    ``num_processes <= 1`` returns without a group. The backend defaults to
    NCCL where every rank of this host has its own card, gloo otherwise;
    under NCCL the rank's card becomes the current device."""
    if num_processes is not None and num_processes <= 1:
        return
    kwargs = {}
    if coordinator_address is None:
        kwargs["init_method"] = "env://"
    else:
        kwargs["init_method"] = coordinator_address \
            if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    world = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    rank = process_id if process_id is not None \
        else int(os.environ.get("RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(os.environ.get("LOCAL_RANK", rank % local_world))
    if backend is None:
        own_cards = torch.cuda.is_available() \
            and torch.cuda.device_count() >= local_world
        backend = "nccl" if own_cards else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend=backend, **kwargs)


def global_mesh(time: int = 1, device=None) -> Mesh:
    """('channel', 'time') mesh over ALL ranks of the job (collective)."""
    n, _ = _world()
    if n % time:
        raise ValueError(f"{n} devices not divisible by time={time}")
    return make_mesh(channel=n // time, time=time, device=device)


def host_channel_slice(total_channels: int) -> slice:
    """The channel range this rank is responsible for feeding/draining."""
    n, rank = _world()
    if total_channels % n:
        raise ValueError(f"{total_channels} channels not divisible by "
                         f"{n} ranks")
    per = total_channels // n
    return slice(rank * per, (rank + 1) * per)


def distributed_renderer(chain: Chain, cfg: EngineConfig,
                         time: int = 1) -> ShardedRenderer:
    """A ShardedRenderer over the global mesh, on the chain's device."""
    return ShardedRenderer(chain, cfg, global_mesh(time=time,
                                                   device=chain.device))


def local_steps(renderer: ShardedRenderer, blocks: torch.Tensor,
                capturable: bool, where: list | None = None):
    """The rank program of :func:`render_local_channels` on this rank's
    (local_channels, nb, B) blocks: the row's channels all-gathered over the
    time axis, this rank's time shard of them rendered
    (``sharding.shard_steps``), the row's outputs all-gathered, and this
    rank's channels of them returned."""
    mesh = renderer.mesh
    t, ti = mesh.shape["time"], mesh.index("time")
    lc, nb = blocks.shape[0], blocks.shape[1]
    row = blocks
    if t > 1:
        rows = blocks.new_empty((t,) + tuple(blocks.shape))
        yield Exchange("row: channels",
                       lambda: mesh.all_gather_into(blocks, rows, "time"))
        row = rows.reshape((t * lc,) + tuple(blocks.shape[1:]))
    nbl = nb // t
    out = yield from shard_steps(renderer.chain, mesh,
                                 row[:, ti * nbl:(ti + 1) * nbl].contiguous(),
                                 capturable, where)
    full = out
    if t > 1:
        mine = out.contiguous()
        parts = mine.new_empty((t,) + tuple(mine.shape))
        yield Exchange("row: outputs",
                       lambda: mesh.all_gather_into(mine, parts, "time"))
        full = torch.cat(list(parts.unbind(0)), dim=-2)
    return full[ti * lc:(ti + 1) * lc]


def render_local_channels(renderer: ShardedRenderer,
                          local_signal) -> torch.Tensor:
    """Render where each rank feeds ONLY its own channels.

    ``local_signal``: (local_channels, n) float32, ``host_channel_slice``'s
    share of the global channels (every rank passes the same n). The ranks
    of one mesh row (one channel shard, ``time`` ranks) exchange their
    channels and their outputs within the row only; no rank holds another
    row's audio. Returns this rank's channels of the output, (local_channels,
    n), on the mesh's device. Needs a mesh over every rank of the job
    (:func:`global_mesh`). On the card it replays the renderer's captured
    program (:func:`local_steps`; the row's two all-gathers inside the graph
    where the mesh is capturable), the signal written straight into its
    input buffer."""
    mesh, cfg = renderer.mesh, renderer.cfg
    n_ranks, _ = _world()
    if mesh.size != n_ranks:
        raise ValueError(f"a {mesh.size}-rank mesh in a {n_ranks}-rank job: "
                         "render_local_channels needs global_mesh()")
    local = torch.as_tensor(local_signal, dtype=cfg.dtype)
    if local.dim() != 2:
        raise ValueError("render_local_channels expects (channels, n) audio")
    lc, n = local.shape
    B = cfg.block_size
    nb = -(-n // (mesh.shape["time"] * B)) * mesh.shape["time"]
    if renderer.chain.device.type == "cuda":
        inp = renderer.captured.prepare(
            "local", (lc, nb, B),
            lambda b, capturable, where: local_steps(renderer, b, capturable,
                                                     where))
        flat = inp.view(lc, nb * B)
        flat[:, :n].copy_(local)
        flat[:, n:].zero_()
        own = renderer.captured.replay()
    else:
        flat = torch.nn.functional.pad(local.to(mesh.device),
                                       (0, nb * B - n))
        own = play(local_steps(renderer, blk.make_blocks(flat, B),
                               capturable=False))
    return blk.combine_blocks(own)[..., :n].clone()


def sharded_meters(local_out: torch.Tensor, mesh: Mesh) -> dict:
    """Global peak and RMS of a sharded render's output from this rank's
    shard (``ShardedRenderer.render_shard``): the peak is an all-reduce of
    the max, the RMS of the sum of squares (float64) and the count. It stays
    eager, uncaptured: one reduction and one read-back, which the JAX
    package jits as a single expression
    (``pyaudiodsptools_tpu/parallel/dist.py``)."""
    peak = mesh.all_reduce(local_out.abs().max().reshape(1).float(), "max")
    sums = torch.stack([local_out.double().square().sum(),
                        torch.tensor(float(local_out.numel()),
                                     dtype=torch.float64,
                                     device=local_out.device)])
    sums = mesh.all_reduce(sums, "sum")
    return {"peak": float(peak[0]), "rms": float(torch.sqrt(sums[0] / sums[1]))}
