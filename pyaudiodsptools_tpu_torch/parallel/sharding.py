"""Sharded chain rendering over a ('channel', 'time') mesh.

Counterpart of ``pyaudiodsptools_tpu/parallel/sharding.py``, with the same
routing, in the same order, for each executed effect of the chain:

* on a mesh with ``time > 1``, an undecayed biquad EQ (the float64
  recurrence) runs the blocked scan over the time ranks
  (``parallel/timescan.py``), and a dynamics stage (a compressor, a gate or a
  fused cascade) the cross-rank speculative fixpoint
  (``parallel/dynspec.py``), both without gathering time;
* a time-parallel effect (``Effect.time_parallel``: FIRs, the FIR-ised EQ,
  delay, reverb, tremolo, waveshapers, the fused tail) runs its own
  ``offline`` on this rank's shard with a LEFT HALO of whole blocks from the
  ranks before it, enough to cover ``Effect.reach`` (a FIR's kernel with its
  latency, the fused tail's summed delays); the first time rank has none. A
  reach longer than a shard takes blocks from several ranks. An effect whose
  output depends on where a block lies (``Effect.block_indexed``: the
  tremolo's LFO schedule, the fused tail's gain stage) is told the global
  index of its first block, so a shard does not restart its LFO;
* every other effect gathers the time axis on its channel shard and runs its
  ``offline`` there (JAX ``_gathered_apply``): with ``time == 1`` that is the
  shard itself, and chain8's dynamics stage runs its own speculative walks.

JAX returns a global array; here every rank passes the same global input to
:meth:`ShardedRenderer.render` and gets the global output back (an all-gather
over both axes). :meth:`ShardedRenderer.render_shard` is the step in between,
on this rank's shard alone, for callers that keep their output sharded
(``dist.render_local_channels``, ``dist.sharded_meters``).

The halo is exchanged as every time rank's last ``min(halo, shard)`` blocks,
all-gathered over the time axis, from which each rank takes what lies before
it. With a halo the overlap-save windows fall elsewhere than in one render, so
the result equals the single-device render to the conv's rounding, not bit
for bit; a 1x1 mesh makes the very calls of ``Chain.render_blocks``.

A rank's render is a **rank program** (:func:`shard_steps`,
:func:`gather_steps`): a generator that computes on its tensors and yields
each exchange as a ``mesh.Exchange`` between buffers it made. Run eagerly
(``mesh.play``) it is :meth:`ShardedRenderer.render_shard` and
:meth:`~ShardedRenderer.gather`, the reference. On the card
:meth:`ShardedRenderer.render` and :meth:`~ShardedRenderer.render_blocks`
replay it from CUDA graphs (``parallel/captured.py``), the counterpart of the
JAX package's ``jax.jit(_render_with_constraints)``: one graph where the
mesh's exchanges go through NCCL, one graph a piece between exchanges where
they go through gloo (:func:`plan_cuts` lists the cuts). A renderer whose
chain is on the CPU renders eagerly.
"""

from __future__ import annotations

import itertools

import torch

from .. import profiling
from ..core import block as blk
from ..core.config import EngineConfig
from ..engine.chain import Chain, scan_offline
from ..ops.eq3band import EQ3BandParams
from .dynspec import is_dynamics_params, time_sharded_steps
from .mesh import Exchange, Mesh, play
from .timescan import eq3band_steps


def is_recurrent_eq(params) -> bool:
    """An EQ whose response did not decay: the float64 recurrence, which
    the JAX package routes to its time-sharded scan (a decayed one is a FIR
    and time-parallel)."""
    return isinstance(params, EQ3BandParams) and not params.use_fir


def route(effect, params, time: int) -> str:
    """How a stage runs on a mesh whose time axis has ``time`` ranks:
    ``"timescan"``, ``"dynspec"``, ``"halo"`` or ``"gathered"``."""
    if time > 1 and is_recurrent_eq(params):
        return "timescan"
    if time > 1 and is_dynamics_params(params):
        return "dynspec"
    if effect.time_parallel and effect.offline is not None:
        return "halo"
    return "gathered"


def _halo_blocks(effect, block_size: int) -> int:
    """Blocks of halo that cover the effect's reach."""
    return -(-effect.reach // block_size)


def plan_cuts(chain: Chain, mesh_shape: dict, block_size: int,
              capturable: bool) -> list[str]:
    """The exchanges that cut a rank's captured render
    (:meth:`ShardedRenderer.steps`) into pieces (one CUDA graph a piece, the
    exchange run between two), in order: every exchange where the mesh is
    not capturable (gloo), none where it is (NCCL, one graph). A pure
    function of the chain, the mesh shape, the block size and
    ``capturable``. The names are the yielded ``Exchange.what`` s."""
    if capturable:
        return []
    c, t = mesh_shape["channel"], mesh_shape["time"]
    cuts = []
    for e, p in zip(chain.exec_effects, chain.params):
        how = route(e, p, t)
        if how == "timescan":
            for band in range(p.n_bands):
                cuts += [f"timescan band {band}: halo",
                         f"timescan band {band}: summaries"]
        elif how == "dynspec":
            cuts.append("dynspec rounds")
        elif t > 1 and (how == "gathered"
                        or _halo_blocks(e, block_size) > 0):
            cuts.append(f"{e.name}: {how}")
    if c * t > 1:
        cuts.append("gather")
    return cuts


def _halo_steps(effect, params, x: torch.Tensor, mesh: Mesh, first: int):
    """A time-parallel effect on this rank's (C, nbl, B) shard, which starts
    at global block ``first`` (a rank program)."""
    nbl, B = x.shape[-2], x.shape[-1]
    want = _halo_blocks(effect, B)
    h = 0
    if mesh.shape["time"] > 1 and want > 0:
        k = min(want, nbl)
        tails = x[..., nbl - k:, :].contiguous()
        parts = tails.new_empty((mesh.shape["time"],) + tuple(tails.shape))
        yield Exchange(f"{effect.name}: halo",
                       lambda: mesh.all_gather_into(tails, parts, "time"))
        h = min(want, first)
        if h:
            halo = torch.cat(list(parts[:mesh.index("time")].unbind(0)),
                             dim=-2)[..., -h:, :]
            x = torch.cat([halo, x], dim=-2)
    kw = {"first_block": first - h} if effect.block_indexed else {}
    y = effect.offline(params, x, **kw)
    return y[..., h:, :] if h else y


def _gathered_steps(effect, params, x: torch.Tensor, mesh: Mesh):
    """An effect that needs the whole timeline, on this rank's channels (a
    rank program)."""
    nbl = x.shape[-2]
    t = mesh.shape["time"]
    if t > 1:
        mine = x.contiguous()
        parts = mine.new_empty((t,) + tuple(mine.shape))
        yield Exchange(f"{effect.name}: gathered",
                       lambda: mesh.all_gather_into(mine, parts, "time"))
        x = torch.cat(list(parts.unbind(0)), dim=-2)
    if effect.offline is not None:
        y = effect.offline(params, x)
    else:
        y = scan_offline(effect.init_state, effect.step, params, x)
    if t > 1:
        ti = mesh.index("time")
        y = y[..., ti * nbl:(ti + 1) * nbl, :]
    return y


def shard_steps(chain: Chain, mesh: Mesh, local: torch.Tensor,
                capturable: bool, where: list | None = None):
    """The rank program of :meth:`ShardedRenderer.render_shard` on this
    rank's (C_local, nb_local, B) shard: each executed effect by its
    :func:`route`, dynspec's rounds on the device where ``capturable``.
    ``where[0]`` names the effect at work."""
    where = [None] if where is None else where
    t = mesh.shape["time"]
    first = mesh.index("time") * local.shape[-2]
    x = local
    for e, p in zip(chain.exec_effects, chain.params):
        where[0] = e.name
        how = route(e, p, t)
        if how == "timescan":
            x = yield from eq3band_steps(p, x, mesh)
        elif how == "dynspec":
            x = yield from time_sharded_steps(p, x, mesh, capturable)
        elif how == "halo":
            x = yield from _halo_steps(e, p, x, mesh, first)
        else:
            x = yield from _gathered_steps(e, p, x, mesh)
    where[0] = None
    return x


def gather_steps(local: torch.Tensor, mesh: Mesh):
    """The global (C, nb, B) output from every rank's (C_local, nb_local, B)
    shard (a rank program; a one-rank mesh returns the shard)."""
    if mesh.size == 1:
        return local
    mine = local.contiguous()
    parts = mine.new_empty((mesh.size,) + tuple(mine.shape))
    yield Exchange("gather", lambda: mesh.all_gather_into(mine, parts))
    c, t = mesh.shape["channel"], mesh.shape["time"]
    Cl, nbl, B = mine.shape
    return parts.view(c, t, Cl, nbl, B).permute(0, 2, 1, 3, 4) \
        .reshape(c * Cl, t * nbl, B)


class ShardedRenderer:
    """Sharded offline renderer for a fixed chain and mesh. Every rank of the
    mesh constructs it and calls :meth:`render` with the same global signal.

    >>> mesh = make_mesh(channel=4, time=2)
    >>> r = ShardedRenderer(chain, cfg, mesh)
    >>> out = r.render(signal)      # signal: (channels, n), on every rank

    The chain must be built for the mesh's device type (the card unless both
    were built for the CPU). On the card :meth:`render` and
    :meth:`render_blocks` replay the captured rank program
    (:attr:`captured`, kept with the renderer, one blocks shape at a time);
    :meth:`render_shard` and :meth:`gather` stay eager, the reference. With
    tracing on (``profiling``) a render on the card is the span
    ``sharded.render``: ``sharded.copy_in``, ``sharded.replay``,
    ``sharded.copy_out``.
    """

    def __init__(self, chain: Chain, cfg: EngineConfig, mesh: Mesh):
        if chain.device.type != mesh.device.type:
            raise ValueError(
                f"the chain runs on {chain.device} but the mesh's device is "
                f"{mesh.device}")
        if mesh.coords is None:
            raise ValueError("this rank is not part of the mesh")
        self.chain = chain
        self.cfg = cfg
        self.mesh = mesh
        self._captured = None
        self._renders = itertools.count()  # the spans' sequence numbers

    @property
    def captured(self):
        """This renderer's :class:`~.captured.CapturedShardedRender` (made at
        first use; a renderer on the CPU has none: it raises)."""
        if self._captured is None:
            from .captured import CapturedShardedRender
            self._captured = CapturedShardedRender(self.chain, self.mesh)
        return self._captured

    def shard_shape(self, shape) -> tuple[int, int, int]:
        """This rank's (C/channel, nb/time, B) of global (C, nb, B) blocks;
        raises where they do not split over the mesh."""
        if len(shape) != 3:
            raise ValueError(
                f"sharded render takes (channels, num_blocks, block_size) "
                f"blocks, got {tuple(shape)}")
        C, nb, B = shape
        c, t = self.mesh.shape["channel"], self.mesh.shape["time"]
        if C % c or nb % t:
            raise ValueError(
                f"{C} channels x {nb} blocks do not split over a {c}x{t} "
                "mesh: channels % channel == 0 and num_blocks % time == 0")
        return C // c, nb // t, B

    def shard(self, blocks) -> torch.Tensor:
        """This rank's (C/channel, nb/time, B) shard of global (C, nb, B)
        blocks, on the mesh's device."""
        blocks = torch.as_tensor(blocks)
        Cl, nbl, _ = self.shard_shape(blocks.shape)
        ci, ti = self.mesh.coords
        return blocks[ci * Cl:(ci + 1) * Cl, ti * nbl:(ti + 1) * nbl] \
            .to(device=self.mesh.device, dtype=self.cfg.dtype).contiguous()

    def steps(self, local: torch.Tensor, capturable: bool,
              where: list | None = None):
        """The rank program of :meth:`render_blocks` from this rank's shard:
        :func:`shard_steps` then :func:`gather_steps`."""
        y = yield from shard_steps(self.chain, self.mesh, local, capturable,
                                   where)
        return (yield from gather_steps(y, self.mesh))

    def render_shard(self, local: torch.Tensor) -> torch.Tensor:
        """Render this rank's (C_local, nb_local, B) shard eagerly;
        collective over the mesh's time axis, and the output stays
        sharded."""
        return play(shard_steps(self.chain, self.mesh, local,
                                capturable=False))

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The global (C, nb, B) output from every rank's shard (eager)."""
        return play(gather_steps(local, self.mesh))

    def render_blocks(self, blocks) -> torch.Tensor:
        """Global (channels, num_blocks, block_size) blocks, the same on
        every rank -> the global output on every rank; channels % mesh
        channel axis == 0 and num_blocks % mesh time axis == 0."""
        if self.chain.device.type != "cuda":
            return self.gather(self.render_shard(self.shard(blocks)))
        blocks = torch.as_tensor(blocks)
        with profiling.span("sharded.render", next(self._renders)):
            inp = self.captured.prepare(
                "global", self.shard_shape(blocks.shape), self.steps)
            with profiling.span("sharded.copy_in"):
                inp.copy_(self.shard(blocks))
            with profiling.span("sharded.replay"):
                out = self.captured.replay()
            with profiling.span("sharded.copy_out"):
                return out.clone()

    def render(self, signal) -> torch.Tensor:
        """(channels, n) audio, the same on every rank -> the output padded
        to whole ``time x block_size`` (the JAX package's length). On the
        card the rank's part of the signal is written straight into the
        captured program's input buffer."""
        signal = torch.as_tensor(signal, dtype=self.cfg.dtype)
        if signal.dim() != 2:
            raise ValueError("sharded render expects (channels, n) audio")
        n = signal.shape[-1]
        B = self.cfg.block_size
        pad = (-n) % (self.mesh.shape["time"] * B)
        if self.chain.device.type != "cuda":
            if pad:
                signal = torch.nn.functional.pad(signal, (0, pad))
            blocks = blk.make_blocks(signal, B)
            return blk.combine_blocks(self.render_blocks(blocks))
        Cl, nbl, _ = self.shard_shape((signal.shape[0], (n + pad) // B, B))
        with profiling.span("sharded.render", next(self._renders)):
            inp = self.captured.prepare("global", (Cl, nbl, B), self.steps)
            ci, ti = self.mesh.coords
            flat = inp.view(Cl, nbl * B)
            part = signal[ci * Cl:(ci + 1) * Cl,
                          ti * nbl * B:(ti + 1) * nbl * B]
            with profiling.span("sharded.copy_in"):
                flat[:, :part.shape[-1]].copy_(part)
                flat[:, part.shape[-1]:].zero_()
            with profiling.span("sharded.replay"):
                out = self.captured.replay()
            with profiling.span("sharded.copy_out"):
                return blk.combine_blocks(out.clone())
