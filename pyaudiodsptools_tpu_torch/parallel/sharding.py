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
"""

from __future__ import annotations

import torch

from ..core import block as blk
from ..core.config import EngineConfig
from ..engine.chain import Chain, scan_offline
from ..ops.eq3band import EQ3BandParams
from .dynspec import dynamics_offline_time_sharded, is_dynamics_params
from .mesh import Mesh
from .timescan import eq3band_offline_sharded


def is_recurrent_eq(params) -> bool:
    """An EQ whose response did not decay: the float64 recurrence, which
    the JAX package routes to its time-sharded scan (a decayed one is a FIR
    and time-parallel)."""
    return isinstance(params, EQ3BandParams) and not params.use_fir


def _with_halo(effect, params, x: torch.Tensor, mesh: Mesh,
               first: int) -> torch.Tensor:
    """A time-parallel effect on this rank's (C, nbl, B) shard, which starts
    at global block ``first``."""
    nbl, B = x.shape[-2], x.shape[-1]
    want = -(-effect.reach // B)         # blocks of halo that cover the reach
    h = 0
    if mesh.shape["time"] > 1 and want > 0:
        k = min(want, nbl)
        tails = mesh.all_gather(x[..., nbl - k:, :].contiguous(), "time")
        h = min(want, first)
        if h:
            halo = torch.cat(tails[:mesh.index("time")], dim=-2)[..., -h:, :]
            x = torch.cat([halo, x], dim=-2)
    kw = {"first_block": first - h} if effect.block_indexed else {}
    y = effect.offline(params, x, **kw)
    return y[..., h:, :] if h else y


def _gathered(effect, params, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """An effect that needs the whole timeline, on this rank's channels."""
    nbl = x.shape[-2]
    time_sharded = mesh.shape["time"] > 1
    if time_sharded:
        x = torch.cat(mesh.all_gather(x.contiguous(), "time"), dim=-2)
    if effect.offline is not None:
        y = effect.offline(params, x)
    else:
        y = scan_offline(effect.init_state, effect.step, params, x)
    if time_sharded:
        t = mesh.index("time")
        y = y[..., t * nbl:(t + 1) * nbl, :]
    return y


class ShardedRenderer:
    """Sharded offline renderer for a fixed chain and mesh. Every rank of the
    mesh constructs it and calls :meth:`render` with the same global signal.

    >>> mesh = make_mesh(channel=4, time=2)
    >>> r = ShardedRenderer(chain, cfg, mesh)
    >>> out = r.render(signal)      # signal: (channels, n), on every rank

    The chain must be built for the mesh's device type (the card unless both
    were built for the CPU).
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

    def shard(self, blocks) -> torch.Tensor:
        """This rank's (C/channel, nb/time, B) shard of global (C, nb, B)
        blocks, on the mesh's device."""
        blocks = torch.as_tensor(blocks)
        if blocks.dim() != 3:
            raise ValueError(
                f"sharded render takes (channels, num_blocks, block_size) "
                f"blocks, got {tuple(blocks.shape)}")
        C, nb, _ = blocks.shape
        c, t = self.mesh.shape["channel"], self.mesh.shape["time"]
        if C % c or nb % t:
            raise ValueError(
                f"{C} channels x {nb} blocks do not split over a {c}x{t} "
                "mesh: channels % channel == 0 and num_blocks % time == 0")
        ci, ti = self.mesh.coords
        Cl, nbl = C // c, nb // t
        return blocks[ci * Cl:(ci + 1) * Cl, ti * nbl:(ti + 1) * nbl] \
            .to(device=self.mesh.device, dtype=self.cfg.dtype).contiguous()

    def render_shard(self, local: torch.Tensor) -> torch.Tensor:
        """Render this rank's (C_local, nb_local, B) shard; collective over
        the mesh's time axis, and the output stays sharded."""
        mesh = self.mesh
        first = mesh.index("time") * local.shape[-2]
        time_sharded = mesh.shape["time"] > 1
        x = local
        for e, p in zip(self.chain.exec_effects, self.chain.params):
            if time_sharded and is_recurrent_eq(p):
                x = eq3band_offline_sharded(p, x, mesh)
            elif time_sharded and is_dynamics_params(p):
                x = dynamics_offline_time_sharded(p, x, mesh)
            elif e.time_parallel and e.offline is not None:
                x = _with_halo(e, p, x, mesh, first)
            else:
                x = _gathered(e, p, x, mesh)
        return x

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The global (C, nb, B) output from every rank's shard."""
        parts = self.mesh.all_gather(local.contiguous())
        t = self.mesh.shape["time"]
        rows = [torch.cat(parts[c:c + t], dim=-2)
                for c in range(0, len(parts), t)]
        return torch.cat(rows, dim=0)

    def render_blocks(self, blocks) -> torch.Tensor:
        """Global (channels, num_blocks, block_size) blocks, the same on
        every rank -> the global output on every rank; channels % mesh
        channel axis == 0 and num_blocks % mesh time axis == 0."""
        return self.gather(self.render_shard(self.shard(blocks)))

    def render(self, signal) -> torch.Tensor:
        """(channels, n) audio, the same on every rank -> the output padded
        to whole ``time x block_size`` (the JAX package's length)."""
        signal = torch.as_tensor(signal, dtype=self.cfg.dtype)
        if signal.dim() != 2:
            raise ValueError("sharded render expects (channels, n) audio")
        n = signal.shape[-1]
        pad = (-n) % (self.mesh.shape["time"] * self.cfg.block_size)
        if pad:
            signal = torch.nn.functional.pad(signal, (0, pad))
        blocks = blk.make_blocks(signal, self.cfg.block_size)
        return blk.combine_blocks(self.render_blocks(blocks))
