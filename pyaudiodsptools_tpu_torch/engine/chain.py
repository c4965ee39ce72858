"""Effect chains: composition, fusion, state, and execution.

Counterpart of ``pyaudiodsptools_tpu/engine/chain.py``. A chain is function
composition over ``(params, state, block)`` ops; an offline render chains
each op's whole-signal ``offline`` path, falling back to a loop of its
streaming step over the blocks.

Differences from the JAX package, all of them consequences of PyTorch
running eagerly:

* what the JAX package jit-compiles, the port captures in CUDA graphs on
  the card (``engine/graph.py``) and runs eagerly elsewhere:

  - the streaming step: :meth:`Chain.captured_step` captures ``chain_step``
    in a graph per block shape and replays it, as the JAX chain calls its
    jitted step; ``StreamProcessor``, the realtime pump, the ``compat``
    devices and ``render_segmented`` / ``render_resumable`` stream through
    it;
  - the offline render: :meth:`Chain.captured_render` captures
    ``chain_render`` in a graph per blocks shape, kept with the chain, as
    the JAX chain keeps its jitted render; ``engine/render.render`` (and
    with it ``render_file`` and the CLI) replays it and keeps the graph of
    the last shape it rendered only. The dynamics
    fixpoint, a loop whose trip count depends on the signal, runs inside
    the graph as a conditional while node (CUDA 12.4 or later, driver and
    runtime), so a replay reads nothing back. A
    graph holds its input and output buffers and, in its private pool,
    the intermediates: chain8 at 64 channels x 30 s holds 1,298 MiB, four
    times the signal (an H100 with PyTorch 2.11; ``chip_smoke.py``'s
    ``compiled_render`` phase measures it), until
    :meth:`~.graph.CapturedRender.release` frees it;

  :meth:`Chain.step` and :meth:`Chain.render_blocks` stay eager: they are
  the graphs' references, and ``profiling.annotate_chain`` scopes them.
  The sharded render (``parallel/``) captures a rank's program the same
  way (``parallel/captured.py``);
* there is no structure/params split: the params are the effects' own;
* the device is an argument of the Chain (default ``"cuda"``) and not a
  process-wide backend read at build time;
* fusion does not depend on the device: LTI runs, dynamics runs and tail runs
  always fuse, and on a CPU tensor the fused effects run their plain
  versions.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from ..core.config import DEFAULT_DEVICE, resolve_device
from ..ops.base import Effect


class Chain:
    """An ordered effect chain with explicit state.

    >>> chain = Chain([ops.lowcut(cfg, 800), ops.softclipper(cfg)])
    >>> out_blocks = chain.render_blocks(blocks)       # offline
    >>> state = chain.init_state()
    >>> state, out = chain.step(state, block)          # streaming

    Every effect must have been built for the chain's ``device``; with
    ``device="cuda"`` and no card the constructor raises.
    """

    def __init__(self, effects: Sequence[Effect], fuse: bool = True,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.effects = tuple(effects)
        for e in self.effects:
            if e.device.type != self.device.type:
                raise ValueError(
                    f"effect {e.name!r} was built for device {e.device} but "
                    f"the chain runs on {self.device}; pass the same device "
                    "to the op factories and to Chain")
        # Consecutive LTI effects collapse into ONE segmented convolution
        # (their cascade's impulse response is the convolution of their
        # effective kernels); compressor / gate runs collapse into one
        # cascaded walk; what is left of delay / tremolo / waveshaper runs
        # collapses into one fused tail pass.
        self._exec_effects = fuse_lti_runs(self.effects) if fuse \
            else self.effects
        self.params = tuple(e.params for e in self._exec_effects)
        self._captured_render = None
        self._fold_steps = {}

    def __iter__(self):
        return iter(self.effects)

    def __len__(self) -> int:
        return len(self.effects)

    @property
    def exec_effects(self) -> tuple[Effect, ...]:
        """The effects actually executed (runs fused), in order."""
        return self._exec_effects

    def init_state(self, batch_shape: tuple[int, ...] = ()) -> tuple[Any, ...]:
        return tuple(e.state(batch_shape) for e in self._exec_effects)

    def step(self, state, block: torch.Tensor):
        """Process one ``(..., block_size)`` block (on the chain's device)
        through the whole chain: (state, block) -> (state, block), eagerly.
        On the card a step is a few dozen launches and reads nothing back."""
        return chain_step(self._exec_effects, self.params, state, block)

    def captured_step(self, batch_shape: tuple[int, ...] = ()):
        """The streaming step as CUDA graphs, the state of ``batch_shape``
        in the step's own buffers (:class:`~.graph.CapturedStep`): bit-equal
        to folding :meth:`step`. Only for a chain on the card."""
        from .graph import CapturedStep

        return CapturedStep(self._exec_effects, self.device, batch_shape)

    def captured_render(self):
        """The offline render as CUDA graphs
        (:class:`~.graph.CapturedRender`), one per blocks shape, bit-equal
        to :meth:`render_blocks`; made once and kept with the chain, as
        the JAX chain keeps its jitted render. Only for a chain on the
        card."""
        if self.device.type != "cuda":
            raise ValueError(
                f"a captured render runs on the card; this chain runs on "
                f"{self.device}: call render_blocks")
        if self._captured_render is None:
            from .graph import CapturedRender

            self._captured_render = CapturedRender(self._exec_effects,
                                                   self.device)
        return self._captured_render

    def fold_step(self, batch_shape: tuple[int, ...] = ()):
        """A captured step of ``batch_shape`` kept with the chain, for
        folds that load a state, step a run of blocks and read the state
        back (``engine/resumable.render_segment``). Only for a chain on the
        card."""
        step = self._fold_steps.get(tuple(batch_shape))
        if step is None:
            step = self._fold_steps[tuple(batch_shape)] = \
                self.captured_step(batch_shape)
        return step

    def render_blocks(self, blocks: torch.Tensor,
                      use_kernels: bool = True) -> torch.Tensor:
        """Offline: process all ``(..., num_blocks, block_size)`` blocks,
        eagerly (the reference of :meth:`captured_render`, which
        ``engine/render.render`` replays on the card). The input is never
        overwritten: both kernels read halos that other thread blocks still
        need, so every stage writes a fresh output.

        ``use_kernels=False`` runs every effect's plain PyTorch version on
        whatever device ``blocks`` is on (the reference for the kernels)."""
        if blocks.device.type != self.device.type:
            raise ValueError(
                f"blocks are on {blocks.device} but the chain was built for "
                f"{self.device}")
        return chain_render(self._exec_effects, self.params, blocks,
                            use_kernels=use_kernels)


def fuse_lti_runs(effects: tuple[Effect, ...]) -> tuple[Effect, ...]:
    """Fuse runs of >= 2 consecutive fusable effects:

    * LTI effects (carry an ``lti_kernel``) -> one FIR whose impulse
      response is the cascade's (ops/fft_filter.fuse_lti), whatever its
      length and the block size, as the JAX package fuses them: a FIR of any
      length renders and streams (in partitions where one window does not
      take it);
    * dynamics automatons (compressor / gate, in any order) -> one cascaded
      speculative walk (kernels/dynamics.fused_dynamics). A run longer than
      one kernel walks (kernels/dynamics.MAX_OPS) is cut into consecutive
      cascades, which gives the same result. A lone compressor or gate stays
      as it is: its own ``offline`` already takes the same kernels;
    * tail runs (delay without pre-filters / tremolo / stateless
      waveshapers) left over after the passes above -> one kernel pass
      (kernels/tail.fused_tail), whatever the run's length and reach, as
      the JAX package fuses them. A lone waveshaper stays as it is: its own
      ``offline`` takes the same kernel with a one-stage plan.
    """
    from ..ops.fft_filter import fuse_lti

    out: list[Effect] = []
    run: list[Effect] = []

    def flush():
        if len(run) >= 2:
            out.append(fuse_lti(run))
        else:
            out.extend(run)
        run.clear()

    for e in effects:
        if e.lti_kernel is None:
            flush()
            out.append(e)
            continue
        run.append(e)
    flush()
    return fuse_tail_runs(fuse_dynamics_runs(tuple(out)))


def fuse_dynamics_runs(effects: tuple[Effect, ...]) -> tuple[Effect, ...]:
    """Collapse runs of >= 2 consecutive compressor / gate effects into
    dynamics cascades of at most ``MAX_OPS`` members each."""
    from ..kernels.dynamics import MAX_OPS, fused_dynamics
    from ..ops.dynamics import DynamicsParams

    out: list[Effect] = []
    run: list[Effect] = []

    def flush():
        for i in range(0, len(run), MAX_OPS):
            part = run[i:i + MAX_OPS]
            out.extend([fused_dynamics(part)] if len(part) >= 2 else part)
        run.clear()

    for e in effects:
        if isinstance(e.params, DynamicsParams):
            run.append(e)
        else:
            flush()
            out.append(e)
    flush()
    return tuple(out)


def fuse_tail_runs(effects: tuple[Effect, ...]) -> tuple[Effect, ...]:
    """Second fusion pass: collapse runs of >= 2 consecutive tail-fusable
    effects into one fused tail. Runs AFTER LTI fusion so a delay adjacent
    to other LTI ops prefers the FIR cascade."""
    from ..kernels.tail import fused_tail, tail_fusable

    out: list[Effect] = []
    run: list[Effect] = []

    def flush():
        if len(run) >= 2:
            out.append(fused_tail(run))
        else:
            out.extend(run)
        run.clear()

    for e in effects:
        if tail_fusable(e):
            run.append(e)
        else:
            flush()
            out.append(e)
    flush()
    return tuple(out)


def chain_step(effects, params, state, block):
    """Streaming step over the executed effects."""
    new_states = []
    for e, p, st in zip(effects, params, state):
        st, block = e.step(p, st, block)
        new_states.append(st)
    return tuple(new_states), block


def scan_offline(init_fn, step_fn, params, blocks: torch.Tensor) -> torch.Tensor:
    """Fallback offline path: a loop of a streaming step over the blocks."""
    state = init_fn(params, blocks.shape[:-2])
    outs = []
    for i in range(blocks.shape[-2]):
        state, y = step_fn(params, state, blocks[..., i, :])
        outs.append(y)
    return torch.stack(outs, dim=-2)


def chain_render(effects, params, blocks, use_kernels: bool = True):
    """Offline render over the executed effects."""
    for e, p in zip(effects, params):
        if e.offline is not None:
            blocks = e.offline(p, blocks, use_kernels=use_kernels)
        else:
            blocks = scan_offline(e.init_state, e.step, p, blocks)
    return blocks
