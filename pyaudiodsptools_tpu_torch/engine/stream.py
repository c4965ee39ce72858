"""Streaming: realtime-style block-by-block processing.

Counterpart of ``pyaudiodsptools_tpu/engine/stream.py``. The reference's
realtime path is an audio callback that mutates device state, with a
deadline of one block's duration (512 samples at 44.1 kHz: 11.6 ms). Here a
host-side processor feeds fixed-size blocks to a pre-compiled chain step and
carries the state. On the card the step is the chain's captured step
(``engine/graph.py``): ``warmup()`` captures it in a CUDA graph and every
block replays that graph, as the JAX processor calls its jitted step; the
state then lives in the graph's own buffers. With tensors in and out nothing
waits for the card; with numpy in and out every block costs one copy each
way and a synchronisation, which is what a callback pays anyway. On a CPU
chain (the caller asked for the CPU) every block runs the eager
``Chain.step``.

The state is a tree of tuples and dicts whose leaves are tensors on the
chain's device (filter histories, envelope counters, delay buffers, the
tremolo's 0-d int32 LFO position). :func:`state_leaves` lists the leaves in
the order the JAX package's ``jax.tree.flatten`` does (tuples in order, dicts
by sorted key), and a checkpoint is an ``.npz`` of those leaves, so feeding
it back is all resume takes.
"""

from __future__ import annotations

import itertools
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from .. import profiling
from ..core.config import EngineConfig
from .chain import Chain


def state_paths(state, path: tuple = ()) -> list:
    """(path, leaf) pairs of a state tree, tuples in order and dicts by
    sorted key; a path is the keys and indices that lead to the leaf."""
    if isinstance(state, dict):
        return [pair for k in sorted(state)
                for pair in state_paths(state[k], path + (k,))]
    if isinstance(state, (tuple, list)):
        return [pair for i, part in enumerate(state)
                for pair in state_paths(part, path + (i,))]
    return [(path, state)]


def state_leaves(state) -> list:
    """The leaves of a state tree in :func:`state_paths` order."""
    return [leaf for _, leaf in state_paths(state)]


def state_from_leaves(template, leaves: Iterable) -> Any:
    """A state shaped like ``template`` from ``leaves`` (numpy arrays or
    anything ``np.asarray`` takes) in :func:`state_leaves` order. Each leaf
    takes the template leaf's device and dtype and must have its shape (a
    checkpoint written before the tremolo's position became int32 tensors
    holds it as int64 scalars, which load the same)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (tuple, list)):
            return tuple(build(part) for part in node)
        try:
            leaf = np.asarray(next(it))
        except StopIteration:
            raise ValueError("too few leaves for this chain's state") from None
        if leaf.shape != tuple(node.shape):
            raise ValueError(
                f"state leaf of shape {leaf.shape} where this chain "
                f"keeps {tuple(node.shape)}")
        # a copy: the state must not share memory with the caller's
        return torch.from_numpy(np.array(leaf)).to(
            device=node.device, dtype=node.dtype)

    state = build(template)
    if next(it, None) is not None:
        raise ValueError("too many leaves for this chain's state")
    return state


def save_state_npz(file, state) -> None:
    """Write the state's leaves, in order, as one ``.npz`` (``file`` is a
    path or an open binary file)."""
    np.savez(file, *[leaf.detach().cpu().numpy()
                     for leaf in state_leaves(state)])


def load_state_npz(file, template):
    with np.load(file) as archive:
        return state_from_leaves(template,
                                 [archive[k] for k in archive.files])


class StreamProcessor:
    """Carries chain state across fixed-size blocks.

    >>> sp = StreamProcessor(chain, cfg)
    >>> sp.warmup()                  # build, load, capture: before the deadline
    >>> out = sp.process(block)      # inside the audio callback

    On a CUDA chain every block replays the chain's captured step
    (:meth:`Chain.captured_step`); ``state``, ``reset``, ``save_state`` and
    ``load_state`` act on its buffers. A capture that fails raises: nothing
    falls back to launching the step's kernels one by one.
    """

    def __init__(self, chain: Chain, cfg: EngineConfig,
                 batch_shape: tuple[int, ...] = ()):
        self.chain = chain
        self.cfg = cfg
        self.batch_shape = tuple(batch_shape)
        self._captured = chain.captured_step(self.batch_shape) \
            if chain.device.type == "cuda" else None
        self._state = None if self._captured is not None \
            else chain.init_state(self.batch_shape)
        self._steps = itertools.count()  # the step spans' sequence numbers

    @property
    def state(self):
        """The carried state. On the card a copy of the captured step's
        buffers (it does not follow later blocks); setting it copies the
        given state in."""
        if self._captured is not None:
            return self._captured.state
        return self._state

    @state.setter
    def state(self, value) -> None:
        if self._captured is not None:
            self._captured.load_state(value)
        else:
            self._state = value

    def warmup(self) -> None:
        """Make the first real block meet no set-up, and leave the state as
        it was. On the card: compile the CUDA kernels with ``nvcc`` if this
        checkout has not built them yet (seconds), load them, capture the
        step for this processor's block shape and wait for the device. On
        the CPU: one step on silence, discarded."""
        shape = self.batch_shape + (self.cfg.block_size,)
        if self._captured is not None:
            self._captured.capture(shape)
            torch.cuda.synchronize(self.chain.device)
            return
        silent = torch.zeros(shape, dtype=self.cfg.dtype,
                             device=self.chain.device)
        self.chain.step(self._state, silent)

    def process(self, block):
        """Process one ``(..., block_size)`` block, advancing the state. A
        tensor (on the chain's device) gives a new tensor there and waits
        for nothing; a numpy array gives a numpy array. A shorter final
        block is padded with silence, stepped whole, and cut back to its
        length. With tracing on (``profiling``) the call is the span
        ``step``: ``step.to_tensor``, on the card ``step.copy_in`` and
        ``step.replay``, then ``step.copy_out`` (the wait for the card in
        it where the answer is numpy)."""
        with profiling.span("step", next(self._steps)):
            with profiling.span("step.to_tensor"):
                block, n, as_numpy = self._to_tensor(block)
            if self._captured is not None:
                # the graph's output buffer: the next block overwrites it
                out = self._captured.replay(block)[..., :n]
                with profiling.span("step.copy_out"):
                    return out.cpu().numpy() if as_numpy else out.clone()
            self._state, out = self.chain.step(self._state, block)
            out = out[..., :n]
            with profiling.span("step.copy_out"):
                return out.cpu().numpy() if as_numpy else out

    def _to_tensor(self, block):
        """(the block as a tensor padded to the block size, its length,
        whether it came as numpy)."""
        as_numpy = not isinstance(block, torch.Tensor)
        if as_numpy:
            block = torch.from_numpy(
                np.ascontiguousarray(block, dtype=np.float32))
            if self._captured is None:
                block = block.to(self.chain.device)
        elif block.device.type != self.chain.device.type:
            raise ValueError(
                f"the block is on {block.device} but the chain runs on "
                f"{self.chain.device}")
        n = block.shape[-1]
        if n != self.cfg.block_size:
            if n > self.cfg.block_size:
                raise ValueError(
                    f"a block of {n} samples is longer than the block size "
                    f"{self.cfg.block_size}")
            block = torch.nn.functional.pad(block,
                                            (0, self.cfg.block_size - n))
        return block, n, as_numpy

    def process_stream(self, blocks: Iterable) -> Iterator:
        for b in blocks:
            yield self.process(b)

    def reset(self) -> None:
        if self._captured is not None:
            self._captured.reset()
        else:
            self._state = self.chain.init_state(self.batch_shape)

    # -- checkpoint / resume -------------------------------------------------

    def save_state(self, path: str) -> None:
        save_state_npz(path, self.state)

    def load_state(self, path: str) -> None:
        self.state = load_state_npz(path, self.chain.init_state(
            self.batch_shape))
