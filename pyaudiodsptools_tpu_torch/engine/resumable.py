"""Resumable rendering: crash recovery for long renders.

Counterpart of ``pyaudiodsptools_tpu/engine/resumable.py``: deterministic
re-render from block k. The chain state is snapshotted every
``segment_blocks`` blocks, and on restart the render resumes from the last
complete segment. Every op's state is explicit, so a snapshot is just
arrays, and the step path computes the same bits on every run.

Crash-safety protocol: every file is written to a temp name and
``os.replace``d (atomic on POSIX), and ``meta.json``, written LAST, names
the exact state file that matches its segment counter. A crash between any
two writes leaves the previous consistent (meta, state) pair intact, so
resume never pairs a segment counter with a state from another segment.

Checkpoint layout (directory), the JAX package's:
    meta.json               {"segment": k, "shape": [...], "state": "..."}
    state_0000k.npz         chain-state leaves entering segment k
    out_00000.npy ...       rendered output segments
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .chain import Chain
from .stream import load_state_npz, save_state_npz


def _atomic_write(path: str, write_fn) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write_fn(f)
    os.replace(tmp, path)


def render_segment(chain: Chain, state, seg_blocks: torch.Tensor):
    """One segment: fold the chain step over its ``(..., k, B)`` blocks.
    Returns (state, output blocks). On the card the fold replays the chain's
    captured step (``Chain.fold_step``: load the state, replay block after
    block, read the state back), the counterpart of the JAX package's
    jitted ``_render_segment``; it is bit-equal to folding ``Chain.step``,
    which the CPU runs."""
    if seg_blocks.is_cuda:
        step = chain.fold_step(tuple(seg_blocks.shape[:-2]))
        step.load_state(state)
        out = torch.empty_like(seg_blocks, dtype=torch.float32)
        for i in range(seg_blocks.shape[-2]):
            out[..., i, :] = step.replay(seg_blocks[..., i, :])
        return step.state, out
    outs = []
    for i in range(seg_blocks.shape[-2]):
        state, y = chain.step(state, seg_blocks[..., i, :])
        outs.append(y)
    return state, torch.stack(outs, dim=-2)


def _read_meta(meta_path: str) -> dict:
    try:
        with open(meta_path) as f:
            return json.load(f)
    except (ValueError, OSError):
        return {}


def render_resumable(chain: Chain, blocks: torch.Tensor, ckpt_dir: str,
                     segment_blocks: int = 64,
                     stop_after: int | None = None) -> torch.Tensor:
    """Render ``(..., nb, B)`` blocks (on the chain's device) with periodic
    checkpoints; resumes automatically if ``ckpt_dir`` holds a partial run
    for the same shape.

    ``stop_after`` aborts after that many segments (fault-injection hook for
    testing crash/resume behaviour)."""
    if segment_blocks < 1:
        raise ValueError(f"segment_blocks must be >= 1, got {segment_blocks}")
    os.makedirs(ckpt_dir, exist_ok=True)
    meta_path = os.path.join(ckpt_dir, "meta.json")

    nb = blocks.shape[-2]
    n_seg = -(-nb // segment_blocks)

    start_seg = 0
    state = chain.init_state(tuple(blocks.shape[:-2]))
    meta = _read_meta(meta_path)
    state_file = meta.get("state")
    if (meta.get("shape") == list(blocks.shape)
            and meta.get("segment", 0) < n_seg and state_file
            and os.path.exists(os.path.join(ckpt_dir, state_file))):
        start_seg = meta["segment"]
        state = load_state_npz(os.path.join(ckpt_dir, state_file), state)

    outs = []
    for seg in range(n_seg):
        seg_path = os.path.join(ckpt_dir, f"out_{seg:05d}.npy")
        lo, hi = seg * segment_blocks, min((seg + 1) * segment_blocks, nb)
        if seg < start_seg:
            outs.append(torch.from_numpy(np.load(seg_path)).to(blocks.device))
            continue
        if stop_after is not None and seg >= start_seg + stop_after:
            raise RuntimeError(f"injected fault after segment {seg}")
        state, out = render_segment(chain, state, blocks[..., lo:hi, :])
        out_np = out.cpu().numpy()
        _atomic_write(seg_path, lambda f: np.save(f, out_np))
        state_file = f"state_{seg + 1:05d}.npz"
        _atomic_write(os.path.join(ckpt_dir, state_file),
                      lambda f: save_state_npz(f, state))
        # meta LAST: it only ever references files that already exist.
        _atomic_write(meta_path, lambda f: f.write(json.dumps(
            {"segment": seg + 1, "shape": list(blocks.shape),
             "state": state_file}).encode()))
        prev = os.path.join(ckpt_dir, f"state_{seg:05d}.npz")
        if os.path.exists(prev):
            os.remove(prev)
        outs.append(out)
    return torch.cat(outs, dim=-2)
