"""Fused tail: delay / tremolo / waveshaper runs in one pass.

Replaces the TPU kernel ``pyaudiodsptools_tpu/kernels/tail_pallas.py ::
tail_kernel`` (body ``_kernel``), with its planner ``_plan_stages`` and its
effect factory ``fused_tail``. A chain tail like ``saturator -> delay ->
tremolo -> softclipper`` is pure data movement when run op by op: every
member is a trivial map, but each costs a full round trip of the signal
through device memory. The kernel runs the WHOLE run in one pass.

Stage kinds (built from the member Effects by :func:`fused_tail`):

* ``taps`` -- a Delay without pre-filters: ``y = dry + sum_k w_k * x[t-d_k]``
  with ``x[t<0] = 0``.
* ``gain`` -- a Tremolo: multiply by a per-sample gain row, computed in
  PyTorch by ``ops.tremolo.gain_row`` (freeze quirk included), as the JAX
  package computes it outside its kernel.
* ``map``  -- a stateless waveshaper (saturator / softclipper /
  harddistortion / bitcrusher).

Halo semantics: the input of every ``taps`` stage is SILENCE before the
signal start (a delay's history starts at zeros), whatever the stages before
it map 0 to (HardDistortion maps it to about 0.95).

What bounds it on an H100: bytes. The function reads the signal once and
writes it once; the arithmetic is a few operations per sample. In the kernel
(``csrc/tail.cu``) a thread block walks along time over a run of tiles of
one channel and keeps each taps stage's input in a ring (its reach of
history plus the tile), so a run reads its halo once and not once a tile;
the next tile comes in by asynchronous copy while the block works on the
current one, and stores are 16 bytes wide. The stage plan is DATA: an int32
table built once per plan (:func:`make_plan`) and kept on the device, which
a block reads into shared memory, so one build serves every chain, of any
number of stages and taps. Where the rings do not fit a thread block's
shared memory (delays that reach back further than about 26,600 samples at
two blocks an SM, 55,300 at one) the same kernel keeps them in device memory
that the wrapper allocates: no run the JAX package fuses is refused.

The CUDA source is ``csrc/tail.cu``. The plain version is the member ops'
plain ``offline``s in sequence; it runs for CPU tensors, or on request
(``use_kernels=False``), and is never a fallback for a CUDA tensor.

A lone waveshaper is no run, and keeps its own name and place in a chain;
its ``offline`` (:func:`map_offline`) on a CUDA tensor launches
:func:`tail_kernel` with a one-stage ``map`` plan, from the same planner and
plan cache as a run's.
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct

import numpy as np
import torch

from ..ops import waveshapers as ws
from ..ops.base import Effect
from ..ops.delay import DelayParams
from ..ops.tremolo import TremoloParams, gain_row
from . import _build

# Mirrors of the constants in csrc/tail.cu.
KIND_TAPS, KIND_GAIN, KIND_MAP = 0, 1, 2
MAP_CODES = {"saturator": 0, "softclipper": 1, "harddistortion": 2,
             "bitcrusher": 3}
TAB_HEADER = 8
TAB_STAGE = 8

# Shared memory on sm_90 (bytes): what one block may use, what one SM has
# for all its resident blocks, and what each resident block costs besides.
SMEM_LIMIT = 232448
SMEM_PER_SM = 233472
SMEM_PER_BLOCK_RESERVED = 1024
# A table larger than this is read from device memory, not shared memory.
TABLE_SMEM_LIMIT = 16384
# Tiles for rings in shared memory, largest first, and the tile of rings
# kept in device memory.
TILES = (4096, 2048, 1024)
SCRATCH_TILE = 4096
# Resident blocks an SM that the runs per channel aim at (two: while one
# block waits on its next tile the other works).
BLOCKS_PER_SM = 2

# Launches of the kernel made by :func:`tail_kernel` (and nothing else) since
# the caller last set it to 0.
launch_count = 0

# params type -> (map name, pure elementwise function)
_MAPS = {
    ws.SaturatorParams: ("saturator", ws._saturate),
    ws.SoftClipperParams: ("softclipper", ws._softclip),
    ws.HardDistortionParams: ("harddistortion", ws._harddist),
    ws.BitCrusherParams: ("bitcrusher", ws._bitcrush),
}


def tail_fusable(effect: Effect) -> bool:
    """Can this effect join a fused tail run?"""
    p = effect.params
    if isinstance(p, DelayParams):
        return not (p.use_lowcut or p.use_highcut)
    if isinstance(p, TremoloParams):
        return True
    return type(p) in _MAPS


def _plan_stages(effects):
    """Static stage plan.

    Returns (stages, n_scalars, n_gain_rows, D_total) where each stage is
      ("taps", offsets: tuple[int], wet: bool, scal_base: int)
      ("gain", row: int)
      ("map", name: str, scal_base: int, n_leaves: int)
    and D_total is the halo: the sum of the stages' largest offsets. The
    scalar slots count the members' runtime scalars in plan order, as the JAX
    planner does."""
    stages = []
    n_scal = 0
    n_gain = 0
    D = 0
    for e in effects:
        p = e.params
        if isinstance(p, DelayParams):
            offsets = tuple(p.time_in_samples * (k + 1)
                            for k in range(p.feedback_loops))
            stages.append(("taps", offsets, p.wet, n_scal))
            n_scal += len(offsets)
            if offsets:
                D += max(offsets)
        elif isinstance(p, TremoloParams):
            stages.append(("gain", n_gain))
            n_gain += 1
        else:
            name, _ = _MAPS[type(p)]
            n_leaves = len(type(p).data_fields)
            stages.append(("map", name, n_scal, n_leaves))
            n_scal += n_leaves
    return stages, n_scal, n_gain, D


def ring_layout(stages, S: int) -> tuple[list[tuple[int, int]], int]:
    """The rings of a tile of S samples: (offset, length) in floats for each
    taps stage in order, and the floats of all of them. A taps stage's ring
    holds its reach (largest offset) of history and the tile, rounded up to
    whole tiles; the first has room for one tile more, the next tile's
    landing place. A plan without a taps stage has one ring of two tiles."""
    reaches = [max(s[1], default=0) for s in stages if s[0] == "taps"]
    if not reaches:
        return [], 2 * S
    layout, off = [], 0
    for j, d in enumerate(reaches):
        n = (-(-d // S) + (2 if j == 0 else 1)) * S
        layout.append((off, n))
        off += n
    return layout, off


def table_words(stages) -> int:
    n_taps = sum(len(s[1]) for s in stages if s[0] == "taps")
    return TAB_HEADER + TAB_STAGE * len(stages) + 2 * n_taps


def _smem_bytes(stages, S: int) -> int:
    words = table_words(stages)
    table = 4 * (-(-words // 4) * 4) if 4 * words <= TABLE_SMEM_LIMIT else 0
    return table + 4 * ring_layout(stages, S)[1]


def geometry(stages) -> tuple[int, bool, int]:
    """(tile, rings in shared memory, resident blocks an SM) for a plan:
    with two blocks an SM, else one, the largest tile of :data:`TILES` whose
    rings fit. On an H100 at the flagship halo the larger tile was ahead at
    equal blocks an SM, and more tiles in flight changed nothing: the kernel
    is bound by its instructions (fewer tiles, fewer barriers and stage
    decodes), not by the bytes in flight (PERF.md, ``chip_smoke.py``'s tail
    sweep). Rings that fit neither way go to device memory, at
    :data:`SCRATCH_TILE`."""
    for per_sm in (BLOCKS_PER_SM, 1):
        for S in TILES:
            if _smem_bytes(stages, S) <= _budget(per_sm):
                return S, True, per_sm
    return SCRATCH_TILE, False, BLOCKS_PER_SM


def _budget(per_sm: int) -> int:
    """Shared memory (bytes) a block may take with per_sm blocks an SM."""
    return min(SMEM_LIMIT, SMEM_PER_SM // per_sm - SMEM_PER_BLOCK_RESERVED)


def check_plan(stages, D: int) -> None:
    """Raise where the kernel's int32 indexing cannot take this plan: a halo
    (and the rings that hold it) beyond 2**31 samples. Any number of stages
    and taps, and any halo below that, is taken."""
    if D + 3 * max(TILES + (SCRATCH_TILE,)) >= 2 ** 31 \
            or table_words(stages) >= 2 ** 31:
        raise ValueError(
            f"the delays of this tail run reach back {D} samples in all: "
            "beyond the fused tail kernel's int32 indexing")


@dataclasses.dataclass(frozen=True)
class TailPlan:
    """A tail run's kernel plan: its stages, its halo, the tile and where
    its rings live, and the stage table on the device."""

    stages: tuple
    halo: int              # D: the sum of the taps stages' reaches
    tile: int              # S
    ring_smem: bool        # rings in shared memory (else device memory)
    blocks_per_sm: int     # what the tile was chosen for
    ring_floats: int       # floats of rings a block
    table: torch.Tensor    # (table_words,) int32 on the device
    table_smem: bool       # the table is copied into shared memory
    n_gain: int

    @property
    def warm_tiles(self) -> int:
        """Tiles a run walks before its first output tile: the halo's."""
        return -(-self.halo // self.tile)


def _f32_bits(v) -> int:
    return struct.unpack("<i", struct.pack("<f", float(v)))[0]


def stage_table(stages, params, S: int) -> np.ndarray:
    """The kernel's int32 stage table for these params and tile (layout in
    ``csrc/tail.cu``)."""
    layout, _ = ring_layout(stages, S)
    taps_idx = [k for k, s in enumerate(stages) if s[0] == "taps"]
    n_taps = sum(len(stages[k][1]) for k in taps_idx)
    ns = len(stages)
    tab = np.zeros(table_words(stages), dtype=np.int32)
    tab[:4] = [ns, n_taps, taps_idx[0] if taps_idx else -1,
               taps_idx[-1] if taps_idx else -1]
    offs = TAB_HEADER + TAB_STAGE * ns
    slot = 0
    for k, (stage, p) in enumerate(zip(stages, params)):
        row = [0] * TAB_STAGE
        if stage[0] == "taps":
            _, offsets, wet, _ = stage
            j = taps_idx.index(k)
            row[:5] = [KIND_TAPS, slot, len(offsets), *layout[j]]
            row[5] = _f32_bits(0.0 if wet else 1.0)
            row[7] = taps_idx[j + 1] if j + 1 < len(taps_idx) else ns
            for i, d in enumerate(offsets):
                tab[offs + slot + i] = d
                tab[offs + n_taps + slot + i] = _f32_bits(np.float32(p.ramp[i]))
            slot += len(offsets)
        elif stage[0] == "gain":
            row[:2] = [KIND_GAIN, stage[1]]
        else:
            row[:2] = [KIND_MAP, MAP_CODES[stage[1]]]
            if isinstance(p, ws.SaturatorParams):
                row[2] = p.mode
                row[5], row[6] = _f32_bits(p.coeff), _f32_bits(p.makeup)
            elif isinstance(p, ws.SoftClipperParams):
                row[5] = _f32_bits(p.drive)
        tab[TAB_HEADER + TAB_STAGE * k:TAB_HEADER + TAB_STAGE * (k + 1)] = row
    return tab


def make_plan(stages, D: int, params, device, tile: int | None = None
              ) -> TailPlan:
    """The plan of a tail run for these params, its table on ``device``.
    ``tile`` overrides the tile :func:`geometry` picks (tests,
    measurement); the rings then live in shared memory where they fit, else
    in device memory."""
    check_plan(stages, D)
    S, ring_smem, per_sm = geometry(stages)
    if tile is not None:
        if tile <= 0 or tile % 4:
            raise ValueError(f"a tile is a positive multiple of 4, got {tile}")
        S = tile
        per_sm = next((k for k in (BLOCKS_PER_SM, 1)
                       if _smem_bytes(stages, S) <= _budget(k)), 0)
        ring_smem = per_sm > 0
        per_sm = per_sm or BLOCKS_PER_SM
    words = table_words(stages)
    return TailPlan(
        stages=tuple(stages), halo=D, tile=S, ring_smem=ring_smem,
        blocks_per_sm=per_sm, ring_floats=ring_layout(stages, S)[1],
        table=torch.from_numpy(stage_table(stages, params, S)).to(device),
        table_smem=4 * words <= TABLE_SMEM_LIMIT,
        n_gain=sum(1 for s in stages if s[0] == "gain"))


_sm_counts: dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    n = _sm_counts.get(index)
    if n is None:
        n = _sm_counts[index] = \
            torch.cuda.get_device_properties(index).multi_processor_count
    return n


def runs_for(plan: TailPlan, C: int, T: int, sms: int) -> int:
    """Runs of tiles per channel: enough blocks to keep ``blocks_per_sm`` on
    every SM, but no run shorter than the halo it walks first, and none
    empty."""
    n_tiles = -(-T // plan.tile)
    want = max(1, plan.blocks_per_sm * sms // max(C, 1))
    runs = max(1, min(want, n_tiles // max(1, plan.warm_tiles), n_tiles))
    return -(-n_tiles // -(-n_tiles // runs))


def tail_kernel(plan: TailPlan, x: torch.Tensor, gains: torch.Tensor | None,
                runs: int | None = None) -> torch.Tensor:
    """Launch the fused tail over ``x``: (C, T) -> (C, T) on a CUDA tensor.
    ``gains`` is (n_gain_rows, T) float32, or None for a plan without a
    ``gain`` stage. ``runs`` (runs of tiles per channel) overrides
    :func:`runs_for`, for measurement only."""
    global launch_count
    if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 2 \
            or not x.is_contiguous():
        raise ValueError(
            "tail_kernel takes a contiguous (C, T) float32 CUDA tensor, got "
            f"{tuple(x.shape)} {x.dtype} on {x.device}")
    C, T = x.shape
    if plan.n_gain:
        if gains is None or gains.shape != (plan.n_gain, T) \
                or gains.dtype != torch.float32 or gains.device != x.device \
                or not gains.is_contiguous():
            raise ValueError(
                f"gains must be a contiguous ({plan.n_gain}, {T}) float32 "
                f"tensor on {x.device}")
    if plan.table.device != x.device:
        raise ValueError(
            f"the plan's table is on {plan.table.device}, the signal on "
            f"{x.device}")
    S = plan.tile
    if T >= 2 ** 31 - 2 * S:
        raise ValueError(f"signal of {T} samples is too long for int32 indexing")
    out = torch.empty_like(x)
    if C == 0 or T == 0:
        return out
    n_tiles = -(-T // S)
    if runs is None:
        runs = runs_for(plan, C, T, _sm_count(x.device))
    else:
        runs = -(-n_tiles // -(-n_tiles // max(1, min(runs, n_tiles))))
    scratch = None if plan.ring_smem else torch.empty(
        C * runs * plan.ring_floats, dtype=torch.float32, device=x.device)
    fn = _build.launcher("tail", "tail_launch",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                         + [ctypes.c_void_p] + [ctypes.c_int] * 6
                         + [ctypes.c_void_p])
    with _build.on_device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(),
                 gains.data_ptr() if plan.n_gain else None,
                 plan.table.data_ptr(), plan.table.numel(),
                 int(plan.table_smem), int(plan.ring_smem),
                 None if scratch is None else scratch.data_ptr(),
                 plan.ring_floats, C, T, S, runs, plan.warm_tiles,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"tail kernel launch failed with CUDA error {err} "
            f"(C={C}, T={T}, halo={plan.halo}, tile={S}, runs={runs})")
    launch_count += 1
    return out


def _plan_cache(stages, D: int, own, device, members=lambda p: p):
    """``plan_for(params, device)``: the plan of one run's stages for these
    params (``members(params)`` gives the members' params in order), kept by
    the params' identity. The plan for ``own`` is built here, on ``device``,
    so that a graph capture of the effect finds it and builds none."""
    plans = {id(own): (own, make_plan(stages, D, members(own), device))}

    def plan_for(params, device) -> TailPlan:
        hit = plans.get(id(params))
        if hit is None or hit[0] is not params \
                or hit[1].table.device != device:
            hit = (params, make_plan(stages, D, members(params), device))
            plans[id(params)] = hit
        return hit[1]

    return plan_for


def map_offline(effect: Effect):
    """The ``offline`` of a lone waveshaper (no run to fuse into): on a CUDA
    tensor one launch of :func:`tail_kernel` with a one-stage ``map`` plan,
    a single pass over the signal where the plain map makes about ten; on a
    CPU tensor, or with ``use_kernels=False``, the plain map."""
    _, fn = _MAPS[type(effect.params)]
    stages, _, _, D = _plan_stages((effect,))
    plan_for = _plan_cache(stages, D, effect.params, effect.device,
                           members=lambda p: (p,))

    def offline(params, blocks: torch.Tensor, use_kernels: bool = True
                ) -> torch.Tensor:
        if not (blocks.is_cuda and use_kernels):
            return fn(params, blocks)
        shape = blocks.shape
        x = blocks.reshape(-1, shape[-2] * shape[-1]).contiguous()
        return tail_kernel(plan_for(params, x.device), x, None).reshape(shape)

    return offline


def fused_tail(effects) -> Effect:
    """ONE Effect for a tail run (delay / tremolo / waveshapers, in order).
    Offline runs the fused CUDA kernel on a CUDA tensor and the members'
    plain versions in sequence on a CPU tensor; streaming runs the members'
    own steps with a tuple state. The kernel plan (its table on the
    members' device) is built here, once, for the members' own params."""
    members = tuple(effects)
    stages, _n_scal, _n_gain, D_total = _plan_stages(members)
    own = tuple(e.params for e in members)
    plan_for = _plan_cache(stages, D_total, own, members[0].device)

    def _sequential(params, blocks, first_block):
        for e, p in zip(members, params):
            kw = {"first_block": first_block} if e.block_indexed else {}
            blocks = e.offline(p, blocks, use_kernels=False, **kw)
        return blocks

    def offline(params, blocks: torch.Tensor, use_kernels: bool = True,
                first_block: int = 0) -> torch.Tensor:
        if not (blocks.is_cuda and use_kernels):
            return _sequential(params, blocks, first_block)
        shape = blocks.shape
        nb, B = shape[-2], shape[-1]
        T = nb * B
        x = blocks.reshape(-1, T)
        rows = [gain_row(p, nb, B, x.device, first_block) for p in params
                if isinstance(p, TremoloParams)]
        gains = torch.stack(rows) if rows else None
        out = tail_kernel(plan_for(params, x.device), x, gains)
        return out.reshape(shape)

    def step(params, state, block: torch.Tensor):
        new_states = []
        for e, p, st in zip(members, params, state):
            st, block = e.step(p, st, block)
            new_states.append(st)
        return tuple(new_states), block

    def init_state(params, batch_shape: tuple[int, ...] = ()):
        return tuple(e.init_state(p, batch_shape)
                     for e, p in zip(members, params))

    # Time-parallel with a left halo of D_total samples: every taps stage's
    # input within its reach of a shard's first output sample is then the
    # true signal's, and a gain stage takes the shard's first block.
    name = "tail:" + "+".join(e.name for e in members)
    return Effect(name=name, params=own, init_state=init_state, step=step,
                  offline=offline, time_parallel=True,
                  device=members[0].device, reach=D_total,
                  block_indexed=True)
