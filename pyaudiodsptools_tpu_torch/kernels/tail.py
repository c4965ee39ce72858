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

Halo semantics: positions before the signal start are SILENCE after every
stage (a delay's history starts at zeros), so the region before the start is
re-zeroed after any stage that precedes a ``taps`` stage: HardDistortion
maps 0 to about 0.95.

What bounds it on an H100: bytes. The function reads the signal once and
writes it once; the arithmetic is a few operations per sample. The design
loads one time tile plus a left halo of D samples (D = the sum of the
stages' largest tap offsets) into shared memory, applies every stage there,
and writes the tile; the halo re-reads of neighbouring blocks hit L2. The
stage plan is DATA (a small table passed by value), so one build serves
every chain.

The CUDA source is ``csrc/tail.cu``. The plain version is the member ops'
plain ``offline``s in sequence; it runs for CPU tensors, or on request
(``use_kernels=False``), and is never a fallback for a CUDA tensor. A run
whose halo leaves no room for a tile in a block's shared memory, or whose
plan outgrows the stage table, is refused when the fused effect is built
(:func:`check_plan`).
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import waveshapers as ws
from ..ops.base import Effect
from ..ops.delay import DelayParams
from ..ops.tremolo import TremoloParams, gain_row
from . import _build

# Mirrors of the constants in csrc/tail.cu.
MAX_STAGES = 16
MAX_TAPS = 64
KIND_TAPS, KIND_GAIN, KIND_MAP = 0, 1, 2
MAP_CODES = {"saturator": 0, "softclipper": 1, "harddistortion": 2,
             "bitcrusher": 3}

# Shared memory on sm_90 (bytes): what one block may use, and what one SM
# has for all its resident blocks (each block also costs about 1 KB of
# bookkeeping).
SMEM_LIMIT = 232448
SMEM_PER_SM = 233472
# Tile geometry: the largest tile chosen unasked, and the smallest worth a
# launch.
MAX_TILE = 16384
MIN_TILE = 1024

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


class _Stage(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int), ("a", ctypes.c_int),
                ("b", ctypes.c_int), ("zero_after", ctypes.c_int),
                ("lo", ctypes.c_int),
                ("p0", ctypes.c_float), ("p1", ctypes.c_float)]


class _Plan(ctypes.Structure):
    _fields_ = [("n_stages", ctypes.c_int), ("halo", ctypes.c_int),
                ("stages", _Stage * MAX_STAGES),
                ("offsets", ctypes.c_int * MAX_TAPS),
                ("weights", ctypes.c_float * MAX_TAPS)]


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


def _stage_table(stages, D: int, params) -> _Plan:
    """The kernel's by-value stage table for these params."""
    plan = _Plan()
    plan.n_stages = len(stages)
    plan.halo = D
    n_taps = 0
    lo = 0
    for k, (stage, p) in enumerate(zip(stages, params)):
        st = plan.stages[k]
        st.zero_after = int(any(s[0] == "taps" for s in stages[k + 1:]))
        if stage[0] == "taps":
            _, offsets, wet, _ = stage
            # a taps stage reads max(offsets) below each position, so what
            # it and every later stage must compute starts that much higher
            lo += max(offsets, default=0)
            st.kind, st.a, st.b = KIND_TAPS, n_taps, len(offsets)
            st.p0 = 0.0 if wet else 1.0
            for i, d in enumerate(offsets):
                plan.offsets[n_taps + i] = d
                plan.weights[n_taps + i] = float(p.ramp[i])
            n_taps += len(offsets)
        elif stage[0] == "gain":
            st.kind, st.a = KIND_GAIN, stage[1]
        else:
            st.kind, st.a = KIND_MAP, MAP_CODES[stage[1]]
            if isinstance(p, ws.SaturatorParams):
                st.p0, st.p1, st.b = float(p.coeff), float(p.makeup), p.mode
            elif isinstance(p, ws.SoftClipperParams):
                st.p0 = float(p.drive)
        st.lo = lo
    assert lo == D
    return plan


def tile_for(T: int, D: int) -> int:
    """Samples per time tile, a multiple of 32; 0 where no tile of at least
    MIN_TILE fits beside the halo.

    The tile is sized so that TWO blocks are resident per SM (one loads
    while the other computes; measured faster on an H100 than one larger
    tile per SM), unless the halo leaves less than MIN_TILE for that: then
    one block per SM with the largest tile that fits."""
    room = SMEM_LIMIT // 4 - D
    pair = (SMEM_PER_SM // 2 - 2048) // 4 - D
    tile = min(pair, MAX_TILE) if pair >= MIN_TILE else MAX_TILE
    S = min(tile, room) // 32 * 32
    if S < MIN_TILE:
        return 0
    return max(32, min(S, -(-T // 32) * 32))


def check_plan(stages, D: int) -> None:
    """Raise where the kernel cannot take this plan: more stages or taps
    than its by-value table holds, or a halo that leaves no room for a time
    tile in a thread block's shared memory. (Neither depends on the signal's
    length.)"""
    n_taps = sum(len(s[1]) for s in stages if s[0] == "taps")
    if len(stages) > MAX_STAGES or n_taps > MAX_TAPS:
        raise ValueError(
            f"a tail run of {len(stages)} stages and {n_taps} taps exceeds "
            f"the fused tail kernel's stage table ({MAX_STAGES} stages, "
            f"{MAX_TAPS} taps). Split the run, or build the Chain with "
            "fuse=False to run its members one by one.")
    if tile_for(MAX_TILE, D) == 0:
        raise ValueError(
            f"the delays of this tail run reach back {D} samples in all; the "
            "fused tail kernel keeps that halo and a time tile of at least "
            f"{MIN_TILE} samples in a thread block's shared memory, "
            f"{SMEM_LIMIT // 4 - MIN_TILE} samples at most. A tail that walks "
            "along time with the halo kept as a ring is left to a later "
            "change (PERF.md, open questions). Split the run, or build the "
            "Chain with fuse=False to run its members one by one.")


def tail_kernel(stages, D: int, params, x: torch.Tensor,
                gains: torch.Tensor | None) -> torch.Tensor:
    """Launch the fused tail over ``x``: (C, T) -> (C, T) on a CUDA tensor.
    ``gains`` is (n_gain_rows, T) float32, or None for a plan without a
    ``gain`` stage."""
    global launch_count
    if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 2 \
            or not x.is_contiguous():
        raise ValueError(
            "tail_kernel takes a contiguous (C, T) float32 CUDA tensor, got "
            f"{tuple(x.shape)} {x.dtype} on {x.device}")
    C, T = x.shape
    n_gain = sum(1 for s in stages if s[0] == "gain")
    if n_gain:
        if gains is None or gains.shape != (n_gain, T) \
                or gains.dtype != torch.float32 or gains.device != x.device \
                or not gains.is_contiguous():
            raise ValueError(
                f"gains must be a contiguous ({n_gain}, {T}) float32 tensor "
                f"on {x.device}")
    check_plan(stages, D)
    S = tile_for(T, D)
    if T >= 2 ** 31 - S:
        raise ValueError(f"signal of {T} samples is too long for int32 indexing")
    out = torch.empty_like(x)
    if C == 0 or T == 0:
        return out
    plan = _stage_table(stages, D, params)
    lib = _build.load("tail")
    fn = lib.tail_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(_Plan), ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(),
                 gains.data_ptr() if n_gain else None, ctypes.byref(plan),
                 C, T, S, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"tail kernel launch failed with CUDA error {err} "
            f"(C={C}, T={T}, halo={D}, tile={S})")
    launch_count += 1
    return out


def fused_tail(effects) -> Effect:
    """ONE Effect for a tail run (delay / tremolo / waveshapers, in order).
    Offline runs the fused CUDA kernel on a CUDA tensor and the members'
    plain versions in sequence on a CPU tensor; streaming runs the members'
    own steps with a tuple state. Raises ValueError for a run the kernel
    cannot take (:func:`check_plan`), whatever the device."""
    members = tuple(effects)
    stages, _n_scal, _n_gain, D_total = _plan_stages(members)
    check_plan(stages, D_total)

    def _sequential(params, blocks):
        for e, p in zip(members, params):
            blocks = e.offline(p, blocks, use_kernels=False)
        return blocks

    def offline(params, blocks: torch.Tensor,
                use_kernels: bool = True) -> torch.Tensor:
        if not (blocks.is_cuda and use_kernels):
            return _sequential(params, blocks)
        shape = blocks.shape
        nb, B = shape[-2], shape[-1]
        T = nb * B
        x = blocks.reshape(-1, T)
        rows = [gain_row(p, nb, B, x.device) for p in params
                if isinstance(p, TremoloParams)]
        gains = torch.stack(rows) if rows else None
        out = tail_kernel(stages, D_total, params, x, gains)
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

    name = "tail:" + "+".join(e.name for e in members)
    return Effect(name=name, params=tuple(e.params for e in members),
                  init_state=init_state, step=step, offline=offline,
                  time_parallel=False, device=members[0].device)
