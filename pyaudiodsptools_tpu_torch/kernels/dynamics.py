"""Dynamics on the card: the speculative segment-parallel walks (planner,
fixpoint loop) for whole signals, the serial walk for the streaming step,
their wrappers and plain versions, and the fused cascade effect.

Replaces, of ``pyaudiodsptools_tpu/kernels/dynamics_pallas.py``:
``dynamics_pallas_offline`` with its two TPU kernels ``_spec_kernel`` (here
:func:`audio_walk`) and ``_spec_state_kernel`` (here :func:`state_walk`),
the serial kernel ``dynamics_pallas`` (here :func:`serial_walk`, which
:func:`cascade_step` wraps for the effects' ``step``), ``encode_state``, and
the effect factory ``fused_dynamics``.

Why speculation is sound: the over-threshold mask depends only on the INPUT,
never on the automaton's own output, so the gain trajectory is a
deterministic function of (entry state, mask sequence). Time is cut into G
segments; every (segment, channel) lane walks its segment from a guessed
entry state (REST); each segment's exit state becomes the next segment's
entry and the walk repeats until the entries no longer change. The automaton
synchronises (a run of over-samples forces HOLD, a completed release forces
REST, whatever the entry), so on real audio most exits are right at once;
the worst case is G walks. The fixpoint is the serial state trajectory, so
the result does not depend on G: ``segments=1`` IS the serial walk, and every
other segmentation is bit-equal to it.

State: one int per lane and op (:func:`encode_state`):

    s = -1            skip (one sample after a completed release)
    s = 0             REST
    s in [1, x_max)   ATTACK, x == s
    s = x_max         HOLD
    s = x_max + y     RELEASE, y in [1, y_max)

The ramps are arithmetic (``start + i*step``), as in the JAX kernels, which
differs from the faithful step's float32 ``linspace`` tables by <= 2 ulp.

The loop ("hybrid", the JAX package's default): one states-only walk from
REST, then audio walks until the shifted exits equal the entries, at most
G+2 walks in all (unreachable: entries settle at least one segment per
walk). After each walk the settle step (:func:`settle`, one small launch of
``csrc/dynamics.cu``, the counterpart of JAX's ``next_entries`` and
``jnp.all``) shifts the exits into the entries in place (lane
``r = g*C + c``), compares, counts the walk and writes a ``done`` flag on the
device. Run eagerly, the loop reads that flag back once a walk. Inside a
CUDA graph capture (a captured render, ``engine/graph.py``) the audio walk
and the settle step are the body of a conditional while node
(``graph_cond.while_node``) and the settle step sets the node's condition
itself, so the loop runs on the card with no read-back, as JAX's
``lax.while_loop`` runs inside its jitted render. Either way the same walks
run on the same entries, and the audio always comes from converged entries;
the flags go to ``graph_cond.note_fixpoint``, where a caller that opened
``graph_cond.fixpoints`` reads the walks.

The walks read the signal (C, T) as it lies and the audio walk writes its
output (C, T): segment g of channel c is ``x[c, g*L : (g+1)*L]``, the last
one ragged. The TPU kernels read a time-major copy made by
``kernels/relayout.pack`` and undone by ``unpack``; the kernels here stage
tiles of segments through shared memory instead, so the offline stage
launches no relayout kernel.

What bounds the walks on an H100: a lane's walk is serial, about a dozen
dependent instructions per op and sample, so what matters is how many lanes
there are. :func:`plan_segments` chooses G for this card (the sweep is in
PERF.md); it is free to, because the result does not depend on G. The CUDA
source is ``csrc/dynamics.cu``.

Streaming: :func:`serial_walk` walks one (C, T) block, channel-major as it
lies, from the carried states, a whole cascade in one launch, and returns the
exit states. Its kernel brings the speculation above inside a thread block:
one block a channel, the block's samples in shared memory, one thread a
segment of ``SERIAL_SEGMENT_LOG2`` samples; the first guess is the carried
state advanced in closed form as if the block were silent (exact where a
gate's release outlasts the block), and every round walks with audio, so a
right guess costs one walk. It runs the same device functions as the audio
walk and is bit-equal to it at one segment. :func:`cascade_step`, the
effects' ``step``, is ONE launch of that kernel: it reads and writes the four
fields of ``ops/dynamics.py``'s carry itself, as the TPU kernel does.
:func:`encode_state` and :func:`decode_state` serve the plain version, the
offline stage and the tests.

The time-sharded stage (``parallel/dynspec.py``) walks each time rank's
shard with :func:`serial_walk`, into buffers it gives, and after the exits'
exchange runs the round step (:func:`round_step`, one small launch of
``csrc/dynamics.cu``'s round kernel, :func:`round_step_plain` beside it): the
previous rank's exits become the entries (REST on the first rank), the round
is counted and the moved flag that the ranks all-reduce is written, on the
device.

The plain versions (:func:`walk_plain`: the same single-int automaton as
tensor code over all lanes with a Python loop over the rows, separate ``mul``
and ``add`` calls in the kernel's order; for the offline walks,
:func:`segments_plain`, on the time-major copy ``relayout.pack_plain`` makes,
the output put back by ``relayout.unpack_plain``) run for CPU tensors, or on
request (``use_kernels=False``), and are never a fallback for a CUDA tensor.
Kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops.base import Effect
from ..ops.dynamics import ATTACK, HOLD, RELEASE, REST, DynamicsParams
from . import _build, graph_cond, relayout

# Mirror of DYN_MAX_OPS in csrc/dynamics.cu: ops per cascade kernel.
MAX_OPS = 4

# The planner's two constants, chosen from a sweep of the whole stage over G
# on an H100 at 64 channels x 30 s (chip_smoke.py, `segment_sweep`; the table
# is in PERF.md). More lanes shorten a walk until the card is full (about
# 131,072 lanes), but a segment shorter than a release hands its state on
# one segment per walk: on audio with silences the walks grow as
# 2 + release / L (the flagship gate's release is 8,824 samples), on audio
# that never falls silent they stay at 2. 16,384 lanes (G = 256 at 64
# channels, L = 5,168) had the smallest sum of the two cases' times in four
# sweeps of five; 32,768 is faster on the never-silent input alone.
TARGET_LANES = 16384
MIN_SEGMENT = 2048

# The serial walk's kernel (the streaming step) cuts a block of T samples into
# segments of 2^k samples, one thread each: (largest T, k) in rising order,
# None for every longer block. From a sweep on an H100 at 64 channels
# (chip_smoke.py, `serial_walk_sweep`; the table is in PERF.md): a round costs
# the segment's length, and a state that is neither quiet nor synchronised (an
# attack of 136 samples) is handed on one segment a round, so short segments
# pay in rounds what they save a round. 16 samples at T = 512 and 32 at
# T = 4,096 had the best worst case of the signals swept.
SERIAL_SEGMENT_LOG2 = ((1024, 4), (None, 5))
# Mirrors of csrc/dynamics.cu: threads a block at most, and the samples of a
# tile (two tiles of floats and the segments' states fit a block's shared
# memory with room to spare).
SERIAL_MAX_THREADS = 1024
SERIAL_MAX_TILE = 16384
# Threads a block at least where the block is long enough to use them: with
# one thread a segment the tile's load and store would take as long as a
# round (same sweep: 512 threads took 0.003 ms off every walk at T = 4,096).
SERIAL_MIN_THREADS = 512

# Mirrors of csrc/dynamics.cu's offline walks: rows (segments) a thread
# block, samples a row of a tile, tiles in the ring (the numpy mirror of the
# schedule, tests/torch_port_util.emulate_tile_walk, takes them).
TILE_ROWS = 128
TILE_K = 32
TILE_STAGES = 3

# Launches of the two kernels made by :func:`state_walk` / :func:`audio_walk`
# (and by nothing else) since the caller last set them to 0.
state_walk_launch_count = 0
audio_walk_launch_count = 0
# Launches of the serial-walk kernel made by :func:`serial_walk` and
# :func:`cascade_step` (one a call).
serial_walk_launch_count = 0
# Launches of the settle step made by :func:`settle` (one a walk). Inside a
# captured render the audio walks and settle steps of the while node are
# counted when the render's walks are read (``CapturedRender.walks``).
settle_launch_count = 0

# The settle step's flags, int32[4]: done, walks of this render (the state
# walk included), audio walks since the flags were zeroed, and loops that
# ended at the bound unsettled. Its modes: after the state walk, after an
# audio walk run eagerly, inside a while node (sets the node's condition).
FLAG_DONE, FLAG_WALKS, FLAG_AUDIO_WALKS, FLAG_UNSETTLED = range(4)
AFTER_STATE_WALK, AFTER_AUDIO_WALK, IN_WHILE_NODE = range(3)

# Launches of the round kernel made by :func:`round_step` and
# :func:`round_gate` (parallel/dynspec.py's rounds on the device).
round_launch_count = 0
# The round step's flags, int32[3]: an entry moved in the last round (then
# all-reduced over the time ranks), the live rounds of this render (those the
# JAX package's loop runs), live rounds since the flags were zeroed.
ROUND_CHANGED, ROUND_COUNT, ROUND_TOTAL = range(3)

_F = np.float32


class _Op(ctypes.Structure):
    _fields_ = [("thr", ctypes.c_float), ("pre", ctypes.c_float),
                ("ratio", ctypes.c_float), ("att_step", ctypes.c_float),
                ("rel0", ctypes.c_float), ("rel_step", ctypes.c_float),
                ("x_max", ctypes.c_int), ("end", ctypes.c_int)]


class _Ops(ctypes.Structure):
    _fields_ = [("n_ops", ctypes.c_int), ("op", _Op * MAX_OPS)]


class _Carry(ctypes.Structure):
    """csrc/dynamics.cu's DynCarry: where the serial walk's kernel reads and
    writes the carried states (all device pointers)."""
    _fields_ = [("entry", ctypes.c_void_p), ("exit_state", ctypes.c_void_p),
                ("mode", ctypes.c_void_p * MAX_OPS),
                ("x", ctypes.c_void_p * MAX_OPS),
                ("y", ctypes.c_void_p * MAX_OPS),
                ("skip", ctypes.c_void_p * MAX_OPS),
                ("ints_out", ctypes.c_void_p), ("skip_out", ctypes.c_void_p)]


def op_scalars(params: DynamicsParams) -> tuple:
    """(thr, pre, ratio, att_step, rel0, rel_step, x_max, end) of one op, the
    floats as numpy float32 computed in float32 like the JAX package's
    ``_pack_fscal``. ``ratio`` (hold / re-trigger gain, ``attack_env[-1]``)
    and ``rel0`` (``release_env[0]``) differ when x_max == 1, because
    ``numpy.linspace(1.0, r, num=1)`` is ``[1.0]``: both are carried."""
    ratio = _F(params.attack_env[-1].item())
    rel0 = _F(params.release_env[0].item())
    return (_F(params.threshold.item()), _F(params.pre_gain.item()), ratio,
            (ratio - _F(1.0)) / _F(max(params.x_max - 1, 1)),
            rel0, (_F(1.0) - rel0) / _F(max(params.y_max - 1, 1)),
            int(params.x_max), int(params.x_max + params.y_max))


def _as_list(params) -> list[DynamicsParams]:
    plist = list(params) if isinstance(params, (list, tuple)) else [params]
    if not 1 <= len(plist) <= MAX_OPS:
        raise ValueError(
            f"a dynamics cascade of {len(plist)} ops: one kernel walks 1 to "
            f"{MAX_OPS}; Chain cuts longer runs into consecutive cascades")
    return plist


def encode_state(params: DynamicsParams, state) -> torch.Tensor:
    """Pack the 4-field carry (ops/dynamics.init_state layout) into single
    ints."""
    mode, x, y = state["mode"], state["x"], state["y"]
    s = torch.where(mode == ATTACK, x,
                    torch.where(mode == HOLD, params.x_max,
                                torch.where(mode == RELEASE,
                                            params.x_max + y, 0)))
    return torch.where(state["skip"], -1, s).to(torch.int32)


def decode_state(params: DynamicsParams, s: torch.Tensor) -> dict:
    """The inverse of :func:`encode_state` on every state the automaton can
    be in: REST and skip carry x = y = 0, ATTACK counts x in [1, x_max),
    HOLD has x = x_max, RELEASE counts y in [1, y_max) with x = 0."""
    x_max = params.x_max
    attack = (s > 0) & (s < x_max)
    hold = s == x_max
    release = s > x_max
    mode = torch.where(attack, ATTACK,
                       torch.where(hold, HOLD,
                                   torch.where(release, RELEASE, REST)))
    return {"mode": mode.to(torch.int32),
            "x": torch.where(attack | hold, s, 0).to(torch.int32),
            "y": torch.where(release, s - x_max, 0).to(torch.int32),
            "skip": s < 0}


def plan_segments(C: int, T: int) -> int:
    """Segments to ask for: TARGET_LANES lanes, but no segment shorter than
    MIN_SEGMENT samples (shorter ones rarely synchronise within themselves
    and cost walks)."""
    return max(1, min(TARGET_LANES // max(C, 1), T // MIN_SEGMENT))


# ---------------------------------------------------------------------------
# the walks


def _int_automaton(sc: tuple, s: torch.Tensor, row: torch.Tensor,
                   with_gain: bool = True):
    """One sample of one op on all lanes: (state, row) -> (output row, next
    state); ``dynamics_pallas._int_automaton`` in PyTorch, each product and
    sum a call of its own."""
    thr, pre, ratio, att_step, rel0, rel_step, x_max, end = sc
    over = torch.abs(row) > float(thr)
    pos = s > 0
    in_att = pos & (s < x_max)
    out = row
    if with_gain:
        s_f = s.to(torch.float32)
        att_g = torch.add(torch.mul(s_f, float(att_step)), 1.0)
        rel_g = torch.add(torch.mul(torch.sub(s_f, float(x_max)),
                                    float(rel_step)), float(rel0))
        hi_g = torch.where(over, float(ratio), rel_g)
        gain = torch.where(pos, torch.where(in_att, att_g, hi_g), 1.0)
        out = torch.mul(torch.mul(row, float(pre)), gain)
    sp1 = s + 1
    rel_next = torch.where(sp1 == end, -1, sp1)      # release done -> skip
    hi_next = torch.where(over, x_max, rel_next)     # hold stay / re-trigger
    n = torch.where(in_att, sp1, hi_next)            # attack ignores the mask
    n = torch.where(s == 0, over.to(torch.int32), n)  # REST trigger
    n = torch.where(s < 0, 0, n)                     # skip consumes itself
    return out, n


def walk_plain(scalars: list[tuple], x: torch.Tensor, entry: torch.Tensor,
               audio: bool):
    """The walk on a time-major signal: x (L, R), entry (n_ops, R) int32 ->
    (out (L, R) or None, exit (n_ops, R) int32), every lane at once. Without
    ``audio`` the last op's gain is left out, as in the state-walk kernel."""
    n_ops = len(scalars)
    states = [entry[j] for j in range(n_ops)]
    rows = []
    for l in range(x.shape[0]):
        row = x[l]
        for j, sc in enumerate(scalars):
            row, states[j] = _int_automaton(
                sc, states[j], row, with_gain=audio or j + 1 < n_ops)
        if audio:
            rows.append(row)
    out = None
    if audio:
        out = torch.stack(rows) if rows else torch.empty_like(x)
    return out, torch.stack(states).to(torch.int32)


def segments_plain(scalars: list[tuple], x: torch.Tensor, G: int, L: int,
                   entry: torch.Tensor, audio: bool):
    """The plain version of both offline walks: x (C, T) cut into G segments
    of L samples a channel, entry (n_ops, C*G) int32 (lane g*C + c) -> (out
    (C, T) or None, exit (n_ops, C*G) int32). The time-major copy of
    ``relayout.pack_plain`` (zeros past T), :func:`walk_plain`, and the
    output put back by ``relayout.unpack_plain``."""
    C, T = x.shape
    tm = relayout.pack_plain(x, G, L, C * G)
    out, exit_state = walk_plain(scalars, tm, entry, audio=audio)
    if audio:
        out = relayout.unpack_plain(out, C, T, G, L)
    return out, exit_state


def _check_walk(scalars, x: torch.Tensor, G: int, L: int,
                entry: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            "a walk takes a contiguous (C, T) float32 tensor, got "
            f"{tuple(x.shape)} {x.dtype} contiguous={x.is_contiguous()}")
    C, T = x.shape
    if min(C, T, G, L) < 1 or (G - 1) * L >= T or G * L < T:
        raise ValueError(
            f"segments do not tile the signal: C={C}, T={T}, G={G}, L={L} "
            "(need (G-1)*L < T <= G*L)")
    if C * G >= 2 ** 31:
        raise ValueError(f"{C * G} lanes: the walks index lanes with int32")
    _check_entry(scalars, C * G, entry, x.device)


def _check_entry(scalars, lanes: int, entry: torch.Tensor, device) -> None:
    if not 1 <= len(scalars) <= MAX_OPS:
        raise ValueError(f"a walk takes 1 to {MAX_OPS} ops, got {len(scalars)}")
    want = (len(scalars), lanes)
    if entry.dtype != torch.int32 or tuple(entry.shape) != want \
            or entry.device != device or not entry.is_contiguous():
        raise ValueError(
            f"entry states must be a contiguous {want} int32 tensor on "
            f"{device}, got {tuple(entry.shape)} {entry.dtype} on "
            f"{entry.device}")
    if lanes < 1:
        raise ValueError("a walk needs at least one lane")


_tables: dict[int, tuple] = {}


def _ops_table(scalars) -> _Ops:
    """The kernels' by-value table of a cascade, built once per scalars list
    (an effect keeps its list, and a streaming step must not rebuild the
    table block after block). The list is kept with its table, so that its
    identity stays its own; nothing changes a scalars list once it is made."""
    hit = _tables.get(id(scalars))
    if hit is None or hit[0] is not scalars:
        if len(_tables) >= 256:         # lists made per call: do not keep them
            _tables.clear()
        hit = _tables[id(scalars)] = (scalars, _build_table(scalars))
    return hit[1]


def _build_table(scalars) -> _Ops:
    table = _Ops()
    table.n_ops = len(scalars)
    for j, sc in enumerate(scalars):
        op = table.op[j]
        (op.thr, op.pre, op.ratio, op.att_step, op.rel0, op.rel_step) = \
            (float(v) for v in sc[:6])
        op.x_max, op.end = sc[6], sc[7]
    return table


def _launch_walk(scalars, x, G: int, L: int, entry, audio: bool,
                 out=None, exit_state=None):
    C, T = x.shape
    if audio and out is None:
        out = torch.empty_like(x)
    if exit_state is None:
        exit_state = torch.empty_like(entry)
    table = _ops_table(scalars)
    ops = ctypes.POINTER(_Ops)
    if audio:
        fn = _build.launcher("dynamics", "dynamics_audio_walk_launch",
                             [ctypes.c_void_p] * 4 + [ops]
                             + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    else:
        fn = _build.launcher("dynamics", "dynamics_state_walk_launch",
                             [ctypes.c_void_p] * 3 + [ops]
                             + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    with _build.on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if audio:
            err = fn(x.data_ptr(), out.data_ptr(), entry.data_ptr(),
                     exit_state.data_ptr(), ctypes.byref(table), C, T, G, L,
                     stream)
        else:
            err = fn(x.data_ptr(), entry.data_ptr(), exit_state.data_ptr(),
                     ctypes.byref(table), C, T, G, L, stream)
    if err != 0:
        raise RuntimeError(
            f"dynamics {'audio' if audio else 'state'} walk launch failed "
            f"with CUDA error {err} (n_ops={len(scalars)}, C={C}, T={T}, "
            f"G={G}, L={L})")
    return out, exit_state


def _check_into(t: torch.Tensor, like: torch.Tensor, what: str) -> None:
    if t.shape != like.shape or t.dtype != like.dtype \
            or t.device != like.device or not t.is_contiguous() \
            or t.data_ptr() == like.data_ptr():
        raise ValueError(
            f"{what} must be a contiguous {tuple(like.shape)} {like.dtype} "
            f"tensor on {like.device} of its own, got {tuple(t.shape)} "
            f"{t.dtype} on {t.device}")


def state_walk(scalars, x: torch.Tensor, G: int, L: int, entry: torch.Tensor,
               use_kernels: bool = True,
               exit_state: torch.Tensor | None = None) -> torch.Tensor:
    """Exit states (n_ops, C*G) of walking the G segments of L samples of
    every channel of x (C, T) from ``entry`` (lane g*C + c). A CUDA tensor
    goes through the hand-written kernel, or the call raises. With
    ``exit_state`` (shaped as ``entry``) the states are written there."""
    global state_walk_launch_count
    _check_walk(scalars, x, G, L, entry)
    if exit_state is not None:
        _check_into(exit_state, entry, "exit_state")
    if not (x.is_cuda and use_kernels):
        z = segments_plain(scalars, x, G, L, entry, audio=False)[1]
        return z if exit_state is None else exit_state.copy_(z)
    _, exit_state = _launch_walk(scalars, x, G, L, entry, audio=False,
                                 exit_state=exit_state)
    state_walk_launch_count += 1
    return exit_state


def audio_walk(scalars, x: torch.Tensor, G: int, L: int, entry: torch.Tensor,
               use_kernels: bool = True, out: torch.Tensor | None = None,
               exit_state: torch.Tensor | None = None):
    """(out (C, T), exit states (n_ops, C*G)) of the same walk with audio:
    the output lies as x does. With ``out`` / ``exit_state`` the results
    are written there (a captured loop allocates nothing)."""
    global audio_walk_launch_count
    _check_walk(scalars, x, G, L, entry)
    if out is not None:
        _check_into(out, x, "out")
    if exit_state is not None:
        _check_into(exit_state, entry, "exit_state")
    if not (x.is_cuda and use_kernels):
        y, z = segments_plain(scalars, x, G, L, entry, audio=True)
        return (y if out is None else out.copy_(y),
                z if exit_state is None else exit_state.copy_(z))
    out, exit_state = _launch_walk(scalars, x, G, L, entry, audio=True,
                                   out=out, exit_state=exit_state)
    audio_walk_launch_count += 1
    return out, exit_state


def settle_plain(z: torch.Tensor, entry: torch.Tensor, flags: torch.Tensor,
                 C: int, mode: int) -> None:
    """The plain version of :func:`settle` (no while node on the CPU): the
    same writes with tensor operations, reading nothing back."""
    if mode == IN_WHILE_NODE:
        raise ValueError("the settle step sets a while node's condition on "
                         "the card only")
    nxt = torch.zeros_like(z)
    nxt[:, C:] = z[:, :z.shape[1] - C]
    flags[FLAG_DONE] = (nxt == entry).all().to(torch.int32)
    if mode == AFTER_STATE_WALK:
        flags[FLAG_WALKS] = 1
    else:
        flags[FLAG_WALKS] += 1
        flags[FLAG_AUDIO_WALKS] += 1
    entry.copy_(nxt)


def settle(z: torch.Tensor, entry: torch.Tensor, flags: torch.Tensor, C: int,
           mode: int, limit: int = 0, handle: int = 0,
           use_kernels: bool = True) -> None:
    """The settle step after a walk: ``entry`` (n_ops, C*G) int32 becomes the
    next entries (segment g+1 takes segment g's exit from ``z``, segment 0
    keeps REST) in place, and ``flags`` (int32[4], ``FLAG_*``) records
    whether they changed and counts the walk. ``mode`` is
    ``AFTER_STATE_WALK``, ``AFTER_AUDIO_WALK`` or ``IN_WHILE_NODE``; in the
    last, the kernel sets the conditional ``handle`` of the while node it is
    captured in to ``not done and walks < limit``. A CUDA tensor goes
    through ``csrc/dynamics.cu``'s settle kernel (one block), or the call
    raises."""
    global settle_launch_count
    if z.dtype != torch.int32 or z.dim() != 2 or not z.is_contiguous():
        raise ValueError(f"exit states must be a contiguous (n_ops, lanes) "
                         f"int32 tensor, got {tuple(z.shape)} {z.dtype}")
    _check_into(entry, z, "entry")
    if flags.shape != (4,) or flags.dtype != torch.int32 \
            or flags.device != z.device:
        raise ValueError(f"flags must be an int32[4] tensor on {z.device}, "
                         f"got {tuple(flags.shape)} {flags.dtype}")
    n_ops, R = z.shape
    if not 1 <= n_ops <= MAX_OPS or not 1 <= C <= R or R % C:
        raise ValueError(f"{n_ops} ops over {R} lanes of {C} channels")
    if mode not in (AFTER_STATE_WALK, AFTER_AUDIO_WALK, IN_WHILE_NODE):
        raise ValueError(f"settle mode {mode}")
    if not (z.is_cuda and use_kernels):
        settle_plain(z, entry, flags, C, mode)
        return
    fn = _build.launcher("dynamics", "dynamics_settle_launch",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                         + [ctypes.c_ulonglong, ctypes.c_void_p])
    with _build.on_device(z.device):
        err = fn(z.data_ptr(), entry.data_ptr(), flags.data_ptr(), n_ops, C,
                 R, mode, limit, handle,
                 torch.cuda.current_stream(z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dynamics settle launch failed with CUDA error "
                           f"{err} (n_ops={n_ops}, lanes={R}, C={C})")
    settle_launch_count += 1


def round_live(flags: torch.Tensor) -> bool:
    """Whether the next round is live (the JAX package's loop runs it): the
    first of the render, or one after a round that moved an entry on some
    time rank. Reads the flags back (a synchronisation on the card)."""
    moved, count = flags[:ROUND_COUNT + 1].tolist()
    return count == 0 or moved != 0


def round_step_plain(came: torch.Tensor, entry: torch.Tensor,
                     flags: torch.Tensor, first: bool) -> None:
    """The plain version of :func:`round_step`: the same writes with tensor
    operations, reading nothing back."""
    nxt = torch.zeros_like(entry) if first else came
    live = (flags[ROUND_COUNT] == 0) | (flags[ROUND_CHANGED] != 0)
    flags[ROUND_COUNT:] += live.to(torch.int32)
    flags[ROUND_CHANGED] = (nxt != entry).any().to(torch.int32)
    entry.copy_(nxt)


def _check_flags(flags: torch.Tensor, device) -> None:
    if flags.shape != (3,) or flags.dtype != torch.int32 \
            or flags.device != device:
        raise ValueError(f"round flags must be an int32[3] tensor on "
                         f"{device}, got {tuple(flags.shape)} {flags.dtype} "
                         f"on {flags.device}")


def _launch_round(came, entry, flags, first: bool, mode: int,
                  handle: int) -> None:
    global round_launch_count
    fn = _build.launcher("dynamics", "dynamics_round_launch",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                         + [ctypes.c_ulonglong, ctypes.c_void_p])
    with _build.on_device(flags.device):
        err = fn(None if came is None else came.data_ptr(),
                 None if entry is None else entry.data_ptr(),
                 flags.data_ptr(), 0 if entry is None else entry.numel(),
                 int(first), mode, handle,
                 torch.cuda.current_stream(flags.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dynamics round launch (mode {mode}) failed with "
                           f"CUDA error {err}")
    round_launch_count += 1


def round_step(came: torch.Tensor | None, entry: torch.Tensor,
               flags: torch.Tensor, first: bool,
               use_kernels: bool = True) -> None:
    """One round of the time-sharded dynamics after its walk and exchange
    (``parallel/dynspec.py``): ``entry`` (n_ops, C) int32 becomes the next
    entries in place, ``came`` (the previous time rank's exits) or REST on
    the first time rank (which takes no ``came``); ``flags`` (int32[3],
    ``ROUND_*``) counts the round where it is live (:func:`round_live`) and
    records whether an entry moved. A CUDA tensor goes through
    ``csrc/dynamics.cu``'s round kernel (one block), or the call raises."""
    if entry.dtype != torch.int32 or entry.dim() != 2 \
            or not entry.is_contiguous() or entry.numel() == 0:
        raise ValueError(f"entries must be a contiguous (n_ops, C) int32 "
                         f"tensor, got {tuple(entry.shape)} {entry.dtype}")
    _check_flags(flags, entry.device)
    if not first:
        _check_into(came, entry, "came")
    if not (entry.is_cuda and use_kernels):
        round_step_plain(came, entry, flags, first)
        return
    _launch_round(None if first else came, entry, flags, first, 0, 0)


def round_gate(flags: torch.Tensor, handle: int) -> None:
    """Inside a capture: set the conditional ``handle`` of the if node that
    holds the next round's walk (``graph_cond.if_node``) to whether the round
    is live. The card only: eagerly the caller asks :func:`round_live`."""
    if not flags.is_cuda:
        raise ValueError("the round gate sets an if node's condition on the "
                         "card: flags must be a CUDA tensor")
    _check_flags(flags, flags.device)
    _launch_round(None, None, flags, False, 1, handle)


def serial_walk_plain(scalars, x: torch.Tensor, entry: torch.Tensor):
    """The plain version of :func:`serial_walk`: :func:`walk_plain` on the
    transposed block, i.e. the audio walk's plain version at one segment
    (G = 1, L = T)."""
    out, exit_state = walk_plain(scalars, x.t(), entry, audio=True)
    return out.t().contiguous(), exit_state


def serial_geometry(T: int, lseg: int | None = None) -> tuple[int, int, int]:
    """(log2 of the segment length, segments a tile, threads a block) of the
    serial walk's kernel for a block of T samples: the segment length from
    ``SERIAL_SEGMENT_LOG2`` unless given; no more segments than a tile of
    ``SERIAL_MAX_TILE`` samples holds (a longer block is walked tile after
    tile); one thread a segment and at least ``SERIAL_MIN_THREADS`` (the
    others help to load and store the tile), in whole warps."""
    if lseg is None:
        lseg = next(v for limit, v in SERIAL_SEGMENT_LOG2
                    if limit is None or T <= limit)
    if not 0 <= lseg <= 9:
        raise ValueError(
            f"a segment of 2^{lseg} samples: the serial walk's tile holds "
            "32 segments of at most 512")
    segments = min(-(-T // (1 << lseg)), SERIAL_MAX_THREADS,
                   SERIAL_MAX_TILE >> lseg)
    threads = max(min(SERIAL_MIN_THREADS, -(-T // 32) * 32),
                  -(-segments // 32) * 32)
    return lseg, segments, threads


def _check_block(x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            "serial_walk takes a contiguous (C, T) float32 block, got "
            f"{tuple(x.shape)} {x.dtype} contiguous={x.is_contiguous()}")


def _launch_serial(scalars, x: torch.Tensor, entry: torch.Tensor,
                   lseg: int | None = None, want_rounds: bool = False,
                   out: torch.Tensor | None = None,
                   exit_state: torch.Tensor | None = None):
    """The kernel on encoded states: (out, exit) or, with ``want_rounds``,
    (out, exit, rounds (C,) int32: the walks of a segment the fixpoint loop
    took, summed over the tiles).

    ``lseg`` and ``want_rounds`` are for measurement only (chip_smoke.py's
    cases and sweeps); no wrapper passes them and the result depends on
    neither: ``lseg`` overrides the segment length."""
    global serial_walk_launch_count
    C, T = x.shape
    if out is None:
        out = torch.empty_like(x)
    if exit_state is None:
        exit_state = torch.empty_like(entry)
    rounds = torch.empty((C,), dtype=torch.int32, device=x.device) \
        if want_rounds else None
    lseg, segments, threads = serial_geometry(T, lseg)
    fn = _build.launcher("dynamics", "dynamics_serial_walk_launch",
                   [ctypes.c_void_p] * 4 + [ctypes.POINTER(_Ops)]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_void_p])
    with _build.on_device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), entry.data_ptr(),
                 exit_state.data_ptr(), ctypes.byref(_ops_table(scalars)),
                 C, T, lseg, segments, threads,
                 rounds.data_ptr() if want_rounds else None,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"dynamics serial walk launch failed with CUDA error {err} "
            f"(n_ops={len(scalars)}, C={C}, T={T}, lseg={lseg}, "
            f"segments={segments}, threads={threads})")
    serial_walk_launch_count += 1
    return (out, exit_state, rounds) if want_rounds else (out, exit_state)


def serial_walk(scalars, x: torch.Tensor, entry: torch.Tensor,
                use_kernels: bool = True, out: torch.Tensor | None = None,
                exit_state: torch.Tensor | None = None):
    """One block of a cascade, walked from carried states: x (C, T) float32
    contiguous (channel-major, as a streaming block lies) and entry
    (n_ops, C) int32 in :func:`encode_state`'s encoding -> (out (C, T), exit
    (n_ops, C)). A CUDA tensor goes through the hand-written kernel (one
    thread block a channel, the block cut into segments that settle their
    entries among themselves), or the call raises. With ``out`` /
    ``exit_state`` the results are written there (a captured loop allocates
    nothing)."""
    _check_block(x)
    C, T = x.shape
    _check_entry(scalars, C, entry, x.device)
    if out is not None:
        _check_into(out, x, "out")
    if exit_state is not None:
        _check_into(exit_state, entry, "exit_state")
    if not (x.is_cuda and use_kernels):
        y, z = serial_walk_plain(scalars, x, entry)
        return (y if out is None else out.copy_(y),
                z if exit_state is None else exit_state.copy_(z))
    if T == 0:
        return (torch.empty_like(x) if out is None else out,
                entry.clone() if exit_state is None
                else exit_state.copy_(entry))
    return _launch_serial(scalars, x, entry, out=out, exit_state=exit_state)


FIELDS = ("mode", "x", "y", "skip")


def _launch_step(scalars, states, x: torch.Tensor, batch: tuple):
    """The kernel on the 4-field states: it reads every op's mode, x, y and
    skip as they lie and writes the new ones, so a step is this one launch.
    The new int fields are views of one (n_ops * 3, ...) tensor and the skip
    bits of one (n_ops, ...) tensor, each leaf of the batch's shape."""
    global serial_walk_launch_count
    C, T = x.shape
    n_ops = len(scalars)
    carry = _Carry()
    device = x.device
    for j, st in enumerate(states):
        mode, sx, sy, skip = st["mode"], st["x"], st["y"], st["skip"]
        for name, leaf in (("mode", mode), ("x", sx), ("y", sy),
                           ("skip", skip)):
            want = torch.bool if leaf is skip else torch.int32
            if leaf.dtype != want or leaf.numel() != C \
                    or not leaf.is_contiguous() or leaf.device != device:
                raise ValueError(
                    f"the dynamics state's {name!r} of op {j} must be a "
                    f"contiguous {want} tensor of {C} elements on "
                    f"{device}, got {tuple(leaf.shape)} {leaf.dtype} on "
                    f"{leaf.device}")
        carry.mode[j] = mode.data_ptr()
        carry.x[j] = sx.data_ptr()
        carry.y[j] = sy.data_ptr()
        carry.skip[j] = skip.data_ptr()
    out = torch.empty_like(x)
    ints = torch.empty((n_ops * 3,) + batch, dtype=torch.int32,
                       device=x.device)
    skips = torch.empty((n_ops,) + batch, dtype=torch.bool, device=x.device)
    carry.ints_out = ints.data_ptr()
    carry.skip_out = skips.data_ptr()
    lseg, segments, threads = serial_geometry(T)
    fn = _build.launcher("dynamics", "dynamics_serial_step_launch",
                   [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(_Carry),
                    ctypes.POINTER(_Ops)] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    with _build.on_device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), ctypes.byref(carry),
                 ctypes.byref(_ops_table(scalars)), C, T, lseg, segments,
                 threads, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"dynamics serial step launch failed with CUDA error {err} "
            f"(n_ops={n_ops}, C={C}, T={T}, lseg={lseg}, "
            f"segments={segments}, threads={threads})")
    serial_walk_launch_count += 1
    ints, skips = ints.unbind(0), skips.unbind(0)
    return tuple({"mode": ints[3 * j], "x": ints[3 * j + 1],
                  "y": ints[3 * j + 2], "skip": skips[j]}
                 for j in range(n_ops)), out


def cascade_step(scalars, params, states, block: torch.Tensor,
                 use_kernels: bool = True):
    """The streaming step of a cascade: ``states`` (one 4-field dict per op)
    and a ``(..., B)`` block -> (new states, output block). On a CUDA tensor
    that is ONE launch of the serial walk's kernel, which reads and writes
    the four fields itself; nothing is read back to the host. The plain
    version (CPU tensors, or ``use_kernels=False``) packs the states with
    :func:`encode_state`, walks with :func:`serial_walk_plain` and unpacks
    with :func:`decode_state`."""
    batch = tuple(block.shape[:-1])
    if len(scalars) != len(states):
        raise ValueError(
            f"{len(states)} states for a cascade of {len(scalars)} ops")
    x = block.reshape(-1, block.shape[-1])
    if x.dtype != torch.float32 or not x.is_contiguous():
        x = x.to(torch.float32).contiguous()
    if x.is_cuda and use_kernels:
        if not 1 <= len(scalars) <= MAX_OPS:
            raise ValueError(
                f"a walk takes 1 to {MAX_OPS} ops, got {len(scalars)}")
        if x.numel() == 0:
            return tuple(states), x.reshape(block.shape)
        new_states, out = _launch_step(scalars, states, x, batch)
        return new_states, out.reshape(block.shape)
    entry = torch.stack([encode_state(p, st).reshape(-1)
                         for p, st in zip(params, states)])
    out, exit_state = serial_walk(scalars, x, entry, use_kernels)
    new_states = tuple(decode_state(p, exit_state[j].reshape(batch))
                       for j, p in enumerate(params))
    return new_states, out.reshape(block.shape)


# ---------------------------------------------------------------------------
# the whole stage


def dynamics_offline(params, x: torch.Tensor, segments: int | None = None,
                     use_kernels: bool = True) -> torch.Tensor:
    """Whole-signal automaton, or cascade of automatons, from REST:
    (C, T) -> (C, T). ``params`` is one DynamicsParams or a sequence of up
    to MAX_OPS; in a sequence op j+1 runs on op j's per-sample output inside
    the same walk. ``segments`` overrides the planner (the result does not
    depend on it)."""
    plist = _as_list(params)
    if x.dim() != 2:
        raise ValueError(f"dynamics_offline takes (C, T), got {tuple(x.shape)}")
    C, T = x.shape
    if C == 0 or T == 0:
        return x.to(torch.float32).clone()
    scalars = [op_scalars(p) for p in plist]
    if segments is None:
        segments = plan_segments(C, T)
    G, L, _ = relayout.geometry(C, T, segments)
    x = x.to(torch.float32).contiguous()
    in_graph = x.is_cuda and use_kernels \
        and torch.cuda.is_current_stream_capturing()
    entry = torch.zeros((len(plist), C * G), dtype=torch.int32,
                        device=x.device)
    z = torch.empty_like(entry)
    out = torch.empty_like(x)
    # a capture leaves the flags' counters to be zeroed by the capturer
    flags = torch.empty(4, dtype=torch.int32, device=x.device) if in_graph \
        else torch.zeros(4, dtype=torch.int32, device=x.device)
    limit = G + 2
    graph_cond.note_fixpoint(flags)
    state_walk(scalars, x, G, L, entry, use_kernels, exit_state=z)
    settle(z, entry, flags, C, AFTER_STATE_WALK, use_kernels=use_kernels)
    if in_graph:
        _fixpoint_in_graph(scalars, x, G, L, entry, z, out, flags, C, limit)
        return out
    while True:
        audio_walk(scalars, x, G, L, entry, use_kernels, out=out,
                   exit_state=z)
        settle(z, entry, flags, C, AFTER_AUDIO_WALK, use_kernels=use_kernels)
        done, walks = flags[:2].tolist()    # the one read-back per walk
        if done:
            return out
        if walks >= limit:
            raise RuntimeError(
                f"the dynamics entries did not settle within {limit} walks")


def _fixpoint_in_graph(scalars, x, G: int, L: int, entry, z, out, flags,
                       C: int, limit: int) -> None:
    """The audio walks and settle steps as the body of a conditional while
    node of the graph being captured (``graph_cond.while_node``): every
    buffer the body touches was made before it. The body's launches are
    data-dependent, so they are not counted here: a captured render adds
    them when it reads the flags (``graph_cond.fixpoints``)."""
    global audio_walk_launch_count, settle_launch_count
    counted = audio_walk_launch_count, settle_launch_count
    with graph_cond.while_node(x.device) as handle:
        audio_walk(scalars, x, G, L, entry, out=out, exit_state=z)
        settle(z, entry, flags, C, IN_WHILE_NODE, limit, handle)
    audio_walk_launch_count, settle_launch_count = counted


def offline_blocks(params, blocks: torch.Tensor,
                   use_kernels: bool = True) -> torch.Tensor:
    """``dynamics_offline`` on a blocked signal (..., num_blocks, block_size):
    leading axes are channels, the blocks are one timeline."""
    if blocks.dim() < 2:
        raise ValueError(
            f"dynamics takes (..., num_blocks, block_size) blocks, got "
            f"{tuple(blocks.shape)}")
    shape = blocks.shape
    x = blocks.reshape(-1, shape[-2] * shape[-1])
    return dynamics_offline(params, x, None, use_kernels).reshape(shape)


def fused_dynamics(effects) -> Effect:
    """ONE Effect running a cascade of dynamics automatons (compressor / gate
    in any order, up to MAX_OPS) in a single pass per walk: op j+1 consumes
    op j's per-sample output inside the loop, so compressor -> gate costs one
    round trip through device memory instead of two.

    Streaming is one launch per block (:func:`cascade_step`); the state is a
    tuple of the members' 4-field dicts. The walk's scalars are read
    from the params once, here."""
    members = tuple(effects)
    own_params = tuple(e.params for e in members)
    _as_list(own_params)
    own_scalars = [op_scalars(p) for p in own_params]

    def offline(params, blocks: torch.Tensor,
                use_kernels: bool = True) -> torch.Tensor:
        return offline_blocks(list(params), blocks, use_kernels)

    def step(params, state, block: torch.Tensor):
        scalars = own_scalars if params is own_params \
            else [op_scalars(p) for p in params]
        return cascade_step(scalars, params, state, block)

    def init_state(params, batch_shape: tuple[int, ...] = ()):
        return tuple(e.init_state(p, batch_shape)
                     for e, p in zip(members, params))

    name = "dynamics_cascade:" + "+".join(e.name for e in members)
    return Effect(name=name, params=own_params,
                  init_state=init_state, step=step, offline=offline,
                  time_parallel=False, device=members[0].device)
