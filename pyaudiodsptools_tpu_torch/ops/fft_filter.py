"""Windowed-sinc FFT filters (high-cut / low-cut) and the generic FIR effect.

Counterpart of ``pyaudiodsptools_tpu/ops/fft_filter.py``. A filter's
*effective impulse response* (windowed sinc at its one-block latency shift)
is built once on the host in float64 and executed by the generic ``fir``
machinery: offline runs the segmented overlap-save convolution with the
exact-zero latency prefix stripped and re-applied as a free output delay.
One code path serves the named filters and fused LTI cascades alike.

The planner is this package's own. The JAX planner sizes windows for the
TPU's matmul DFT and its (8, 128) DMA alignment; here the CUDA kernel
(``kernels/segconv.py``) gathers a window from any sample offset, and the
only hard limit is that one window of complex float32 fits the shared memory
of a thread block (16,384 points) or of a cluster of four (``MAX_WINDOW``,
65,536). A kernel too long for that window is cut into consecutive
partitions (:func:`plan_partitions`), each its own segmented convolution
with its own output delay, whose launches add into one output: a ``fir`` of
any length renders offline. Parity with the JAX package is judged on the
output, not on the geometry.

Streaming (``fir_step``) has its own window too. The JAX step keeps the full
kernel, zero prefix included, in a window of a 7-smooth number of blocks; the
port strips the prefix in streaming as it does offline and pays it back as a
delay held in the history. For the output block ``t0 .. t0+B-1`` the window
is ``x[t0+B-lead-n .. t0+B-lead-1]`` with ``n`` the smallest power of two
``>= stripped kernel length - 1 + B``: its last ``B`` outputs are wrap-free
and are the block. The state is a flat per-channel history of the last
``lead + n - B`` input samples. A step is ``kernels/convpairs.stream_step``
with one part: on a CUDA tensor ONE launch of the hand-written kernel, which
gathers the window from the history and the block, stores only the block's
output and writes the next history to a new tensor; nothing is read back to
the host.

Where that window would exceed ``STREAM_WINDOW`` (65,536) and a window of
twice the block does not (B <= 32,768), the kernel streams through a
frequency-domain delay line (``kernels/convpairs.spectral_step``, uniformly
partitioned overlap-save): the kernel, its zero lead included, cut into
partitions of B taps, each partition's spectrum at the smallest power of two
``n >= 2 B`` held on the device, and the state the spectra of the last
windows (a ring, one slot a partition; the lead's partitions are zero and
left out of the sum) with the last blocks of input and a position. A step is
ONE launch, whatever the kernel's length: the new window's transform, its
spectrum stored, the sum over the ring, the inverse transform. The step
advances the rings of the state it is given in place and returns them (the
captured step's buffers need no copy); ``Chain.step``, which leaves the
state it is given as it was, steps a copy.

Where even one tap and the block would outgrow the largest window
(B > 32,768), the stripped kernel streams in consecutive partitions
(:func:`plan_stream`), as it renders offline: each its own power-of-two
window and its own delay ``lead + offset``, one launch each, the later ones
adding into the output in order (``kernels/convpairs.stream_step``), all
reading one shared history, and the block cut into sub-blocks, one window
each. Any kernel streams at any block size.
"""

from __future__ import annotations

from functools import reduce

import numpy as np
import torch

from ..core.config import DEFAULT_DEVICE, EngineConfig, resolve_device
from ..kernels import convpairs, segconv
from .base import Effect, params_dataclass

# The largest window of both convolution kernels (a cluster of four thread
# blocks): the offline window of a kernel that needs no partitions, and the
# largest streaming window.
MAX_WINDOW = segconv.MAX_WINDOW
# The largest streaming window (the circular convolution kernel's, over a
# cluster of four): a kernel and block that need more stream in partitions.
STREAM_WINDOW = convpairs.MAX_WINDOW
# The largest window the planner gives where the 8x-halo rule asks for more
# (a halo above half of it still gets MAX_WINDOW). On an H100 at chain8's
# halo of 8,192 (block size 4096), n = 32,768 over a cluster of two blocks
# took 1.107-1.147 ms, one block at 16,384 1.203-1.247 and a cluster of four
# at 65,536 1.437-1.452 (chip_smoke.py's `segconv_versions`, PERF.md): past
# 32,768 the cluster's top pass through distributed shared memory costs more
# than the window overlap it saves.
PLANNED_WINDOW = 32768
# The planner's floor (the kernel itself takes windows from 16 samples up):
# below this a block is too small to be worth a launch slot.
MIN_WINDOW = 1024
# The halo is the stripped kernel's reach rounded up to this many samples, so
# that a window's output span starts on a 512-byte boundary of the signal.
HALO_STEP = 128


def sinc_kernel(cutoff_hz: float, sample_rate: float, filter_length: int,
                window: str = "blackman", invert: bool = False) -> np.ndarray:
    """Host-side windowed-sinc FIR construction, float64: sinc, window,
    unity-gain normalize, optional spectral inversion (lowpass -> highpass),
    in the reference's order."""
    n = np.arange(filter_length)
    h = np.sinc(2 * cutoff_hz / sample_rate * (n - (filter_length - 1) / 2))
    if window == "blackman":
        h *= np.blackman(filter_length)
    elif window == "kaiser6":
        h *= np.kaiser(filter_length, 6.0)
    else:  # pragma: no cover
        raise ValueError(f"unknown window: {window}")
    h /= np.sum(h)
    if invert:
        h = -h
        h[(filter_length - 1) // 2] += 1
    return h


def _make(cfg: EngineConfig, cutoff_hz: float, invert: bool, name: str,
          device) -> Effect:
    B = cfg.block_size
    fl = (B // 2) - 1
    kernel = sinc_kernel(cutoff_hz, cfg.sample_rate, fl, "blackman", invert)
    # Effective impulse response incl. the 1-block latency: y = conv(x, e).
    eff_kernel = np.concatenate([np.zeros(B - fl // 2), kernel])
    return fir(eff_kernel, B, name=name, device=device)


def highcut(cfg: EngineConfig, cutoff_hz: float = 8000.0,
            device=DEFAULT_DEVICE) -> Effect:
    """Lowpass ("high cut") filter."""
    return _make(cfg, cutoff_hz, invert=False, name="highcut", device=device)


def lowcut(cfg: EngineConfig, cutoff_hz: float = 160.0,
           device=DEFAULT_DEVICE) -> Effect:
    """Highpass ("low cut") filter."""
    return _make(cfg, cutoff_hz, invert=True, name="lowcut", device=device)


def _halo_for(kernel_len: int) -> int:
    return HALO_STEP * max(1, -(-(kernel_len - 1) // HALO_STEP))


def plan_segments(kernel_len: int) -> tuple[int, int]:
    """(halo, seg) in samples for a kernel of this length, which must fit
    one window (:func:`fits_window`; longer kernels are cut by
    :func:`plan_partitions`).

    ``halo >= kernel_len - 1`` covers the kernel; the window
    ``n = halo + seg`` is a power of two, at least 8x the halo where
    ``PLANNED_WINDOW`` allows (wasted window fraction <= 1/8), at least 2x
    the halo, and never more than ``MAX_WINDOW``. The window picks the
    kernel's version (``segconv.blocks_for``): one thread block up to 16,384
    points, a cluster of two at 32,768, of four at 65,536."""
    halo = _halo_for(kernel_len)
    if 2 * halo > MAX_WINDOW:
        raise ValueError(
            f"a {kernel_len}-tap kernel needs a halo of {halo} samples, more "
            f"than half of the largest window ({MAX_WINDOW}): it is cut into "
            "partitions (plan_partitions)")
    n = MIN_WINDOW
    while (n < 8 * halo and n < PLANNED_WINDOW) or n < 2 * halo:
        n *= 2
    return halo, n - halo


def fits_window(kernel_len: int) -> bool:
    """Whether a stripped kernel of this length keeps its halo within half
    of ``MAX_WINDOW``: one segmented convolution takes it whole."""
    return 2 * _halo_for(kernel_len) <= MAX_WINDOW


# The taps of one partition of a kernel too long for one window: the halo of
# PLANNED_WINDOW / 2 that a window of PLANNED_WINDOW (the fastest on an H100,
# see above) keeps. For a fixed window the cost of a kernel of K taps goes as
# (K / taps a partition) x (windows a partition), i.e. as
# 1 / (halo * (n - halo)), least at halo = n / 2.
PARTITION_TAPS = PLANNED_WINDOW // 2 + 1


def plan_partitions(kernel_len: int) -> list[tuple[int, int, int, int]]:
    """(offset, taps, halo, seg) of each partition of a stripped kernel of
    this length: one partition, the whole kernel at :func:`plan_segments`'s
    window, where it fits one window; else consecutive slices of
    ``PARTITION_TAPS`` taps (the last one shorter), each at the window
    :func:`plan_segments` gives its length. Partition p convolves with
    ``kernel[offset : offset + taps]`` and delays its output by ``offset``
    more samples; the outputs are summed in order."""
    if fits_window(kernel_len):
        return [(0, kernel_len, *plan_segments(kernel_len))]
    return [(o, min(PARTITION_TAPS, kernel_len - o),
             *plan_segments(min(PARTITION_TAPS, kernel_len - o)))
            for o in range(0, kernel_len, PARTITION_TAPS)]


def stream_window(kernel_len: int, block_size: int) -> int:
    """Samples in the streaming window of a stripped kernel of this length:
    the smallest power of two that leaves ``block_size`` wrap-free outputs
    (0 where that would exceed ``STREAM_WINDOW``: such a kernel streams in
    partitions, :func:`plan_stream`)."""
    n = segconv.MIN_WINDOW
    while n < kernel_len - 1 + block_size:
        n *= 2
    return n if n <= STREAM_WINDOW else 0


def plan_stream(kernel_len: int, block_size: int
                ) -> tuple[int, list[tuple[int, int, int]]]:
    """(sub-block, [(offset, taps, n), ...]) of the streaming step of a
    stripped kernel of this length: the block is cut into sub-blocks of at
    most ``sub`` samples and the kernel into consecutive partitions of at
    most ``STREAM_WINDOW - sub + 1`` taps, so that each partition's window of
    ``n`` (the smallest power of two >= taps - 1 + sub) is at most
    ``STREAM_WINDOW``, with as few launches (partitions x sub-blocks) as that
    allows, the fewest sub-blocks among equals. One partition and the whole
    block where the kernel fits one window: :func:`stream_window`'s window,
    one launch. The partitions take the most taps each in order; the last
    has what is left, at its own smaller window."""
    # S sub-blocks cost at least S launches, so the search ends at the
    # first S that cannot beat the best count so far.
    S = -(-block_size // STREAM_WINDOW)
    best = None
    while best is None or S < best[0]:
        sub = -(-block_size // S)
        per = STREAM_WINDOW - sub + 1
        launches = -(-kernel_len // per) * S
        if best is None or launches < best[0]:
            best = (launches, sub, per)
        S += 1
    _, sub, per = best
    return sub, [(o, min(per, kernel_len - o),
                  stream_window(min(per, kernel_len - o), sub))
                 for o in range(0, kernel_len, per)]


def segmented_fft_conv(params: "FIRParams", blocks: torch.Tensor,
                       use_kernels: bool = True) -> torch.Tensor:
    """Linear convolution + output delay via large-segment overlap-save:
    ``out[m] = conv(x, h)[m - lead]`` per channel, on the flattened
    ``(..., nb*B)`` signal, one segmented convolution per partition of the
    kernel. Both block sizes flatten to the same (C, T) for the kernel; only
    the filter design depends on B."""
    shape = blocks.shape
    T = shape[-2] * shape[-1]
    x = blocks.reshape(-1, T).contiguous()
    y = segconv.partitioned_conv(x, params.plans, use_kernels=use_kernels)
    return y.reshape(shape)


# ---------------------------------------------------------------------------
# Generic FIR effect from an arbitrary kernel.
# ---------------------------------------------------------------------------


@params_dataclass(meta_fields=("block_size", "lead", "kernel_len",
                               "history"))
class FIRParams:
    plans: tuple[segconv.ConvPlan, ...]   # one per partition of the kernel
                             # (plan_partitions; one where it fits a
                             # window): spectra and twiddles on device + the
                             # window's geometry (n, halo, seg, shift,
                             # kernel_len)
    parts: tuple[convpairs.StreamPart, ...]   # the step's launches
                             # (plan_stream): one, or partitions x
                             # sub-blocks, the first partition first; none
                             # where the delay line streams the kernel
    spectral: convpairs.SpectralPlan | None   # the frequency-domain delay
                             # line (a kernel past one window, a block
                             # within half of one), else None
    block_size: int          # ENGINE block size
    lead: int                # stripped zero prefix, re-applied as delay
    kernel_len: int          # taps of the stripped kernel
    history: int             # samples of input a stream keeps per
                             # channel (0: the delay line keeps its own)

    @property
    def stream(self) -> convpairs.PairsPlan:
        """The first streaming window's tables (n, spectra, twiddles): the
        only one where the kernel streams in one window."""
        return self.parts[0].plan


def streams_spectrally(kernel_len: int, block_size: int) -> bool:
    """Whether a stripped kernel of this length streams at this block size
    through the frequency-domain delay line: where :func:`plan_stream` needs
    more than one launch and a window of twice the block fits
    ``STREAM_WINDOW``."""
    sub, pieces = plan_stream(kernel_len, block_size)
    return len(pieces) * -(-block_size // sub) > 1 \
        and convpairs.spectral_window(block_size) <= STREAM_WINDOW


def fir(kernel: np.ndarray, block_size: int, name: str = "fir",
        device=DEFAULT_DEVICE) -> Effect:
    """An Effect computing ``y = conv(x, kernel)`` (causal, zero-latency
    beyond what the kernel itself encodes): offline through the segmented
    overlap-save path (in partitions where the kernel is longer than one
    window takes), streaming through one circular convolution of a
    power-of-two window per block where the kernel and the block fit
    ``STREAM_WINDOW``, else through the frequency-domain delay line
    (:func:`streams_spectrally`), else in partitions. Fused cascades carry a
    long EXACT-ZERO prefix (each member's latency shift): it is stripped and
    re-applied as a free output delay, which shrinks the halo by the prefix
    length (the delay line keeps it: its zero partitions cost nothing)."""
    dev = resolve_device(device)
    kernel = np.asarray(kernel, dtype=np.float64)
    nz = np.flatnonzero(kernel)
    lead = int(nz[0]) if nz.size else 0
    stripped = kernel[lead:] if nz.size else kernel[:1]
    plans = tuple(
        segconv.make_plan(stripped[o:o + taps], halo, seg, lead + o, dev)
        for o, taps, halo, seg in plan_partitions(len(stripped)))
    spectral, parts, history = None, [], 0
    if streams_spectrally(len(stripped), block_size):
        spectral = convpairs.make_spectral_plan(kernel, block_size, dev)
    else:
        sub, pieces = plan_stream(len(stripped), block_size)
        # the history reaches back to the oldest sample of the first
        # sub-block's windows
        history = max(lead + o + n for o, _, n in pieces) - sub
        for p, (o, taps, n) in enumerate(pieces):
            plan = convpairs.make_plan(stripped[o:o + taps], n, dev)
            for s0 in range(0, block_size, sub):
                keep = min(sub, block_size - s0)
                parts.append(convpairs.StreamPart(
                    plan, history + s0 + keep - (lead + o) - n, s0, keep,
                    p > 0))
    params = FIRParams(plans=plans, parts=tuple(parts), spectral=spectral,
                       block_size=block_size, lead=lead,
                       kernel_len=len(stripped), history=history)
    return Effect(name=name, params=params, init_state=fir_init_state,
                  step=fir_step, offline=fir_offline,
                  lti_kernel=kernel, device=dev, reach=len(kernel) - 1)


def history_len(params: FIRParams) -> int:
    """Samples of input a streaming FIR keeps per channel in its history
    (0 where the delay line streams it: :func:`spectral_state_from_history`
    builds that state from a history)."""
    return params.history


def fir_init_state(params: FIRParams, batch_shape: tuple[int, ...] = ()):
    """Silence on the plan's device: ``{"hist": (..., history)}``, or the
    delay line's rings and position (``{"input": (..., T, B), "pos": (),
    "ring": (S, pairs, n, 2)}``, ``convpairs.spectral_init_state``)."""
    device = params.plans[0].twiddle.device
    if params.spectral is not None:
        return convpairs.spectral_init_state(params.spectral, batch_shape,
                                             device)
    return {"hist": torch.zeros(
        tuple(batch_shape) + (params.history,), dtype=torch.float32,
        device=device)}


def spectral_state_from_history(params: FIRParams, hist: np.ndarray):
    """The delay line's state after the input whose last samples are
    ``hist`` (..., L) (a longer history is cut to what the ring reaches, a
    shorter one taken as silence before it): each ring slot the spectrum of
    its window, in float64 rounded to float32, the position 0."""
    plan = params.spectral
    n, B, S = plan.n, plan.block, plan.slots
    batch = hist.shape[:-1]
    rows = int(np.prod(batch, dtype=np.int64))
    # the windows of the last S - 1 blocks: (S - 2) B + n samples
    need = (S - 2) * B + n
    flat = np.asarray(hist, dtype=np.float64).reshape(rows, -1)
    flat = flat[:, max(flat.shape[-1] - need, 0):]
    flat = np.pad(flat, [(0, rows % 2), (need - flat.shape[-1], 0)])
    z = flat[0::2] + 1j * flat[1::2]
    ring = np.zeros((S, (rows + 1) // 2, n), dtype=np.complex128)
    order = segconv.dif_positions(n)
    for p in range(1, S):
        # the window that ends p - 1 blocks before the end, in slot -p
        end = need - (p - 1) * B
        ring[S - p][:, order] = np.fft.fft(z[:, end - n:end], axis=-1)
    state = convpairs.spectral_init_state(plan, batch, "cpu")
    state["ring"] = torch.from_numpy(np.stack(
        [ring.real, ring.imag], axis=-1).astype(np.float32))
    blocks = flat[:rows, need - (plan.inputs - 1) * B:].reshape(
        batch + (plan.inputs - 1, B))
    # the last block in slot -1, the one before in slot -2, ...: at
    # position 0 slot T - d holds the block d steps back
    state["input"][..., 1:, :] = torch.from_numpy(blocks.astype(np.float32))
    return state


def fir_step(params: FIRParams, state, block: torch.Tensor,
             use_kernels: bool = True):
    """One block: the window is the first ``n`` samples of history + block
    (the last ``lead`` samples wait in the history: the output delay), the
    block's output is the window's last ``B`` (wrap-free) samples, and the
    next history is a new tensor (the old state stays valid). All of it is
    ``kernels/convpairs.stream_step`` on the plan's parts: one launch a part
    on a CUDA tensor, so one launch where the kernel fits one window.
    Through the delay line (``params.spectral``) it is
    ``kernels/convpairs.spectral_step``, one launch, and the state's rings
    ADVANCE IN PLACE: the new state holds the same ring tensors (a caller
    that keeps the old state steps a copy, as ``Chain.step`` does)."""
    B = block.shape[-1]
    if B != params.block_size:
        raise ValueError(
            f"this FIR streams blocks of {params.block_size} samples, got "
            f"{B}")
    if params.spectral is not None:
        return _spectral_step(params.spectral, state, block, use_kernels)
    hist = state["hist"]
    flat_hist = hist.reshape(-1, hist.shape[-1]).contiguous()
    flat = block.to(torch.float32).reshape(-1, B)
    out, new_hist = convpairs.stream_step(flat_hist, flat, params.parts,
                                          use_kernels)
    return {"hist": new_hist.reshape(hist.shape)}, out.reshape(block.shape)


def _spectral_step(plan: convpairs.SpectralPlan, state, block: torch.Tensor,
                   use_kernels: bool):
    ring, inputs = state["ring"], state["input"]
    B = block.shape[-1]
    flat = block.to(torch.float32).reshape(-1, B)
    out, pos = convpairs.spectral_step(
        ring, inputs.view(flat.shape[0], plan.inputs, B), state["pos"], flat,
        plan, use_kernels)
    return {"input": inputs, "pos": pos, "ring": ring}, \
        out.reshape(block.shape)


def fir_offline(params: FIRParams, blocks: torch.Tensor,
                use_kernels: bool = True) -> torch.Tensor:
    return segmented_fft_conv(params, blocks, use_kernels)


def fuse_lti(effects, name: str = "fir_cascade") -> Effect:
    """Fuse consecutive LTI effects into one FIR: the cascade's impulse
    response is the convolution of the members' effective kernels (built in
    float64 on the host)."""
    kernel = fused_kernel(effects)
    B = getattr(effects[0].params, "block_size")
    return fir(kernel, B, name=name + ":" + "+".join(e.name for e in effects),
               device=effects[0].device)


def fused_kernel(effects) -> np.ndarray:
    return reduce(np.convolve,
                  [np.asarray(e.lti_kernel, dtype=np.float64) for e in effects])
