"""Circular convolution of real rows: wrapper, plain version and plan.

Replaces the TPU kernel ``pyaudiodsptools_tpu/kernels/pallas_conv.py ::
conv_pairs_fused`` (body ``_kernel``), the streaming windows' convolution.
It computes what that kernel computes, for a (R, n) float32 array and a real
kernel's spectrum H:

    out[r] = irfft(rfft(flat[r]) * H, n)

the whole circular convolution of every row (the caller keeps the wrap-free
samples). Rows go through the transform two at a time, as the real and
imaginary parts of one complex signal; an odd last row rides alone.

What bounds it on an H100: by bytes one read and one write of the rows. In
the streaming step that is 64 rows of 2,048 or 16,384 samples, a launch that
is over before the card is full, so its time is the latency of ONE pair's
passes through shared memory: latency, not bytes or FLOPs. At a batch that
fills the card it is bound by the shared-memory passes, as the segmented
convolution is. The design shares that kernel's transform
(``csrc/window_fft.cuh``: window resident in shared memory from load to
store, two radix-4 levels per pass, the spectrum in the forward transform's
output order, no reorder pass) and its host tables
(``segconv.pass_twiddles``, ``segconv.spectrum_tables``). A window pair goes
over a thread-block cluster of 2 or 4 blocks (:func:`blocks_for`), each
holding its part of the window and the top pass exchanging through
distributed shared memory: against the latency, the largest one-block window
at a step's batch; and every window no block holds, 32,768 and 65,536
points (``MAX_WINDOW``), which a stream at a block size of 16,384 or a
filter of tens of thousands of taps needs. All versions agree bit for bit.
Rows may be a strided view (``flat.stride(0) >= n``, unit stride along a
row).

:func:`stream_step` is a streaming FIR's step: one launch of the same kernel
a part (:class:`StreamPart`), each window gathered from the shared history
and the block as they lie, only the block's (wrap-free) output stored, the
later partitions of a long kernel adding into it (the kernel's accumulate
mode), and the next history written to a new tensor by the blocks that run
beside the transforming ones of the part whose window starts at the
history's first sample. :func:`conv_pairs_step` is its one-part case: a FIR
that fits one window, ONE launch a step.

:func:`spectral_step` is the step of a FIR longer than one window whose
blocks fit half of one (``ops/fft_filter.fir`` routes it there): a
frequency-domain delay line (:class:`SpectralPlan`), the kernel cut into
partitions of B taps, the spectra of the last windows kept in a ring in the
state; ONE launch of the same kernel a step (another mode of it), whatever
the kernel's length, with both rings written in place.

The CUDA source is ``csrc/convpairs.cu``. The plain versions,
:func:`conv_pairs_plain` (the same function on ``torch.fft``),
:func:`stream_step_plain` (join, convolve, slice, and add in order), run for
CPU tensors,
or on request (``use_kernels=False``), and are never a fallback for a CUDA
tensor; :func:`spectral_step_plain` runs for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import profiling
from . import _build, segconv

# Number of kernel launches made by :func:`conv_pairs`,
# :func:`conv_pairs_step` and :func:`stream_step` (and by nothing else) since
# the caller last set it to 0.
launch_count = 0
# Of those, the launches in the accumulate mode (a :class:`StreamPart` with
# ``add``: every partition of :func:`stream_step` after the first).
accumulate_launch_count = 0
# Of those, the launches of :func:`spectral_step` (the frequency-domain delay
# line).
spectral_launch_count = 0

# csrc/convpairs.cu spreads a pair of rows over 1, 2 or 4 thread blocks, all
# bit-equal to each other. Up to one block's 16,384 points the cluster of four
# goes where it was measured ahead by more than a launch's noise: the largest
# window at a streaming step's batch. On an H100 at 16,384 samples it is ahead
# by a quarter at 64 rows and by a fifth at 80, 96 and 112, behind by a fifth
# at 128 and by more than a third at the batch that fills the card; at the
# smaller windows it gains 1-3 us at 64 rows. chip_smoke.py times the
# versions (`conv_pairs_cluster_by_window`, `versions_ms_by_rows`; PERF.md has
# the tables). The windows no block holds go over a cluster of four at that
# batch too (at 64 rows of 32,768 four blocks of 8,192 took 0.038 ms, two of
# 16,384 0.042 on an H100), else over the clusters of the segmented
# convolution, 32,768 over two and 65,536 over four blocks of 16,384
# (segconv.CLUSTER_AT).
CLUSTER_WINDOW = 16384
CLUSTER_MAX_ROWS = 112
MAX_WINDOW = segconv.MAX_WINDOW
# The smallest window a cluster takes (each block keeps whole passes).
CLUSTER_MIN_WINDOW = 1024


@dataclasses.dataclass(frozen=True)
class PairsPlan:
    """Device tables of one real kernel for n-point circular convolution."""

    n: int
    kernel_len: int
    spectrum_rfft: torch.Tensor   # (n//2+1,) complex64: plain version
    spectrum_dif: torch.Tensor    # (n, 2) f32: full spectrum / n, in the
                                  # forward DIF's output order: CUDA kernel
    twiddle: torch.Tensor         # (L, 2) f32: per-pass twiddle rows


def make_plan(kernel: np.ndarray, n: int, device) -> PairsPlan:
    """The plan of a real float64 ``kernel`` of at most ``n`` taps. Window
    sizes the kernel does not take raise, with the size in the message."""
    kernel = np.asarray(kernel, dtype=np.float64)
    segconv.check_window(n, MAX_WINDOW)
    if kernel.ndim != 1 or not 1 <= len(kernel) <= n:
        raise ValueError(
            f"a kernel of shape {kernel.shape} does not fit a circular "
            f"convolution of {n} points")
    device = torch.device(device)
    spectrum_rfft, spectrum_dif = segconv.spectrum_tables(kernel, n, device)
    return PairsPlan(n=n, kernel_len=len(kernel),
                     spectrum_rfft=spectrum_rfft, spectrum_dif=spectrum_dif,
                     twiddle=segconv.pass_twiddles(n, device))


def conv_pairs_plain(flat: torch.Tensor, plan: PairsPlan) -> torch.Tensor:
    """The plain PyTorch version: ``irfft(rfft(flat) * H)``."""
    out = torch.fft.irfft(torch.fft.rfft(flat, dim=-1) * plan.spectrum_rfft,
                          n=plan.n, dim=-1)
    return out.to(torch.float32)


def blocks_for(n: int, R: int) -> int:
    """Thread blocks a pair of (R, n) rows takes: a cluster of four from
    CLUSTER_WINDOW on up to CLUSTER_MAX_ROWS rows, else the cluster of the
    segmented convolution where one block does not hold the window, else
    one."""
    if n >= CLUSTER_WINDOW and R <= CLUSTER_MAX_ROWS:
        return 4
    return segconv.CLUSTER_AT.get(n, 1)


def versions(n: int) -> list[int]:
    """Every count of thread blocks (1, 2, 4) over which the kernel can
    spread a pair of rows of n samples."""
    return [b for b in (1, 2, 4) if n // b <= segconv.BLOCK_WINDOW
            and (b == 1 or n >= CLUSTER_MIN_WINDOW)]


def _check_plan(plan: PairsPlan, device) -> None:
    segconv.check_window(plan.n, MAX_WINDOW)
    segconv.check_tables(plan.n, plan.spectrum_dif, plan.twiddle, device)


def _check_blocks(n: int, blocks: int) -> None:
    if blocks not in versions(n):
        raise ValueError(
            f"a window of {n} samples does not go over {blocks} thread "
            "blocks")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"convpairs kernel launch failed with CUDA error {err} ({what})")


def _launch(flat: torch.Tensor, plan: PairsPlan,
            blocks: int | None = None) -> torch.Tensor:
    """The kernel on checked rows. ``blocks`` (thread blocks a pair, one of
    :func:`versions`) forces one version of it: for measurement only
    (chip_smoke.py times them side by side); no wrapper passes it."""
    global launch_count
    _check_plan(plan, flat.device)
    R = flat.shape[0]
    out = torch.empty((R, plan.n), dtype=torch.float32, device=flat.device)
    if flat.stride(1) != 1 or (R > 1 and flat.stride(0) < plan.n):
        raise ValueError(
            "conv_pairs takes rows with unit stride, at least n apart, got "
            f"strides {flat.stride()} for n={plan.n}")
    blocks = blocks_for(plan.n, R) if blocks is None else blocks
    _check_blocks(plan.n, blocks)
    fn = _build.launcher("convpairs", "convpairs_launch",
                   [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_void_p])
    with _build.on_device(flat.device):
        err = fn(flat.data_ptr(), out.data_ptr(), plan.spectrum_dif.data_ptr(),
                 plan.twiddle.data_ptr(), R, plan.n,
                 flat.stride(0) if R > 1 else plan.n, blocks,
                 torch.cuda.current_stream(flat.device).cuda_stream)
    _raise_on(err, f"R={R}, n={plan.n}, blocks={blocks}")
    launch_count += 1
    return out


def conv_pairs(flat: torch.Tensor, plan: PairsPlan,
               use_kernels: bool = True) -> torch.Tensor:
    """Circular convolution of every row of ``flat`` (R, n) float32 with the
    plan's kernel: (R, n) contiguous float32.

    A CUDA tensor goes through the hand-written kernel, or the call raises.
    The plain version runs for a CPU tensor, or when ``use_kernels`` is
    False."""
    if flat.dtype != torch.float32 or flat.dim() != 2 \
            or flat.shape[1] != plan.n:
        raise ValueError(
            f"conv_pairs takes a (R, {plan.n}) float32 tensor, got "
            f"{tuple(flat.shape)} {flat.dtype}")
    if flat.shape[0] == 0:
        return torch.empty_like(flat)
    if flat.is_cuda and use_kernels:
        return _launch(flat, plan)
    return conv_pairs_plain(flat, plan)


# ---------------------------------------------------------------------------
# the streaming step


@dataclasses.dataclass(frozen=True)
class StreamPart:
    """One launch of a streaming step: the window of ``plan.n`` samples of
    ``concat(history, block)`` from sample ``start`` on yields its last
    ``keep`` (wrap-free) samples as the block's outputs ``out0 ..
    out0 + keep - 1``, written there, or added to what an earlier part wrote
    (``add``: the partitions of a kernel longer than one window takes, summed
    in order)."""

    plan: PairsPlan
    start: int
    out0: int
    keep: int
    add: bool


def _launch_part(hist: torch.Tensor, block: torch.Tensor, out: torch.Tensor,
                 part: StreamPart, new_hist: torch.Tensor | None,
                 blocks: int | None = None) -> None:
    """One part's launch on checked tensors: ``hist`` (R, H) contiguous,
    ``block`` (R, B) with unit stride along a row, ``out`` (R, B)
    contiguous; ``new_hist`` (R, H), written as ``concat(hist, block)[B:]``
    by this launch (its window must start at 0), or None. ``blocks`` as in
    :func:`_launch`, for measurement only."""
    global launch_count, accumulate_launch_count
    plan = part.plan
    _check_plan(plan, hist.device)
    R, H = hist.shape
    B = block.shape[1]
    blocks = blocks_for(plan.n, R) if blocks is None else blocks
    _check_blocks(plan.n, blocks)
    st = part.start
    if st < H:
        a_ptr, split, b_ptr = hist.data_ptr() + 4 * st, H - st, \
            block.data_ptr()
    else:
        a_ptr = b_ptr = block.data_ptr() + 4 * (st - H)
        split = 0
    fn = _build.launcher("convpairs", "convpairs_step_launch",
                   [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                    ctypes.c_longlong] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    with _build.on_device(hist.device):
        err = fn(a_ptr, H, split, b_ptr, block.stride(0) if R > 1 else B,
                 out.data_ptr() + 4 * part.out0, B, part.keep, int(part.add),
                 None if new_hist is None else new_hist.data_ptr(), H, B,
                 plan.spectrum_dif.data_ptr(), plan.twiddle.data_ptr(), R,
                 plan.n, blocks,
                 torch.cuda.current_stream(hist.device).cuda_stream)
    _raise_on(err, f"step: R={R}, n={plan.n}, history={H}, B={B}, "
                   f"start={st}, keep={part.keep}, blocks={blocks}")
    launch_count += 1
    if part.add:
        accumulate_launch_count += 1


def _launch_step(hist: torch.Tensor, block: torch.Tensor, plan: PairsPlan,
                 blocks: int | None = None):
    """The one-window step's kernel on checked tensors; ``blocks`` as in
    :func:`_launch`, for measurement only."""
    R, B = block.shape
    out = torch.empty((R, B), dtype=torch.float32, device=hist.device)
    new_hist = torch.empty_like(hist)
    _launch_part(hist, block, out, StreamPart(plan, 0, 0, B, False),
                 new_hist, blocks)
    return out, new_hist


def _check_step_tensors(hist: torch.Tensor, block: torch.Tensor, H: int,
                        n: int) -> None:
    if block.dim() != 2 or not 1 <= block.shape[1] <= n:
        raise ValueError(
            f"conv_pairs_step takes a (R, B) block with 1 <= B <= {n}, got "
            f"{tuple(block.shape)}")
    R, B = block.shape
    if block.dtype != torch.float32 or block.stride(1) != 1 \
            or (R > 1 and block.stride(0) < B):
        raise ValueError(
            "conv_pairs_step takes a float32 block whose rows have unit "
            f"stride and do not overlap, got {block.dtype} with strides "
            f"{block.stride()}")
    if hist.dtype != torch.float32 or tuple(hist.shape) != (R, H) \
            or not hist.is_contiguous() or hist.device != block.device:
        raise ValueError(
            f"conv_pairs_step takes a contiguous ({R}, {H}) float32 history "
            f"on {block.device}, got {tuple(hist.shape)} {hist.dtype} on "
            f"{hist.device} contiguous={hist.is_contiguous()}")


def conv_pairs_step(hist: torch.Tensor, block: torch.Tensor, plan: PairsPlan,
                    lead: int, use_kernels: bool = True):
    """One streaming step of a FIR whose zero prefix of ``lead`` samples was
    stripped: ``hist`` (R, lead + n - B), contiguous, and ``block`` (R, B),
    unit stride along a row (a slice of a longer signal is taken as it lies),
    both float32 -> (the block's output (R, B), the next history
    (R, lead + n - B)), both contiguous.

    Row r's window is the first n samples of ``concat(hist[r], block[r])``
    (the last ``lead`` wait in the history: the output delay); the output is
    the last B (wrap-free) samples of its circular convolution and the next
    history is ``concat(hist[r], block[r])[B:]``, a new tensor: ``hist`` is
    left as it was. On a CUDA tensor all of that is ONE launch of the
    hand-written kernel (window gathered from the two tensors, only the kept
    samples stored), bit-equal to :func:`conv_pairs` on the same window, or
    the call raises (:func:`stream_step` with one part)."""
    n = plan.n
    if lead < 0:
        raise ValueError(f"lead must not be negative, got {lead}")
    _check_step_tensors(hist, block, lead + n - block.shape[-1], n)
    return stream_step(hist, block,
                       (StreamPart(plan, 0, 0, block.shape[-1], False),),
                       use_kernels)


def stream_step_plain(hist: torch.Tensor, block: torch.Tensor, parts):
    """The plain PyTorch version of :func:`stream_step`: join, convolve each
    part's window, write or add its kept samples in order."""
    R, B = block.shape
    joined = torch.cat([hist, block], dim=-1)
    out = torch.empty((R, B), dtype=torch.float32, device=block.device)
    for part in parts:
        n = part.plan.n
        y = conv_pairs_plain(joined[:, part.start:part.start + n],
                             part.plan)[:, n - part.keep:]
        dst = out[:, part.out0:part.out0 + part.keep]
        if part.add:
            dst += y
        else:
            dst.copy_(y)
    return out, joined[:, B:].contiguous()


def stream_step(hist: torch.Tensor, block: torch.Tensor, parts,
                use_kernels: bool = True):
    """One streaming step of a FIR cut into several windows (``parts``, a
    sequence of :class:`StreamPart`, ``ops/fft_filter.plan_stream`` builds
    them): ``hist`` (R, H) contiguous and ``block`` (R, B), both float32 ->
    (the block's output (R, B), the next history ``concat(hist, block)[B:]``
    (R, H)), both contiguous, the old history left as it was. On a CUDA
    tensor each part is ONE launch of the hand-written kernel, in order (the
    later partitions in its accumulate mode), and the first part whose window
    starts at sample 0 also writes the next history; or the call raises. In
    a graph captured with tracing on, a stage mark lies between two parts
    (``profiling.part``)."""
    H = hist.shape[-1]
    n = max(p.plan.n for p in parts)
    _check_step_tensors(hist, block, H, n)
    R, B = block.shape
    for p in parts:
        if p.start < 0 or p.start + p.plan.n > H + B or not \
                1 <= p.keep <= p.plan.n or p.out0 < 0 or p.out0 + p.keep > B:
            raise ValueError(
                f"a part of {p.plan.n} samples from {p.start}, keeping "
                f"{p.keep} at {p.out0}, does not fit a history of {H} and "
                f"a block of {B}")
    writer = next((k for k, p in enumerate(parts) if p.start == 0), None)
    if writer is None:
        raise ValueError("no part's window starts at the history's first "
                         "sample: none can write the next history")
    if R == 0:
        return block.new_empty((0, B)), torch.empty_like(hist)
    if not (block.is_cuda and use_kernels):
        return stream_step_plain(hist, block, parts)
    out = torch.empty((R, B), dtype=torch.float32, device=hist.device)
    new_hist = torch.empty_like(hist)
    for k, part in enumerate(parts):
        if k:
            profiling.part(hist.device)
        _launch_part(hist, block, out, part,
                     new_hist if k == writer else None)
    return out, new_hist


# ---------------------------------------------------------------------------
# the frequency-domain delay line

# Thread blocks a row pair of the delay line takes besides its window's
# (csrc/convpairs.cu's SPECTRAL_BLOCKS): the multiply-accumulate reads every
# stored spectrum once, S x n points a pair (33.8 MB a step at 64 rows in
# reverb_live), and four blocks a pair, each summing a quarter of the
# spectrum beside the block that transforms, spread those reads over four
# times the pairs' SMs. Past one block's 16,384 points the window itself
# goes over a cluster of four, each block summing the quarter it holds.
SPECTRAL_BLOCKS = 4


@dataclasses.dataclass(frozen=True)
class SpectralPlan:
    """Device tables of a FIR streamed through a frequency-domain delay
    line: the kernel (its zero lead included) cut into partitions of
    ``block`` taps, partition p delayed by p blocks, each used (not wholly
    zero) partition's ``n``-point spectrum, ``n`` the smallest power of two
    >= 2 x ``block``. The state (:func:`spectral_init_state`) keeps the
    spectra of the last ``slots`` windows and the last ``inputs`` blocks."""

    n: int
    block: int                  # B: the block size and a partition's taps
    kernel_len: int             # taps, the lead included
    slots: int                  # S: the last used partition's delay + 1
    inputs: int                 # T: blocks the window reaches back, + 1
    delays: tuple[int, ...]     # each used partition's delay in blocks
    delay_table: torch.Tensor   # the same, (U,) int32 on the device
    spectra: torch.Tensor       # (U, n, 2) f32: each used partition's full
                                # spectrum / n in the forward DIF's output
                                # order (``PairsPlan.spectrum_dif``'s form)
    twiddle: torch.Tensor       # (L, 2) f32: per-pass twiddle rows

    @property
    def period(self) -> int:
        """The position's period: a whole number of turns of both rings."""
        return self.slots * self.inputs


def spectral_window(block: int) -> int:
    """The delay line's window for blocks of ``block`` samples: the
    smallest power of two >= 2 x ``block`` (16 at least)."""
    n = segconv.MIN_WINDOW
    while n < 2 * block:
        n *= 2
    return n


def make_spectral_plan(kernel: np.ndarray, block: int,
                       device) -> SpectralPlan:
    """The delay line of a real float64 ``kernel`` (its zero lead kept: the
    lead's partitions are zero and left out) streamed in blocks of
    ``block`` samples."""
    kernel = np.asarray(kernel, dtype=np.float64)
    n = spectral_window(block)
    segconv.check_window(n, MAX_WINDOW)
    if kernel.ndim != 1 or not np.any(kernel):
        raise ValueError("a delay line takes a 1-d kernel with a nonzero tap")
    device = torch.device(device)
    pieces = [kernel[o:o + block] for o in range(0, len(kernel), block)]
    delays = tuple(p for p, piece in enumerate(pieces) if np.any(piece))
    spectra = torch.stack([segconv.spectrum_tables(pieces[p], n, device)[1]
                           for p in delays])
    return SpectralPlan(
        n=n, block=block, kernel_len=len(kernel), slots=delays[-1] + 1,
        inputs=-(-(n - block) // block) + 1, delays=delays,
        delay_table=torch.tensor(delays, dtype=torch.int32, device=device),
        spectra=spectra, twiddle=segconv.pass_twiddles(n, device))


def spectral_init_state(plan: SpectralPlan, batch_shape: tuple[int, ...],
                        device) -> dict:
    """Silence for rows of ``batch_shape``: ``{"input": (..., T, B), "pos":
    () int32, "ring": (S, pairs, n, 2)}``, pairs = ceil(rows / 2)."""
    rows = int(np.prod(batch_shape, dtype=np.int64))
    return {"input": torch.zeros(tuple(batch_shape) + (plan.inputs,
                                                        plan.block),
                                 dtype=torch.float32, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device),
            "ring": torch.zeros((plan.slots, (rows + 1) // 2, plan.n, 2),
                                dtype=torch.float32, device=device)}


def _check_spectral(ring: torch.Tensor, inputs: torch.Tensor,
                    pos: torch.Tensor, block: torch.Tensor,
                    plan: SpectralPlan) -> None:
    if block.dim() != 2 or block.shape[1] != plan.block \
            or block.dtype != torch.float32 or block.stride(1) != 1 \
            or (block.shape[0] > 1 and block.stride(0) < plan.block):
        raise ValueError(
            f"spectral_step takes a (R, {plan.block}) float32 block whose "
            f"rows have unit stride and do not overlap, got "
            f"{tuple(block.shape)} {block.dtype} strides {block.stride()}")
    R = block.shape[0]
    want = {"ring": (ring, (plan.slots, (R + 1) // 2, plan.n, 2),
                     torch.float32),
            "input": (inputs, (R, plan.inputs, plan.block), torch.float32),
            "pos": (pos, (), torch.int32)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype \
                or not t.is_contiguous() or t.device != block.device:
            raise ValueError(
                f"spectral_step takes a contiguous {shape} {dtype} {name} on "
                f"{block.device}, got {tuple(t.shape)} {t.dtype} on "
                f"{t.device}")


def spectral_step_plain(ring: torch.Tensor, inputs: torch.Tensor,
                        pos: torch.Tensor, block: torch.Tensor,
                        plan: SpectralPlan) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The plain PyTorch version of :func:`spectral_step`, for CPU tensors:
    the same rings, written in place, through ``torch.fft``; the position
    is used as a tensor (nothing is read back to the host)."""
    if block.is_cuda:
        raise ValueError("the delay line's plain version runs on the CPU; "
                         "on the card the kernel runs")
    R, B = block.shape
    n, S, T = plan.n, plan.slots, plan.inputs
    # window sample i < n - B lies d = ceil((n - B - i) / B) blocks back, in
    # the input ring's slot (pos - d) % T
    i = torch.arange(n - B)
    d = (n - 1 - i) // B
    slot = torch.remainder(pos.long() - d, T)
    past = inputs.reshape(R, T * B)[:, slot * B + i + d * B - (n - B)]
    window = torch.cat([past, block], dim=-1)
    if R % 2:
        window = torch.cat([window, window.new_zeros((1, n))])
    order = torch.from_numpy(segconv.dif_positions(n))
    x = torch.empty((window.shape[0] // 2, n), dtype=torch.complex64)
    x[:, order] = torch.fft.fft(torch.complex(window[0::2], window[1::2]),
                                dim=-1)
    here = torch.remainder(pos.long(), S).reshape(1)
    ring.index_copy_(0, here, torch.view_as_real(x).unsqueeze(0))
    slots = torch.remainder(here - plan.delay_table.long(), S)
    y = (torch.view_as_complex(ring.index_select(0, slots))
         * torch.view_as_complex(plan.spectra).unsqueeze(1)).sum(0)
    w = torch.fft.ifft(y[:, order], dim=-1, norm="forward")
    out = torch.stack([w.real, w.imag], 1).reshape(-1, n)[:R, n - B:]
    inputs.index_copy_(1, torch.remainder(pos.long(), T).reshape(1),
                       block.unsqueeze(1))
    return out.contiguous(), torch.remainder(pos + 1, plan.period).to(
        torch.int32)


def _launch_spectral(ring: torch.Tensor, inputs: torch.Tensor,
                     pos: torch.Tensor, block: torch.Tensor,
                     plan: SpectralPlan):
    """The kernel on checked tensors."""
    global launch_count, spectral_launch_count
    R, B = block.shape
    out = torch.empty((R, B), dtype=torch.float32, device=block.device)
    next_pos = torch.empty((), dtype=torch.int32, device=block.device)
    fn = _build.launcher("convpairs", "convpairs_spectral_launch",
                         [ctypes.c_void_p, ctypes.c_longlong]
                         + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                         + [ctypes.c_void_p])
    with _build.on_device(block.device):
        err = fn(block.data_ptr(), block.stride(0) if R > 1 else B,
                 out.data_ptr(), inputs.data_ptr(), ring.data_ptr(),
                 pos.data_ptr(), next_pos.data_ptr(),
                 plan.delay_table.data_ptr(), len(plan.delays), plan.slots,
                 plan.inputs, plan.period, B, plan.spectra.data_ptr(),
                 plan.twiddle.data_ptr(), R, plan.n,
                 torch.cuda.current_stream(block.device).cuda_stream)
    _raise_on(err, f"spectral step: R={R}, n={plan.n}, B={B}, "
                   f"partitions={len(plan.delays)}, slots={plan.slots}")
    launch_count += 1
    spectral_launch_count += 1
    return out, next_pos


def spectral_step(ring: torch.Tensor, inputs: torch.Tensor,
                  pos: torch.Tensor, block: torch.Tensor, plan: SpectralPlan,
                  use_kernels: bool = True):
    """One step of a FIR streamed through a frequency-domain delay line:
    ``block`` (R, B) float32, unit stride along a row; ``ring`` (S, pairs,
    n, 2), ``inputs`` (R, T, B) and ``pos`` (0-d int32), the state
    (:func:`spectral_init_state`), all contiguous -> (the block's output
    (R, B), the next position: a new 0-d int32 tensor). ``ring`` and
    ``inputs`` are ADVANCED IN PLACE: the window's spectrum goes into the
    ring's slot ``pos % S``, the block into the input ring's slot
    ``pos % T``; a caller that must keep the old state passes copies.

    Row r's window is the last n samples of its input, block included; the
    output is the last B samples of the inverse transform of the sum over
    the used partitions p of the spectrum stored p steps ago times
    partition p's: ``conv(x, kernel)`` block by block. On a CUDA tensor all
    of it is ONE launch of the hand-written kernel (a row pair over a
    cluster: the window's block and :data:`SPECTRAL_BLOCKS` summing ones, or
    past 16,384 points the window over :data:`SPECTRAL_BLOCKS`), or the call
    raises; for a CPU tensor the plain version runs."""
    _check_spectral(ring, inputs, pos, block, plan)
    if block.is_cuda and use_kernels:
        return _launch_spectral(ring, inputs, pos, block, plan)
    return spectral_step_plain(ring, inputs, pos, block, plan)
