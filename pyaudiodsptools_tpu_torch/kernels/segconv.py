"""Segmented overlap-save convolution: wrapper, plain version and plan.

Replaces the TPU kernel ``pyaudiodsptools_tpu/kernels/pallas_conv.py ::
segmented_conv_fused`` (bodies ``_kernel_dma_union`` / ``_kernel_dma``). It
computes what that kernel computes, per channel of a (C, T) float32 signal:

    y[c, m] = sum_k h[k] * x[c, m - shift - k],   0 <= m < T

(with ``y[c, m < shift] = 0`` exactly) and none of its choreography: no row
offset, no phasor delay folded into the spectrum, no zero-extended tail buffer, no (8, 128) alignment gates, no
bf16x3 split, no matmul DFT. A thread block gathers its window from any
sample offset and masks ``idx < 0`` and ``idx >= T`` to zero itself.

What bounds it on an H100: by bytes it must read the signal ``n/seg`` times
and write it once, a few hundred microseconds at the main-path shape; the
fp32 FFT on the CUDA cores, with every pass going through shared memory,
costs several times that, so this kernel is bound by shared-memory passes
and not by device memory. The design keeps everything between the window
gather and the wrap-free store in shared memory (one device-memory read and
one write per window), packs two real windows into one complex transform,
does two radix-4 levels per pass in registers, runs the innermost levels of
both directions and the spectrum multiply as one pass, and stores the
spectrum in the forward transform's output order so that no reorder pass is
needed. A window wider than one block's shared memory (up to 65,536 points)
is spread over a thread-block cluster of two or four blocks, whose top pass
goes through distributed shared memory: at a long halo the wider window
transforms fewer points for each one it keeps (:data:`CLUSTER_AT`, the
version by window). The gather moves 16 bytes a thread where the signal's
offset allows, and a thread issues all its loads before its first
shared-memory store. The store is the part of the memory traffic a block
waits for: a writing launch hands its outputs to the Tensor Memory
Accelerator (bulk copies out of shared memory, drained while the next block
runs), and an accumulating one loads every chunk of the output it adds into
before its first add. Below the top pass of a window over a cluster
each run of points belongs to the same warps in every pass, which wait only
for the warps that share their points (a warp, or a group of at least
:data:`OWNER_THREADS` threads at a hardware barrier of its own); those
narrower waits, not the item order, make it about 5 % faster than a block
barrier after every pass (PERF.md). Tensor-core DFTs are left to a later
change (PERF.md, open questions).

The CUDA source is ``csrc/segconv.cu``; the transform itself lives in
``csrc/window_fft.cuh``, which the streaming windows' convolution
(``kernels/convpairs.py``) shares, together with this module's twiddle and
spectrum tables. A kernel longer than one window takes is cut into
partitions by the caller (``ops/fft_filter.plan_partitions``):
:func:`partitioned_conv` launches the kernel once a partition, the first
writing the output and each later one adding into it (the kernel's
accumulate mode), so the sum costs no pass of its own. The plain versions,
:func:`segmented_conv_plain` and :func:`partitioned_conv_plain`, are the
same windowed overlap-save on ``torch.fft`` and the same sum in the same
order; they run for CPU tensors, or on request (``use_kernels=False``), and
are never a fallback for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import profiling
from . import _build

# One block's window of complex float32 must fit its shared memory: 8 bytes
# * 16,384 = 128 KB of the 227 KB a block may have on sm_90. The streaming
# windows (kernels/convpairs.py) are one block's at most.
BLOCK_WINDOW = 16384
# A cluster of four blocks holds four times that: the largest window of the
# segmented convolution.
MAX_WINDOW = 4 * BLOCK_WINDOW
MIN_WINDOW = 16
# The smallest window a cluster takes (each block keeps whole passes).
CLUSTER_MIN_WINDOW = 256
# Blocks a window pair by window size: one block up to BLOCK_WINDOW, then a
# cluster of two (32,768) or four (65,536), each block holding 16,384 points.
# The planner (ops/fft_filter.plan_segments) chooses the window and with it
# the version; chip_smoke.py's `segconv_versions` times each at the main
# path's halos (PERF.md has the table).
CLUSTER_AT = {2 * BLOCK_WINDOW: 2, 4 * BLOCK_WINDOW: 4}

# Threads of a thread block, by the points it holds: one per 16, a warp at
# least, BLOCK_THREADS at most (csrc/window_fft.cuh: WINDOW_FFT_THREADS,
# window_threads).
BLOCK_THREADS = 1024
# Below the top pass of a window over a cluster (2 or 4 blocks) the kernel's
# transform gives each run of points to the same threads in every pass, and
# a group of at least OWNER_THREADS of them (owning whole runs) waits at a
# hardware barrier of its own (csrc/window_fft.cuh: WINDOW_FFT_OWNER_THREADS,
# owner_threads). A window in one block keeps a block barrier after every
# pass (it measured faster so on an H100).
OWNER_THREADS = 128

# Number of kernel launches made by :func:`segmented_conv` and
# :func:`partitioned_conv` (one a partition; and by nothing else) since the
# caller last set it to 0.
launch_count = 0
# Of those, the launches in the accumulate mode (``into=``: every partition
# of :func:`partitioned_conv` after the first).
accumulate_launch_count = 0


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """Geometry and device tables of one FIR for the segmented convolution.

    A window holds ``n = halo + seg`` samples; consecutive windows start
    ``seg`` samples apart and each yields its last ``seg`` (wrap-free)
    output samples. ``shift`` delays the output (the kernel's stripped zero
    prefix)."""

    n: int
    halo: int
    seg: int
    shift: int
    kernel_len: int
    blocks: int                   # thread blocks a window pair: 1, 2 or 4
    spectrum_rfft: torch.Tensor   # (n//2+1,) complex64: plain version
    spectrum_dif: torch.Tensor    # (n, 2) f32: full spectrum / n, in the
                                  # forward DIF's output order: CUDA kernel
    twiddle: torch.Tensor         # (L, 2) f32: per-pass twiddle rows


def stage_radices(n: int) -> list[int]:
    """Radices of the forward transform's levels: radix 4 while it divides,
    then one radix-2 level if log2(n) is odd. ``csrc/segconv.cu`` runs the
    same levels (grouped into passes, see :func:`pass_schedule`)."""
    radices = []
    m = n
    while m >= 4:
        radices.append(4)
        m //= 4
    if m == 2:
        radices.append(2)
    return radices


def dif_positions(n: int) -> np.ndarray:
    """``pos[k]``: where the in-place decimation-in-frequency transform
    leaves frequency ``k`` (mixed-radix digit reversal)."""
    rem = np.arange(n)
    pos = np.zeros(n, dtype=np.int64)
    span = n
    for r in stage_radices(n):
        span //= r
        pos += (rem % r) * span
        rem //= r
    return pos


def pass_schedule(n: int) -> list[tuple[str, int]]:
    """The kernel's passes over the levels above its innermost pass, in
    forward order: ``("two", lm)`` runs the radix-4 levels of size ``2**lm``
    and ``2**(lm-2)`` in one pass, ``("one", lm)`` the level of size
    ``2**lm`` alone. The innermost pass takes the levels of size <= 16
    (log2(n) even) or <= 8 (odd) and needs no table."""
    ln = n.bit_length() - 1
    inner = 3 if ln & 1 else 4
    passes = []
    lm = ln
    while lm - 4 >= inner:
        passes.append(("two", lm))
        lm -= 4
    if lm > inner:
        passes.append(("one", lm))
    return passes


_twiddles: dict[tuple[int, str], torch.Tensor] = {}


def pass_twiddles(n: int, device: torch.device) -> torch.Tensor:
    """(L, 2) float32 twiddle rows for ``csrc/segconv.cu``, built in float64
    on the host; one table per window size and device.

    The rows of each pass follow one another in forward order, indexed by the
    thread's own ``j`` so that consecutive threads read consecutive entries:
    a two-level pass at size m has six rows of m/16 entries, ``w_m^(j*p)``
    then ``w_(m/4)^(j*p)`` for p = 1, 2, 3; a one-level pass has three rows of
    m/4 entries, ``w_m^(j*p)``. (``w_m = exp(-2*pi*i/m)``.)"""
    key = (n, str(device))
    tab = _twiddles.get(key)
    if tab is None:
        rows = [np.zeros(0, dtype=np.complex128)]
        for kind, lm in pass_schedule(n):
            m = 1 << lm
            if kind == "two":
                j = np.arange(m >> 4)
                rows += [np.exp(-2j * np.pi * j * p / m) for p in (1, 2, 3)]
                rows += [np.exp(-2j * np.pi * j * p / (m >> 2)) for p in (1, 2, 3)]
            else:
                j = np.arange(m >> 2)
                rows += [np.exp(-2j * np.pi * j * p / m) for p in (1, 2, 3)]
        w = np.concatenate(rows)
        if w.size == 0:                    # n = 16: the innermost pass alone
            w = np.ones(1, dtype=np.complex128)
        tab = torch.from_numpy(
            np.stack([w.real, w.imag], axis=1).astype(np.float32)).to(device)
        _twiddles[key] = tab
    return tab


def blocks_for(n: int) -> int:
    """Thread blocks a window pair of n points takes: one where the window
    fits one block, else the cluster of :data:`CLUSTER_AT`."""
    return CLUSTER_AT.get(n, 1)


def block_threads(m: int) -> int:
    """Threads of a block that holds m points of a window."""
    return min(BLOCK_THREADS, max(32, m // 16))


def owner_threads(n: int, blocks: int) -> int:
    """Threads of a group that owns runs of points below the top pass of an
    n-point window over a cluster of ``blocks`` thread blocks: below it a
    block's points are 16 / blocks independent runs; a group is the threads
    of a run, but :data:`OWNER_THREADS` at least (a block has 16 hardware
    barriers, one of them the block's own) and the whole block at most."""
    threads = block_threads(n // blocks)
    return min(threads, max(threads * blocks // 16, OWNER_THREADS))


def versions(n: int) -> list[int]:
    """Every count of thread blocks (1, 2, 4) over which the kernel can
    spread a window pair of n points."""
    return [b for b in (1, 2, 4) if n // b <= BLOCK_WINDOW
            and (b == 1 or n >= CLUSTER_MIN_WINDOW)]


def make_plan(kernel: np.ndarray, halo: int, seg: int, shift: int,
              device) -> ConvPlan:
    """Build the plan of a real float64 ``kernel`` (zero prefix already
    stripped) for windows of ``halo + seg`` samples."""
    kernel = np.asarray(kernel, dtype=np.float64)
    n = halo + seg
    _check_geometry(n, halo, seg, shift, len(kernel))
    device = torch.device(device)
    spectrum_rfft, spectrum_dif = spectrum_tables(kernel, n, device)
    return ConvPlan(
        n=n, halo=halo, seg=seg, shift=shift, kernel_len=len(kernel),
        blocks=blocks_for(n), spectrum_rfft=spectrum_rfft,
        spectrum_dif=spectrum_dif, twiddle=pass_twiddles(n, device),
    )


def spectrum_tables(kernel: np.ndarray, n: int, device
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The two forms of a real float64 kernel's n-point spectrum, on
    ``device``: (n//2+1,) complex64 for the plain versions, and for the CUDA
    transform (``csrc/window_fft.cuh``) the full spectrum divided by n, in
    the forward transform's output order, as (n, 2) float32."""
    full = np.fft.fft(np.concatenate([kernel, np.zeros(n - len(kernel))]))
    permuted = np.empty(n, dtype=np.complex128)
    permuted[dif_positions(n)] = full / n
    return (torch.from_numpy(full[: n // 2 + 1].astype(np.complex64)
                             ).to(device),
            torch.from_numpy(np.stack([permuted.real, permuted.imag], axis=1
                                      ).astype(np.float32)).to(device))


def check_window(n: int, largest: int = MAX_WINDOW) -> None:
    """The window sizes ``csrc/window_fft.cuh`` transforms: up to
    ``largest`` (:data:`MAX_WINDOW` over a cluster of four blocks,
    :data:`BLOCK_WINDOW` in one block)."""
    if n & (n - 1) or not MIN_WINDOW <= n <= largest:
        raise ValueError(
            f"window of {n} samples: the convolution kernel takes a power "
            f"of two between {MIN_WINDOW} and {largest} (one complex window "
            "must fit the shared memory of a thread block, or of a cluster "
            "of four)")


def check_tables(n: int, spectrum_dif: torch.Tensor, twiddle: torch.Tensor,
                 device) -> None:
    """The device tables of an n-point window, as the kernels read them."""
    for name, t, rows in (("spectrum_dif", spectrum_dif, n),
                          ("twiddle", twiddle,
                           pass_twiddles(n, device).shape[0])):
        if t.device != device or t.shape != (rows, 2) \
                or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"plan.{name} must be a contiguous ({rows}, 2) float32 "
                f"tensor on {device}, got {tuple(t.shape)} {t.dtype} on "
                f"{t.device}")


def _check_geometry(n: int, halo: int, seg: int, shift: int,
                    kernel_len: int) -> None:
    """What the CUDA kernel relies on, checked where it is relied on."""
    check_window(n)
    if halo < 0 or seg < 1 or halo + seg != n:
        raise ValueError(f"bad window geometry: halo {halo} + seg {seg} != {n}")
    if halo % 4:
        raise ValueError(
            f"a halo of {halo} samples: the kernel moves a window pair in "
            "16-byte chunks, so the halo is a multiple of 4")
    if kernel_len - 1 > halo:
        raise ValueError(
            f"halo of {halo} samples does not cover a {kernel_len}-tap kernel")
    if shift < 0:
        raise ValueError(f"output delay must be >= 0, got {shift}")


def segmented_conv_plain(x: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """The plain PyTorch version: windowed overlap-save on ``torch.fft``."""
    C, T = x.shape
    n, halo, seg, shift = plan.n, plan.halo, plan.seg, plan.shift
    n_seg = -(-T // seg)
    # Left padding = halo + output delay: gathering every window `shift`
    # samples early lands its wrap-free region on y[m] = conv[m - shift].
    xp = torch.nn.functional.pad(x, (halo + shift, n_seg * seg - T))
    windows = xp.unfold(-1, n, seg)[:, :n_seg]
    conv = torch.fft.irfft(torch.fft.rfft(windows, dim=-1) * plan.spectrum_rfft,
                           n=n, dim=-1)
    y = conv[..., halo:].reshape(C, n_seg * seg)[:, :T]
    y = y.to(torch.float32).contiguous()
    # The output delay is exact: the first `shift` samples are silence, not
    # the transform's rounding noise.
    y[:, :shift] = 0.0
    return y


def _launch(x: torch.Tensor, plan: ConvPlan, blocks: int | None = None,
            into: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel on ``x``: a new output, or with ``into`` (C, T) float32
    contiguous, added into that one (the accumulate mode), which is
    returned. ``blocks`` (thread blocks a window pair, 1, 2 or 4) overrides
    the plan's version, for measurement only."""
    global launch_count, accumulate_launch_count
    blocks = plan.blocks if blocks is None else blocks
    if blocks not in versions(plan.n):
        raise ValueError(
            f"a window of {plan.n} samples does not go over {blocks} thread "
            "blocks")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            "segmented_conv takes a contiguous (C, T) float32 tensor, got "
            f"{tuple(x.shape)} {x.dtype} contiguous={x.is_contiguous()}")
    _check_geometry(plan.n, plan.halo, plan.seg, plan.shift, plan.kernel_len)
    check_tables(plan.n, plan.spectrum_dif, plan.twiddle, x.device)
    C, T = x.shape
    if T >= 2 ** 31 - plan.n - plan.shift:
        raise ValueError(f"signal of {T} samples is too long for int32 indexing")
    if into is None:
        y = torch.empty_like(x)
    elif into.shape != x.shape or into.dtype != torch.float32 \
            or not into.is_contiguous() or into.device != x.device \
            or into.data_ptr() == x.data_ptr():
        raise ValueError(
            "segmented_conv adds into a contiguous float32 tensor of the "
            f"input's shape on its device, not the input itself, got "
            f"{tuple(into.shape)} {into.dtype} on {into.device}")
    else:
        y = into
    if C == 0 or T == 0:
        return y
    fn = _build.launcher("segconv", "segconv_launch",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                         + [ctypes.c_void_p])
    with _build.on_device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), plan.spectrum_dif.data_ptr(),
                 plan.twiddle.data_ptr(), C, T, plan.n, plan.halo, plan.seg,
                 plan.shift, blocks, int(into is not None),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"segconv kernel launch failed with CUDA error {err} "
            f"(C={C}, T={T}, n={plan.n}, halo={plan.halo}, seg={plan.seg}, "
            f"blocks={blocks})")
    launch_count += 1
    if into is not None:
        accumulate_launch_count += 1
    return y


def segmented_conv(x: torch.Tensor, plan: ConvPlan,
                   use_kernels: bool = True) -> torch.Tensor:
    """``y[c, m] = conv(x[c], h)[m - plan.shift]`` for x of shape (C, T).

    A CUDA tensor goes through the hand-written kernel, or the call raises.
    The plain version runs for a CPU tensor, or when ``use_kernels`` is
    False."""
    if x.is_cuda and use_kernels:
        return _launch(x, plan)
    return segmented_conv_plain(x, plan)


def partitioned_conv_plain(x: torch.Tensor, plans) -> torch.Tensor:
    """The plain version of :func:`partitioned_conv`: each partition's
    :func:`segmented_conv_plain`, added in order in float32."""
    y = segmented_conv_plain(x, plans[0])
    for plan in plans[1:]:
        y = y + segmented_conv_plain(x, plan)
    return y


def partitioned_conv(x: torch.Tensor, plans,
                     use_kernels: bool = True) -> torch.Tensor:
    """The sum of :func:`segmented_conv` over the partitions' plans (each
    with its own kernel slice and output delay): the first writes the
    output, each later one adds into it, in order. One partition is
    :func:`segmented_conv` itself. A CUDA tensor goes through the
    hand-written kernel, one launch a partition, or the call raises. In a
    graph captured with tracing on, a stage mark lies between two
    partitions (``profiling.part``)."""
    if not (x.is_cuda and use_kernels):
        return partitioned_conv_plain(x, plans)
    y = _launch(x, plans[0])
    for plan in plans[1:]:
        profiling.part(x.device)
        _launch(x, plan, into=y)
    return y
