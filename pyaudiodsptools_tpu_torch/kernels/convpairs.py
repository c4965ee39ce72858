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
the streaming step that is 64 rows of 2,048 or 16,384 samples, 32 thread
blocks on a card with 132 SMs, so the launch is over in the time ONE block
needs for its passes through shared memory: latency, not bytes or FLOPs. At
a batch that fills the card it is bound by the shared-memory passes, as the
segmented convolution is. The design shares that kernel's transform
(``csrc/window_fft.cuh``: window resident in shared memory from load to
store, two radix-4 levels per pass, the spectrum in the forward transform's
output order, no reorder pass) and its host tables
(``segconv.pass_twiddles``, ``segconv.spectrum_tables``). Rows may be a
strided view (``flat.stride(0) >= n``, unit stride along a row), so a
streaming step passes a slice of its history without copying it.

The CUDA source is ``csrc/convpairs.cu``. The plain version,
:func:`conv_pairs_plain`, is the same function on ``torch.fft``; it runs for
CPU tensors, or on request (``use_kernels=False``), and is never a fallback
for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import _build, segconv

# Number of kernel launches made by :func:`conv_pairs` (and by nothing else)
# since the caller last set it to 0.
launch_count = 0


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
    segconv.check_window(n)
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


def _launch(flat: torch.Tensor, plan: PairsPlan) -> torch.Tensor:
    global launch_count
    segconv.check_window(plan.n)
    segconv.check_tables(plan.n, plan.spectrum_dif, plan.twiddle, flat.device)
    R = flat.shape[0]
    out = torch.empty((R, plan.n), dtype=torch.float32, device=flat.device)
    if flat.stride(1) != 1 or (R > 1 and flat.stride(0) < plan.n):
        raise ValueError(
            "conv_pairs takes rows with unit stride, at least n apart, got "
            f"strides {flat.stride()} for n={plan.n}")
    fn = _build.load("convpairs").convpairs_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_void_p]
    with torch.cuda.device(flat.device):
        err = fn(flat.data_ptr(), out.data_ptr(), plan.spectrum_dif.data_ptr(),
                 plan.twiddle.data_ptr(), R, plan.n,
                 flat.stride(0) if R > 1 else plan.n,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"convpairs kernel launch failed with CUDA error {err} "
            f"(R={R}, n={plan.n})")
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
