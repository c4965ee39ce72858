"""The yardstick's roofline: each kernel's bytes and operations from its
shapes, and the H100's published peaks. A frozen copy of the cost models
of ``pyaudiodsptools_tpu_torch/roofline.py`` as they stood when the
benchmark was defined, with the offline conv's window geometry frozen with
them, so that a later change to the program's planner or cost model moves
neither the bound nor a share read against it.

Bytes: each input byte read once and each output byte written once.
Operations: float32 operations outside the tensor cores (no kernel of the
port uses them). The least time is the larger of bytes over the memory
rate and operations over the fp32 rate.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense, at the full 700 W: name as
# torch.cuda.get_device_name gives it -> (HBM bytes/s, fp32 FLOP/s).
PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12)}

# The offline conv's window geometry when the benchmark was defined
# (ops/fft_filter.plan_segments): the halo is the stripped kernel's reach
# rounded up to 128 samples, the window a power of two from 1,024, at least
# 8x the halo up to 32,768 and at least 2x the halo.
HALO_STEP = 128
MIN_WINDOW = 1024
PLANNED_WINDOW = 32768

# Operations a sample of one compressor / gate automaton, and of the
# tail's stages (csrc/dynamics.cu, csrc/tail.cu as counted then).
WALK_OPS_WITH_GAIN = 25
WALK_OPS_STATE_ONLY = 12
MAP_OPS = {"saturator": 12, "softclipper": 36, "harddistortion": 38,
           "bitcrusher": 5}


def peaks(device_name: str) -> tuple[float, float]:
    try:
        return PEAKS[device_name]
    except KeyError:
        raise ValueError(f"no published peaks for {device_name!r}; known: "
                         f"{sorted(PEAKS)}") from None


def cost(nbytes: float, fp32_flops: float) -> dict:
    return {"bytes": float(nbytes), "fp32_flops": float(fp32_flops)}


def bound_s(c: dict, device_name: str) -> float:
    hbm, fp32 = peaks(device_name)
    return max(c["bytes"] / hbm, c["fp32_flops"] / fp32)


def window_fft_flops(n: int) -> int:
    """A complex n-point window through a forward and an inverse FFT
    (5 n log2 n each) and the product with the spectrum (6 n)."""
    return 2 * 5 * n * (n.bit_length() - 1) + 6 * n


def conv_window(kernel_len: int) -> tuple[int, int]:
    """(n, seg): the frozen window and output span of a stripped kernel of
    ``kernel_len`` taps that fits one window."""
    halo = HALO_STEP * max(1, -(-(kernel_len - 1) // HALO_STEP))
    n = MIN_WINDOW
    while (n < 8 * halo and n < PLANNED_WINDOW) or n < 2 * halo:
        n *= 2
    return n, n - halo


def conv_cost(C: int, T: int, kernel_len: int) -> dict:
    """The segmented convolution of (C, T) f32 with a stripped kernel: the
    signal read and the output written once, the spectrum and twiddles
    (8 n bytes each) read once; two windows of a channel a transform."""
    n, seg = conv_window(kernel_len)
    return cost(8 * C * T + 2 * 8 * n,
                C * -(-(-(-T // seg)) // 2) * window_fft_flops(n))


def walk_cost(C: int, T: int, n_ops: int, audio: bool) -> dict:
    """One walk of a cascade of ``n_ops`` automatons over (C, T) f32: the
    audio walk reads and writes the signal, the state walk only reads it.
    The segments' entry and exit states (a few bytes a lane) are left out,
    so the bound is never above the walk's true least time."""
    per = WALK_OPS_WITH_GAIN * n_ops if audio else \
        WALK_OPS_WITH_GAIN * (n_ops - 1) + WALK_OPS_STATE_ONLY
    return cost(4 * C * T * (2 if audio else 1), C * T * per)


def tail_cost(C: int, T: int, stages: list[tuple]) -> dict:
    """The fused tail over (C, T) f32 through ``stages``, each
    ``("taps", n_taps)``, ``("gain",)`` or ``("map", name)``: 1 + 2 a tap
    for a taps stage, 1 for a gain, a map's formula (a pow or a sin counted
    30); each gain row (T floats) read once."""
    ops = 0
    for s in stages:
        if s[0] == "taps":
            ops += 1 + 2 * s[1]
        elif s[0] == "gain":
            ops += 1
        else:
            ops += MAP_OPS[s[1]]
    gain_rows = sum(1 for s in stages if s[0] == "gain")
    return cost(8 * C * T + 4 * gain_rows * T, C * T * ops)
