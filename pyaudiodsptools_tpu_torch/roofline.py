"""Roofline cost models of the port's kernels on an NVIDIA H100.

Counterpart of ``pyaudiodsptools_tpu/roofline.py``. For every function the
port runs as a hand-written kernel it models the two budgets a call can be
bound by, device memory bytes and arithmetic, so that a measured time turns
into a share of each roofline and the binding resource is named:

* ``bytes``: each input byte read once and each output byte written once,
  whatever a kernel reads again (a window's overlap, a partition adding into
  the output);
* ``tensor_flops``: operations on the tensor cores (none of the port's
  kernels uses them: every FFT and walk runs on the fp32 units);
* ``fp32_flops``: float32 operations outside the tensor cores.

The counts are the function's, computed from its shapes and from the
planner's geometry, which a kernel and its plain PyTorch version share: the
same cost stands for the kernel, the plain version and a library call that
computes the same function.

Peaks: NVIDIA's data sheet for the H100 SXM part (dense, no sparsity),
which assume the full power limit of 700 W. There is no default card: a card
this module does not know raises.

Everything here is arithmetic on Python ints and floats; ``torch`` is read
only for the name of the card.
"""

from __future__ import annotations

from dataclasses import dataclass

from .core.config import DEFAULT_DEVICE, resolve_device


@dataclass(frozen=True)
class Peaks:
    hbm_bytes_per_s: float
    tensor_tf32_flops: float
    fp32_flops: float


_PEAKS = {
    # torch.cuda.get_device_name of the H100 SXM part
    "NVIDIA H100 80GB HBM3": Peaks(3.35e12, 495e12, 67e12),
}


def peaks_for(device_name: str) -> Peaks:
    """Published peaks of the card ``torch.cuda.get_device_name`` calls
    ``device_name``; raises for a card without a row here."""
    try:
        return _PEAKS[device_name]
    except KeyError:
        raise ValueError(
            f"no published peaks for the card {device_name!r}; known: "
            f"{sorted(_PEAKS)}") from None


def peaks_for_device(device=DEFAULT_DEVICE) -> Peaks:
    """Peaks of the card ``device`` names; raises without a card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the roofline's peaks are a card's; got {dev}")
    import torch

    return peaks_for(torch.cuda.get_device_name(dev))


def _cost(nbytes: float, fp32_flops: float, tensor_flops: float = 0.0
          ) -> dict:
    return {"bytes": float(nbytes), "tensor_flops": float(tensor_flops),
            "fp32_flops": float(fp32_flops)}


def _window_fft_flops(n: int) -> int:
    """One complex n-point window through a forward and an inverse FFT
    (5 n log2 n each) and the product with the spectrum (6 n)."""
    return 2 * 5 * n * (n.bit_length() - 1) + 6 * n


# ---------------------------------------------------------------------------
# row 1: the segmented (overlap-save) convolution


def partitioned_conv_cost(C: int, T: int, windows) -> dict:
    """A FIR over (C, T) f32 in partitions, one segmented convolution each,
    the outputs summed: ``windows`` is each partition's ``(n, seg)``. The
    signal is read once and the output written once; each partition's
    spectrum and twiddles (8 n bytes each) are read once. Each channel's
    windows go two to a complex transform."""
    nbytes = 8 * C * T
    ops = 0
    for n, seg in windows:
        nbytes += 2 * 8 * n
        ops += C * -(-(-(-T // seg)) // 2) * _window_fft_flops(n)
    return _cost(nbytes, ops)


def conv_cost(C: int, T: int, n: int, seg: int) -> dict:
    """``kernels/segconv.segmented_conv`` of one plan: windows of ``n``
    samples ``seg`` apart over (C, T) f32."""
    return partitioned_conv_cost(C, T, [(n, seg)])


def conv_cost_from_params(C: int, T: int, p) -> dict | None:
    """``partitioned_conv_cost`` of an effect's offline when it is a FIR
    (``FIRParams``: a lowcut, a fused cascade, eq3band_fft; the reverb's
    combined kernel; the EQ's FIR-ised response): its plans' windows. None
    for params that carry no FIR plan (the tremolo)."""
    for fir in (p, getattr(p, "full", None), getattr(p, "fir", None)):
        plans = getattr(fir, "plans", None)
        if plans:
            return partitioned_conv_cost(C, T,
                                         [(q.n, q.seg) for q in plans])
    return None


# ---------------------------------------------------------------------------
# row 8: the circular convolution of real rows


def conv_pairs_cost(R: int, n: int, history: int | None = None,
                    block: int | None = None) -> dict:
    """``kernels/convpairs`` on R rows at a window of ``n``: ``conv_pairs``
    reads and writes R rows of n; the step entry point (``history`` and
    ``block`` given) reads history and block and writes the block's output
    and the next history. Two rows go to a complex transform; the spectrum
    and the twiddles are read once."""
    per_row = 2 * n if history is None else 2 * (history + block)
    return _cost(4 * R * per_row + 2 * 8 * n,
                 -(-R // 2) * _window_fft_flops(n))


# ---------------------------------------------------------------------------
# rows 3, 4 and 7: the dynamics automatons

# Operations per sample of one automaton, counted from csrc/dynamics.cu:
# compares, selects, the two ramps and the output product; without the gain
# path for a states-only walk's last op.
WALK_OPS_WITH_GAIN = 25
WALK_OPS_STATE_ONLY = 12
# Bytes of one op's state in a stream (mode, x, y as int32, skip as bool).
STREAM_STATE_BYTES = 13


def dynamics_cost(C: int, T: int, n_ops: int, audio: bool = True,
                  lanes: int = 0) -> dict:
    """A cascade of ``n_ops`` compressor / gate automatons over (C, T) f32.
    ``audio``: the output is written (the audio walk, a whole stage); else
    only states come out (the state walk). ``lanes``: the segments (C x G,
    the planner's geometry) whose entry states a walk reads and whose exit
    states it writes, one int32 an op; 0 for a whole stage, whose states
    stay inside it."""
    ops_per_sample = WALK_OPS_WITH_GAIN * n_ops if audio else \
        WALK_OPS_WITH_GAIN * (n_ops - 1) + WALK_OPS_STATE_ONLY
    return _cost(4 * C * T * (2 if audio else 1) + 2 * 4 * n_ops * lanes,
                 C * T * ops_per_sample)


def serial_walk_cost(C: int, B: int, n_ops: int) -> dict:
    """The streaming step of a dynamics cascade (``cascade_step``): a (C, B)
    block in and out, each op's 4-field state read and written."""
    return _cost(8 * C * B + 2 * STREAM_STATE_BYTES * n_ops * C,
                 C * B * WALK_OPS_WITH_GAIN * n_ops)


# ---------------------------------------------------------------------------
# row 2: the fused tail, and the plain ops


_MAP_OPS = {"saturator": 12, "softclipper": 36, "harddistortion": 38,
            "bitcrusher": 5}


def tail_ops_per_sample(stages) -> int:
    """Operations of one sample through a tail stage plan
    (``kernels/tail._plan_stages``): 2 per tap, 1 per gain, and per map the
    arithmetic of its formula with a pow or a sin counted as 30."""
    ops = 0
    for s in stages:
        if s[0] == "taps":
            ops += 1 + 2 * len(s[1])
        elif s[0] == "gain":
            ops += 1
        else:
            ops += _MAP_OPS[s[1]]
    return ops


def tail_cost(C: int, T: int, stages, gain_words: int) -> dict:
    """``kernels/tail.tail_kernel``: (C, T) f32 in and out through the stage
    plan, and its ``gain_words`` float32 gain rows read once."""
    return _cost(8 * C * T + 4 * gain_words,
                 C * T * tail_ops_per_sample(stages))


def simple_cost(C: int, T: int, read_passes: float = 1.0,
                write_passes: float = 1.0,
                fp32_flops_per_sample: float = 0.0) -> dict:
    """A pass of elementwise work over (C, T) f32: a relayout (pack,
    unpack), a plain op (a delay, a tremolo, a waveshaper)."""
    return _cost(4.0 * C * T * (read_passes + write_passes),
                 float(C) * T * fp32_flops_per_sample)


# ---------------------------------------------------------------------------
# the bound and the shares


def bound(cost: dict, pk: Peaks) -> dict:
    """The least time the card could take (ms): the bytes over its memory
    rate or the operations over their unit's peak, whichever is larger."""
    tb = cost["bytes"] / pk.hbm_bytes_per_s * 1e3
    to = max(cost["tensor_flops"] / pk.tensor_tf32_flops,
             cost["fp32_flops"] / pk.fp32_flops) * 1e3
    return {"bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "bound_bytes_ms": tb, "bound_operations_ms": to}


def classify(measured_s: float, cost: dict, pk: Peaks) -> dict:
    """Attach roofline percentages and name the binding resource."""
    bw_pct = 100.0 * (cost["bytes"] / pk.hbm_bytes_per_s) / measured_s
    tc_pct = 100.0 * (cost["tensor_flops"] / pk.tensor_tf32_flops) \
        / measured_s
    fp_pct = 100.0 * (cost["fp32_flops"] / pk.fp32_flops) / measured_s
    top = max(bw_pct, tc_pct, fp_pct)
    if top < 15.0:
        resource = "latency/overhead"
    elif top == bw_pct:
        resource = "hbm-bandwidth"
    elif top == tc_pct:
        resource = "tensor-compute"
    else:
        resource = "fp32-compute"
    return {
        "model_gb": round(cost["bytes"] / 1e9, 4),
        "model_tensor_gflop": round(cost["tensor_flops"] / 1e9, 2),
        "model_fp32_gflop": round(cost["fp32_flops"] / 1e9, 2),
        "hbm_roofline_pct": round(bw_pct, 1),
        "tensor_roofline_pct": round(tc_pct, 1),
        "fp32_roofline_pct": round(fp_pct, 1),
        "bound": resource,
    }
