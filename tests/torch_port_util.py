"""Helpers shared by the tests of the PyTorch/CUDA port (tests/test_torch_*).

* ``snr_db`` -- signal-to-error ratio.
* ``spec_from_jax`` -- the plain numpy description of JAX effects that
  ``pyaudiodsptools_tpu_torch.convert.chain_from_numpy`` takes. The port
  imports no JAX, so the extraction lives here.
* ``emulate_segconv`` / ``emulate_convpairs`` / ``emulate_tail`` -- numpy
  mirrors of the CUDA kernels' schedules (csrc/segconv.cu and
  csrc/convpairs.cu with their shared csrc/window_fft.cuh, csrc/tail.cu):
  same passes, same tables, same order, float32 throughout. The CUDA
  sources cannot run without a card; the mirrors let the CPU tests hold the
  kernels' ALGORITHMS (twiddle and spectrum tables, digit-reversed order,
  the cluster's top pass, the tail's rings, their wrap and the runs' walk
  over the halo) against the plain versions.
* ``emulate_walk`` -- csrc/dynamics.cu's walk of ONE lane as a scalar numpy
  loop: the single-int automaton written the way the CUDA thread runs it
  (branches instead of selects, one rounded float32 operation at a time), a
  third reading of ``dynamics_pallas._int_automaton`` beside the JAX kernel
  and the port's tensor code.
* ``emulate_tile_walk`` -- the offline walks' schedule (csrc/dynamics.cu,
  ``walk_kernel``): blocks of rows of the (C*G, L) view of a (C, T) signal,
  tiles of samples through a ring of shared-memory slots (NaN until a copy
  lands), zeros past a row's length, an output tile stored back masked, the
  lanes' states in the order g*C + c; every row of a block walked at once
  with numpy float32 arithmetic in the kernel's order.
* ``emulate_serial_walk`` / ``advance_quiet`` -- the serial walk kernel's
  schedule for one channel: tiles, segments, the closed-form first guess, the
  fixpoint rounds with the jump over quiet segments; returns its round count.
* ``emulate_convpairs_step`` -- the step entry point of csrc/convpairs.cu:
  the window gathered from history and block, the kept samples, the next
  history.
* ``emulate_segconv_store`` -- one block's store in csrc/segconv.cu: the
  writing launch's two bulk-copy runs laid out in the block's shared memory
  and the points stored alone, the accumulating launch's chunks of y loaded
  before any add, the points alone; each output sample's value from the
  block's window, so that an index or alignment error shows on the CPU.
* ``emulate_stream_step`` -- the schedule of a FIR's step in partitions
  (``kernels/convpairs.stream_step``): each part's window gathered from the
  shared history and the block, its kept samples written or added in order
  in float32, the next history written by the first part whose window
  starts at 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit below is an optimisation of the test run
    threadpool_limits = None

# numpy's np.convolve (the host-side fusion of LTI kernels, in both packages)
# calls OpenBLAS's threaded dot product once an output sample. Where several
# test processes share the machine (xdist workers), their OpenBLAS threads
# spin against each other: a convolution of 40,000 by 16,000 samples took
# 0.18 s alone and 430 s each with three processes at once. The test
# processes keep OpenBLAS to one thread (the same 0.18 s alone, and with
# three processes); every module of the port's tests imports this one.
if threadpool_limits is not None:
    threadpool_limits(1, user_api="blas")

# PyTorch's own CPU threads. The plain convolutions (torch.fft, MKL's DFT
# batched over the overlap-save windows) gave other bits for one or two
# windows in some processes and not in others: two renders of one input in
# one process differed in 3,038-7,386 of 61,140 samples (chain7 at B=512) in
# 5 of 160 fresh processes that had run a JAX render first, four processes
# at a time, with torch's default of one thread a core; in 0 of 160 with one
# thread. The test processes keep torch to one thread, so that a plain CPU
# render has one answer whatever runs beside it
# (tests/test_torch_cpu_bits.py holds that).
import torch  # noqa: E402

torch.set_num_threads(1)


def snr_db(golden, ours) -> float:
    golden = np.asarray(golden, dtype=np.float64)
    ours = np.asarray(ours, dtype=np.float64)
    assert golden.shape == ours.shape, (golden.shape, ours.shape)
    err = np.sum((golden - ours) ** 2)
    if err == 0:
        return np.inf
    return 10.0 * np.log10(np.sum(golden ** 2) / err)


def conv_oracle(x: np.ndarray, kernel: np.ndarray, shift: int = 0) -> np.ndarray:
    """float64 ``y[c, m] = conv(x[c], kernel)[m - shift]``, length T, through
    one float64 FFT of the whole signal (a direct convolution with a kernel
    of tens of thousands of taps costs seconds; the FFT's rounding, ~1e-15
    relative, is far below every bar it is held to)."""
    C, T = x.shape
    kernel = np.asarray(kernel, dtype=np.float64)
    n = 1 << int(np.ceil(np.log2(T + len(kernel))))
    ref = np.fft.irfft(np.fft.rfft(x.astype(np.float64), n, axis=-1)
                       * np.fft.rfft(kernel, n), n, axis=-1)[:, :T]
    if shift:
        ref = np.concatenate([np.zeros((C, shift)), ref[:, :T - shift]], axis=1)
    return ref


def spec_from_jax(effects, sample_rate: int = 44100) -> list[dict]:
    """One plain dict per JAX effect: array leaves as numpy, static fields
    as they are, ``lti_kernel`` as float64. A reverb also carries its two
    lines (ramp, tap spacing and count) and the sample rate its lines'
    high-cuts were designed for, which its params do not hold."""
    spec = []
    for e in effects:
        if e.name == "reverb":
            lines = {k: getattr(e.params, k) for k in ("line1", "line2")}
            spec.append({
                "op": "reverb",
                "meta": {"block_size": e.params.block_size,
                         "sample_rate": sample_rate,
                         **{k: {"time_in_samples": p.time_in_samples,
                                "n_taps": p.n_taps}
                            for k, p in lines.items()}},
                "params": {k: {"ramp": np.asarray(p.ramp)}
                           for k, p in lines.items()},
                "lti_kernel": np.asarray(e.lti_kernel, dtype=np.float64)})
            continue
        params, meta = {}, {}
        for f in dataclasses.fields(e.params):
            v = getattr(e.params, f.name)
            if v is None or dataclasses.is_dataclass(v):
                continue
            if isinstance(v, (bool, int, float, str)):
                meta[f.name] = v
            else:
                params[f.name] = np.asarray(v)
        entry = {"op": e.name, "meta": meta, "params": params,
                 "lti_kernel": (None if e.lti_kernel is None else
                                np.asarray(e.lti_kernel, dtype=np.float64))}
        if entry["lti_kernel"] is not None and e.name != "delay":
            # FIR effects travel as kernel + block size only
            entry["params"] = {}
            entry["meta"] = {"block_size": meta["block_size"]}
        spec.append(entry)
    return spec


# ---------------------------------------------------------------------------
# csrc/segconv.cu in numpy


def _c64(z):
    return z.astype(np.complex64)


def _pad(i):
    """csrc/segconv.cu's shared-memory slot of point i."""
    return i + (i >> 4)


_W16 = _c64(np.exp(-2j * np.pi * np.arange(16) / 16))


def _dft4(a, sign):
    """4-point DFT on four arrays (sign -1: forward, +1: its adjoint)."""
    a0, a1, a2, a3 = a
    t0, t1, t2, t3 = a0 + a2, a0 - a2, a1 + a3, _c64(sign * 1j * (a1 - a3))
    return [_c64(t0 + t2), _c64(t1 + t3), _c64(t0 - t2), _c64(t1 - t3)]


def _two_levels_regs(x, w, forward):
    """csrc/window_fft.cuh's two_levels_on_registers on x[a][c] (arrays)."""
    def outer():
        for c in range(4):
            col = [x[a][c] for a in range(4)]
            if forward:
                col = _dft4(col, -1)
                for p in (1, 2, 3):
                    col[p] = _c64(_c64(col[p] * w[p - 1]) * _W16[(c * p) & 15])
            else:
                for p in (1, 2, 3):
                    col[p] = _c64(_c64(col[p] * _W16[(16 - c * p) & 15])
                                  * np.conj(w[p - 1]))
                col = _dft4(col, +1)
            for a in range(4):
                x[a][c] = col[a]

    def inner():
        for a in range(4):
            if forward:
                x[a] = _dft4(x[a], -1)
                for p in (1, 2, 3):
                    x[a][p] = _c64(x[a][p] * w[2 + p])
            else:
                for p in (1, 2, 3):
                    x[a][p] = _c64(x[a][p] * np.conj(w[2 + p]))
                x[a] = _dft4(x[a], +1)

    for level in ((outer, inner) if forward else (inner, outer)):
        level()


def _tables(plan):
    tw = plan.twiddle.cpu().numpy()
    spec = plan.spectrum_dif.cpu().numpy()
    return _c64(tw[:, 0] + 1j * tw[:, 1]), _c64(spec[:, 0] + 1j * spec[:, 1])


def _one_level(sm, t, lm, tw, off, forward):
    """csrc/window_fft.cuh's pass_one_level on the items ``t``."""
    q = 1 << (lm - 2)
    j = t & (q - 1)
    i0 = ((t >> (lm - 2)) << lm) + j
    slots = [_pad(i0 + k * q) for k in range(4)]
    w = [None] + [tw[off + p * q + j] for p in range(3)]
    a = [sm[s_] for s_ in slots]
    if forward:
        a = _dft4(a, -1)
        a = [a[0]] + [_c64(a[p] * w[p]) for p in (1, 2, 3)]
    else:
        a = [a[0]] + [_c64(a[p] * np.conj(w[p])) for p in (1, 2, 3)]
        a = _dft4(a, +1)
    for s_, v in zip(slots, a):
        sm[s_] = v


def _two_levels(sm, t, lm, tw, off, forward):
    """csrc/window_fft.cuh's pass_two_levels on the items ``t``."""
    lq2 = lm - 4
    q2, q1 = 1 << lq2, 1 << (lq2 + 2)
    j = t & (q2 - 1)
    i0 = ((t >> lq2) << lm) + j
    w = [tw[off + p * q2 + j] for p in range(6)]
    x = [[sm[_pad(i0 + c * q2 + a * q1)] for c in range(4)]
         for a in range(4)]
    _two_levels_regs(x, w, forward)
    for a in range(4):
        for c in range(4):
            sm[_pad(i0 + c * q2 + a * q1)] = x[a][c]


def _center(sm, t, width, spec):
    """csrc/window_fft.cuh's innermost pass on the items ``t``; width 4:
    levels 16 and 4; width 2: level 8 and the radix-2 level."""
    span = 4 * width
    i0 = t * span
    step = 16 // span                   # w_span = w_16 ** step
    x = [[sm[_pad(i0 + c + width * a)] for c in range(width)]
         for a in range(4)]
    for c in range(width):
        col = _dft4([x[a][c] for a in range(4)], -1)
        for a in range(4):
            x[a][c] = _c64(col[a] * _W16[(step * c * a) & 15])
    for a in range(4):
        if width == 4:
            x[a] = _dft4(x[a], -1)
        else:
            x[a] = [_c64(x[a][0] + x[a][1]), _c64(x[a][0] - x[a][1])]
        x[a] = [_c64(x[a][c] * spec[i0 + c + width * a])
                for c in range(width)]
        if width == 4:
            x[a] = _dft4(x[a], +1)
        else:
            x[a] = [_c64(x[a][0] + x[a][1]), _c64(x[a][0] - x[a][1])]
    for c in range(width):
        col = [_c64(x[a][c] * _W16[(16 - step * c * a) & 15])
               for a in range(4)]
        col = _dft4(col, +1)
        for a in range(4):
            x[a][c] = col[a]
    for a in range(4):
        for c in range(width):
            sm[_pad(i0 + c + width * a)] = x[a][c]


def _level_passes(lm_top, tw_off):
    """csrc/window_fft.cuh's convolve_levels as a list, in order, of
    (kind, lm, twiddle offset, k, forward): "two" and "one" passes down,
    the innermost pass ("center", its width in lm), and the adjoint passes
    back up; a pass over 2^ln points has 2^(ln - k) items."""
    from pyaudiodsptools_tpu_torch.kernels.segconv import pass_schedule

    offsets, off = [], tw_off
    for kind, lm in pass_schedule(1 << lm_top):
        offsets.append(off)
        off += (6 << (lm - 4)) if kind == "two" else (3 << (lm - 2))
    down = [(kind, lm, o, 4 if kind == "two" else 2)
            for (kind, lm), o in zip(pass_schedule(1 << lm_top), offsets)]
    width = 2 if lm_top & 1 else 4
    return ([(*p, True) for p in down]
            + [("center", width, None, 3 if width == 2 else 4, None)]
            + [(*p, False) for p in reversed(down)])


def _levels(sm, ln, lm_top, tw, tw_off, spec, pick=np.arange):
    """csrc/window_fft.cuh's convolve_levels on the 2^ln points held in the
    padded array ``sm``: the passes of the levels of size <= 2^lm_top down,
    the innermost pass with the spectrum multiply (``spec`` indexed by the
    points of ``sm``), and back up; the twiddle rows of its first pass start
    at ``tw_off``. ``pick(count)``: the items of a pass of ``count`` that
    run (all of them, in lockstep, by default)."""
    for kind, lm, off, k, forward in _level_passes(lm_top, tw_off):
        t = pick(1 << (ln - k))
        if kind == "two":
            _two_levels(sm, t, lm, tw, off, forward)
        elif kind == "one":
            _one_level(sm, t, lm, tw, off, forward)
        else:
            _center(sm, t, lm, spec)


def _owned_levels(sm, ln, lm_top, tw, tw_off, spec, groups):
    """The owned levels below the top pass (csrc/window_fft.cuh's
    convolve_levels_owned), group after group, the last first: each group
    runs its own items of every pass to the end before the next starts, so
    a read of a point that another group writes between the same two block
    barriers would find it unwritten or written too early, and the result
    would differ from the lockstep schedule's."""
    for g in reversed(range(groups)):
        _levels(sm, ln, lm_top, tw, tw_off, spec,
                pick=lambda count, g=g: np.arange(
                    g * count // groups, (g + 1) * count // groups))


def _padded(z):
    n = len(z)
    sm = np.full(n + (n >> 4), np.nan + 0j, dtype=np.complex64)
    sm[_pad(np.arange(n))] = _c64(z)
    return sm


def emulate_window_fft(z: np.ndarray, plan, blocks: int = 1,
                       owned: bool = False) -> np.ndarray:
    """One complex window through csrc/window_fft.cuh's passes, with its index
    arithmetic: padded shared memory, per-pass twiddle rows indexed by j, two
    radix-4 levels per pass (one alone if the outer levels are odd in
    number), constant 16th roots, and the innermost pass that runs the last
    forward levels, the spectrum multiply and the first inverse levels on 16
    (or 8) neighbouring points. With ``blocks`` = 2 or 4, the cluster
    transform: each 'block' holds n/blocks points in its own padded array,
    the top pass gathers a thread's 16 points from the blocks by the
    kernel's own index map (block a*P/4, local (a % (4/P))*(n/4) + j +
    c*(n/16), j split into the ranks' shares), and each block runs the
    levels below on its points with its slice of the spectrum. ``owned``:
    csrc/segconv.cu's schedule of a cluster's window, the levels below the
    top pass run group by group (:func:`_owned_levels`,
    :func:`owned_schedule`'s groups)."""
    from pyaudiodsptools_tpu_torch.kernels.segconv import (block_threads,
                                                           owner_threads)

    n = plan.n
    ln = n.bit_length() - 1
    tw, spec = _tables(plan)
    if blocks == 1:
        sm = _padded(z)
        _levels(sm, ln, ln, tw, 0, spec)
        return sm[_pad(np.arange(n))]
    groups = block_threads(n // blocks) // owner_threads(n, blocks)
    P = blocks
    m = n // P
    lm = m.bit_length() - 1
    zq = [_padded(z[q * m:(q + 1) * m]) for q in range(P)]
    _cluster_top(zq, tw, ln, True)
    for q in range(P):
        args = (zq[q], lm, ln - 4, tw, 6 << (ln - 4), spec[q * m:(q + 1) * m])
        if owned:
            _owned_levels(*args, groups)
        else:
            _levels(*args)
    _cluster_top(zq, tw, ln, False)
    return np.concatenate([zq[q][_pad(np.arange(m))] for q in range(P)])


def _cluster_top(zq, tw, ln, forward):
    """csrc/window_fft.cuh's top pass of a window over a cluster of
    len(zq) blocks (pass_two_levels_cluster), each rank's share of j."""
    P = len(zq)
    q2 = 1 << (ln - 4)
    q1 = q2 << 2
    share = q2 // P
    for rank in range(P):
        j = rank * share + np.arange(share)
        w = [tw[p * q2 + j] for p in range(6)]
        where = [[(a * P // 4, _pad((a % (4 // P)) * q1 + j + c * q2))
                  for c in range(4)] for a in range(4)]
        x = [[zq[b][i] for b, i in row] for row in where]
        _two_levels_regs(x, w, forward)
        for a in range(4):
            for c in range(4):
                b, i = where[a][c]
                zq[b][i] = x[a][c]


def _center_half(sm, t, width, forward):
    """csrc/window_fft.cuh's center_forward_16 / _8 (``forward``) or
    center_inverse_16 / _8 on the items ``t``: the innermost pass without
    its spectrum multiply."""
    span = 4 * width
    i0 = t * span
    step = 16 // span
    x = [[sm[_pad(i0 + c + width * a)] for c in range(width)]
         for a in range(4)]

    def rows(sign):
        for a in range(4):
            if width == 4:
                x[a] = _dft4(x[a], sign)
            else:
                x[a] = [_c64(x[a][0] + x[a][1]), _c64(x[a][0] - x[a][1])]

    if forward:
        for c in range(width):
            col = _dft4([x[a][c] for a in range(4)], -1)
            for a in range(4):
                x[a][c] = _c64(col[a] * _W16[(step * c * a) & 15])
        rows(-1)
    else:
        rows(+1)
        for c in range(width):
            col = _dft4([_c64(x[a][c] * _W16[(16 - step * c * a) & 15])
                         for a in range(4)], +1)
            for a in range(4):
                x[a][c] = col[a]
    for a in range(4):
        for c in range(width):
            sm[_pad(i0 + c + width * a)] = x[a][c]


def _levels_half(sm, ln, lm_top, tw, tw_off, forward):
    """csrc/window_fft.cuh's forward_levels (``forward``) or
    inverse_levels: convolve_levels' passes down to the innermost pass's
    forward half, or from its inverse half back up."""
    passes = _level_passes(lm_top, tw_off)
    half = len(passes) // 2
    todo = passes[:half + 1] if forward else passes[half:]
    for kind, lm, off, k, fwd in todo:
        t = np.arange(1 << (ln - k))
        if kind == "two":
            _two_levels(sm, t, lm, tw, off, fwd)
        elif kind == "one":
            _one_level(sm, t, lm, tw, off, fwd)
        else:
            _center_half(sm, t, lm, forward)


# csrc/convpairs.cu's SPECTRAL_THREADS and SPECTRAL_SPLIT_THREADS
SPECTRAL_THREADS = 512
SPECTRAL_SPLIT_THREADS = 256


def _sum_slice(ring, spectra, pair, pts, here, plan, u_first, threads):
    """csrc/convpairs.cu's sum_slice on the spectrum points ``pts`` of one
    row pair: group g of the kernel's groups sums the partitions
    u_first + g, + G, ... in order, the groups' sums added in group
    order."""
    S = plan.slots
    lanes = (pts.stop - pts.start) // 2
    G = threads // lanes if threads > lanes else 1
    partial = []
    for grp in range(G):
        y = np.zeros(pts.stop - pts.start, np.complex64)
        for u in range(u_first + grp, len(plan.delays), G):
            s = (here - plan.delays[u] + S) % S
            y = _c64(y + _c64(ring[s, pair, pts] * spectra[u, pts]))
        partial.append(y)
    y = partial[0]
    for v in partial[1:]:
        y = _c64(y + v)
    return y


def emulate_spectral_step(ring: np.ndarray, inputs: np.ndarray, pos: int,
                          block: np.ndarray, plan):
    """csrc/convpairs.cu's delay-line step in numpy, on copies of the state:
    ``ring`` (S, pairs, n, 2) and ``inputs`` (R, T, B) float32, ``pos`` an
    int, ``block`` (R, B). Each row pair's window gathered by the kernel's
    index arithmetic (sample g of the block, or of the block d steps back in
    the input ring's slot (pos - d) % T) and transformed, its spectrum
    stored in slot pos % S. Up to 16,384 points the window in one block and
    SPECTRAL_BLOCKS slices of the spectrum summed beside it over the
    partitions of delay >= 1 (groups of lanes, every G-th partition, in
    order, the groups' partial sums added in group order), added to the
    window's spectrum times the delay-0 partition's where there is one;
    past it the window over a cluster of SPECTRAL_BLOCKS (the top pass, then
    each block's levels), each block's slice summed over every partition.
    Transformed back; the block into the input ring's slot pos % T. Returns
    (out, ring, inputs, next pos); output samples no block wrote are NaN."""
    from pyaudiodsptools_tpu_torch.kernels.convpairs import SPECTRAL_BLOCKS
    from pyaudiodsptools_tpu_torch.kernels.segconv import BLOCK_WINDOW

    n, S, T = plan.n, plan.slots, plan.inputs
    R, B = block.shape
    ln = n.bit_length() - 1
    split = n <= BLOCK_WINDOW
    P = 1 if split else SPECTRAL_BLOCKS
    m = n // P
    ring = _c64(ring[..., 0] + 1j * ring[..., 1])
    inputs = inputs.copy()
    tw = _c64(plan.twiddle.cpu().numpy() @ np.array([1, 1j]))
    spectra = plan.spectra.cpu().numpy()
    spectra = _c64(spectra[..., 0] + 1j * spectra[..., 1])
    out = np.full((R, B), np.nan, np.float32)
    g = np.arange(n) - (n - B)
    d = (B - 1 - g) // B
    at = ((pos % T - d + T) % T) * B + g + d * B
    here = pos % S
    for pair in range((R + 1) // 2):
        rows = [r for r in (2 * pair, 2 * pair + 1) if r < R]
        win = [np.where(g >= 0, block[r, np.clip(g, 0, B - 1)],
                        inputs[r].reshape(-1)[np.clip(at, 0, T * B - 1)])
               for r in rows]
        z = win[0] + 1j * (win[1] if len(win) > 1 else 0)
        if split:
            zq = [_padded(z)]
            _levels_half(zq[0], ln, ln, tw, 0, True)
        else:
            zq = [_padded(z[q * m:(q + 1) * m]) for q in range(P)]
            _cluster_top(zq, tw, ln, True)
            for q in range(P):
                _levels_half(zq[q], m.bit_length() - 1, ln - 4, tw,
                             6 << (ln - 4), True)
        for q in range(P):
            ring[here, pair, q * m:(q + 1) * m] = zq[q][_pad(np.arange(m))]
        if split:
            x = ring[here, pair]
            now = plan.delays[0] == 0
            h = n // SPECTRAL_BLOCKS
            y = np.concatenate([
                _sum_slice(ring, spectra, pair, slice(k * h, (k + 1) * h),
                           here, plan, int(now), SPECTRAL_SPLIT_THREADS)
                for k in range(SPECTRAL_BLOCKS)])
            if now:
                y = _c64(_c64(x * spectra[0]) + y)
            zq[0][_pad(np.arange(n))] = y
            _levels_half(zq[0], ln, ln, tw, 0, False)
        else:
            for q in range(P):
                zq[q][_pad(np.arange(m))] = _sum_slice(
                    ring, spectra, pair, slice(q * m, (q + 1) * m), here,
                    plan, 0, SPECTRAL_THREADS)
            for q in range(P):
                _levels_half(zq[q], m.bit_length() - 1, ln - 4, tw,
                             6 << (ln - 4), False)
            _cluster_top(zq, tw, ln, False)
        w = np.concatenate([zq[q][_pad(np.arange(m))] for q in range(P)])
        out[rows[0]] = w.real[n - B:]
        if len(rows) > 1:
            out[rows[1]] = w.imag[n - B:]
    inputs[:, pos % T] = block
    ring = np.stack([ring.real, ring.imag], -1).astype(np.float32)
    return out, ring, inputs, (pos + 1) % plan.period


def _pass_points(kind, lm, ln, t):
    """(items, points) array of the points of the block's 2^ln that each of
    the items ``t`` of a pass touches (csrc/window_fft.cuh's index maps)."""
    if kind == "two":
        q2 = 1 << (lm - 4)
        i0 = ((t >> (lm - 4)) << lm) + (t & (q2 - 1))
        offs = [c * q2 + a * 4 * q2 for a in range(4) for c in range(4)]
    elif kind == "one":
        q = 1 << (lm - 2)
        i0 = ((t >> (lm - 2)) << lm) + (t & (q - 1))
        offs = [k * q for k in range(4)]
    else:                                 # center: lm is its width
        i0 = t * 4 * lm
        offs = list(range(4 * lm))
    return i0[:, None] + np.asarray(offs)[None, :]


def owned_schedule(n: int, blocks: int) -> dict:
    """csrc/segconv.cu's transform in one block of an n-point window over
    ``blocks`` blocks, as the kernel shares it out: over a cluster the
    owned schedule (csrc/window_fft.cuh's ``convolve_levels_owned``), in
    one block the block-wide one (``convolve_levels``). ``passes`` in order,
    each a dict with ``name``, ``owner`` (the thread that touches each of
    the block's points in the pass; -1: none; -2: two threads) and
    ``barrier``, what the kernel waits at after it (``block``, ``cluster``,
    ``group``, ``warp``: ``owned_sync``'s rule, the cluster's barrier after
    the last); ``threads``, ``width`` (a group's threads) and ``m`` (the
    block's points). A cluster's top pass spans its blocks' points
    (distributed shared memory) and is left out: a cluster barrier lies on
    each side of it."""
    from pyaudiodsptools_tpu_torch.kernels.segconv import (block_threads,
                                                           owner_threads)

    m = n // blocks
    ln = m.bit_length() - 1
    lnw = n.bit_length() - 1
    threads = block_threads(m)
    width = owner_threads(n, blocks) if blocks > 1 else threads
    warps = threads // 32

    def owners(kind, lm, k):
        """Over a cluster for_warp_items: warp w takes the w-th equal run
        of the items, its lanes in turn; in one block thread by thread."""
        count = 1 << (ln - k)
        t = np.arange(count)
        per = count // warps
        thread = ((t // per) * 32 + (t % per) % 32 if blocks > 1
                  else t % threads)
        owner = np.full(m, -1)
        for col in _pass_points(kind, lm, ln, t).T:
            owner[col] = np.where(owner[col] == -1, thread, -2)
        return owner

    def barrier(ls):
        span = threads >> (ln - ls)
        return ("warp" if span <= 32 else
                "group" if span <= width < threads else "block")

    levels = _level_passes(lnw if blocks == 1 else lnw - 4, 0)
    passes = []
    for i, (kind, lm, _, k, fwd) in enumerate(levels):
        if blocks == 1:
            after = "block"
        elif i + 1 == len(levels):
            after = "cluster"
        else:
            # after a forward pass its own level, else the next pass's
            after = barrier(lm if fwd else levels[i + 1][1])
        passes.append({
            "name": kind + str(lm) + {True: "f", False: "i", None: ""}[fwd],
            "owner": owners(kind, lm, k), "barrier": after})
    return {"passes": passes, "threads": threads, "width": width, "m": m}


def emulate_segconv(x: np.ndarray, plan, blocks: int | None = None
                    ) -> np.ndarray:
    """One 'thread block' (or cluster of ``blocks``, the plan's version by
    default) per (channel, pair of windows): masked gather, transform,
    wrap-free store masked at T."""
    C, T = x.shape
    n, halo, seg, shift = plan.n, plan.halo, plan.seg, plan.shift
    blocks = plan.blocks if blocks is None else blocks
    n_seg = -(-T // seg)
    y = np.full_like(x, np.nan)

    def gather(c, idx):
        ok = (idx >= 0) & (idx < T)
        r = np.zeros(n, np.float32)
        r[ok] = x[c, idx[ok]]
        return r

    for c in range(C):
        for s0 in range(0, n_seg, 2):
            idx = s0 * seg - halo - shift + np.arange(n)
            a = gather(c, idx)
            b = gather(c, idx + seg) if s0 + 1 < n_seg else np.zeros(n, np.float32)
            z = emulate_window_fft(a + 1j * b, plan, blocks, owned=True)
            for part, s in ((z.real, s0), (z.imag, s0 + 1)):
                if s < n_seg:
                    o = s * seg
                    w = min(seg, T - o)
                    y[c, o:o + w] = part[halo:halo + w]
    y[:, :shift] = 0.0      # the store masks the output delay to silence
    return y


def _head_points(phase: int, s: int) -> int:
    """csrc/segconv.cu ``head_points``: samples from s to the row's first
    16-byte boundary at or after it, the row starting ``phase`` samples past
    one."""
    return (-(phase + s)) % 4


def segconv_whole_chunks(phase: int, o0: int, i_lo: int, m: int, T: int,
                         shift: int) -> tuple[int, int]:
    """csrc/segconv.cu ``whole_chunks``: the points [lo, hi) of [i_lo, m)
    whose outputs o0 + i lie on whole 16-byte chunks at or past ``shift``
    and below T."""
    lo, hi = i_lo, m
    if o0 + lo < shift:
        lo = shift - o0
    if o0 + hi > T:
        hi = T - o0
    if lo < hi:
        lo += _head_points(phase, o0 + lo)
        hi -= (4 - _head_points(phase, o0 + hi)) & 3
    return lo, max(hi, lo)


def emulate_segconv_store(z: np.ndarray, y: np.ndarray, phase: int, oa: int,
                          seg: int, i_lo: int, threads: int, T: int,
                          shift: int, has_b: bool, accumulate: bool,
                          points: int = 16, chunks: int = 4) -> dict:
    """One block's store of its wrap-free points i in [i_lo, m) (m =
    len(z), complex: window a real, b imaginary) into the row ``y`` (float32,
    changed in place), as csrc/segconv.cu's ``bulk_store`` (writing) or
    ``add_store`` (accumulating) does it. Returns what it did: the writing
    store's runs (row offset, length, offset in the block's shared memory),
    the points stored alone, every output sample touched and how often."""
    m = len(z)
    touched = {}

    def touch(o):
        touched[o] = touched.get(o, 0) + 1

    def store1(o, v):                    # csrc/segconv.cu store1
        if o >= T:
            return
        touch(o)
        if o < shift:
            if not accumulate:
                y[o] = 0.0
        else:
            y[o] = y[o] + v if accumulate else v

    wins = [(oa, z.real.astype(np.float32))]
    if has_b:
        wins.append((oa + seg, z.imag.astype(np.float32)))
    out = {"runs": [], "alone": 0, "touched": touched}
    if not accumulate:
        assert m - i_lo <= points * threads, (m, i_lo, threads)
        smem = np.full(2 * (m + m // 16), np.nan, np.float32)
        at = 0
        spans = []
        for o0, v in wins:
            lo, hi = segconv_whole_chunks(phase, o0, i_lo, m, T, shift)
            for i in range(i_lo, m):
                if not lo <= i < hi:
                    store1(o0 + i, v[i])
                    out["alone"] += 1
            spans.append((o0, v, lo, hi, at))
            at += hi - lo
        for o0, v, lo, hi, off in spans:       # after the barrier
            smem[off:off + hi - lo] = v[lo:hi]
        for o0, v, lo, hi, off in spans:       # the bulk copies
            if hi > lo:
                out["runs"].append((o0 + lo, hi - lo, off))
                y[o0 + lo:o0 + hi] = smem[off:off + hi - lo]
                for o in range(o0 + lo, o0 + hi):
                    touch(o)
        return out
    first = min(m, i_lo + _head_points(phase, oa + i_lo))
    nb2 = (m - first) // 4
    assert nb2 <= chunks * threads, (nb2, threads)
    loaded = {}
    for q in range(nb2):                       # every load first
        for o0, _ in wins:
            o = o0 + first + 4 * q
            if o >= shift and o + 4 <= T:
                assert _head_points(phase, o) == 0
                loaded[o] = y[o:o + 4].copy()
    for q in range(nb2):
        i = first + 4 * q
        for o0, v in wins:
            o = o0 + i
            if o >= shift and o + 4 <= T:
                y[o:o + 4] = loaded.pop(o) + v[i:i + 4]
                for e in range(4):
                    touch(o + e)
            else:
                for e in range(4):
                    store1(o + e, v[i + e])
    assert not loaded
    for i in list(range(i_lo, first)) + list(range(first + 4 * nb2, m)):
        for o0, v in wins:
            store1(o0 + i, v[i])
            out["alone"] += 1
    return out


def emulate_convpairs(flat: np.ndarray, plan) -> np.ndarray:
    """csrc/convpairs.cu: one 'thread block' per pair of rows (row 2p in the
    real part, row 2p+1 in the imaginary part, an odd last row alone), the
    window transform, all n samples stored."""
    R, n = flat.shape
    out = np.full((R, n), np.nan, np.float32)
    for r0 in range(0, R, 2):
        has_b = r0 + 1 < R
        b = flat[r0 + 1] if has_b else np.zeros(n, np.float32)
        z = emulate_window_fft(flat[r0] + 1j * b, plan)
        out[r0] = z.real
        if has_b:
            out[r0 + 1] = z.imag
    return out


def emulate_convpairs_step(hist: np.ndarray, block: np.ndarray, plan):
    """csrc/convpairs.cu's step entry point: sample i of row r's window is
    ``hist[r, i]`` below the history's length and ``block[r, i - H]`` from
    there on; the pairs go through the window transform; only the last B
    samples are kept; the next history is the source from sample B on."""
    R, H = hist.shape
    B = block.shape[1]
    n = plan.n

    def source(r, idx):
        from_hist = idx < H
        v = np.empty(len(idx), np.float32)
        v[from_hist] = hist[r, idx[from_hist]]
        v[~from_hist] = block[r, idx[~from_hist] - H]
        return v

    window = np.stack([source(r, np.arange(n)) for r in range(R)])
    out = emulate_convpairs(window, plan)[:, n - B:]
    nxt = np.stack([source(r, B + np.arange(H)) for r in range(R)])
    return out, nxt


def emulate_stream_step(hist: np.ndarray, block: np.ndarray, parts,
                        convolve=None):
    """The launches of ``kernels/convpairs.stream_step`` in order: part p's
    window is ``concat(hist, block)[:, start : start + n]``, gathered from
    the two arrays by the sample index as the kernel does; its last ``keep``
    samples go to the output at ``out0``, or are added there in float32
    (``add``); the first part whose window starts at 0 writes the next
    history. ``convolve(window, plan)`` is the window's circular convolution,
    (R, n) float32 -> (R, n) float32: the numpy mirror of the transform by
    default; the card's own kernel where a test holds the kernel's schedule
    bit for bit. Output samples no part has written yet are NaN, so a part
    that adds before any wrote shows."""
    convolve = convolve or emulate_convpairs
    R, H = hist.shape
    B = block.shape[1]
    out = np.full((R, B), np.nan, np.float32)
    nxt = None
    for part in parts:
        n = part.plan.n
        idx = part.start + np.arange(n)
        window = np.ascontiguousarray(np.where(
            idx < H, hist[:, np.clip(idx, 0, H - 1)],
            block[:, np.clip(idx - H, 0, B - 1)]), dtype=np.float32)
        y = convolve(window, part.plan)[:, n - part.keep:]
        dst = slice(part.out0, part.out0 + part.keep)
        out[:, dst] = out[:, dst] + y if part.add else y
        if nxt is None and part.start == 0:
            src = B + np.arange(H)
            nxt = np.ascontiguousarray(np.where(
                src < H, hist[:, np.clip(src, 0, H - 1)],
                block[:, np.clip(src - H, 0, B - 1)]))
    return out, nxt


# ---------------------------------------------------------------------------
# csrc/tail.cu in numpy

_F = np.float32


def _map_np(code: int, st, v: np.ndarray) -> np.ndarray:
    v = v.astype(_F)
    if code == 0:    # saturator
        coeff, makeup, mode = _F(st.p0), _F(st.p1), st.b
        a = np.abs(v)
        over = a - coeff
        ratio = over / (_F(1.0) - coeff)
        if mode == 2:
            ratio = ratio * ratio
        shaped = coeff + over / (_F(1.0) + ratio)
        a = np.where(a > coeff, shaped, a)
        a = np.where(a > 1.0, (coeff + _F(1.0)) / _F(2.0), a)
        return (makeup * np.where(v < 0, -a, a)).astype(_F)
    if code == 1:    # softclipper
        a = np.minimum(np.abs(v), _F(1.0))
        a = _F(-1.0) * np.power(np.abs(a - _F(1.0)), _F(st.p0)) + _F(1.0)
        return np.where(v < 0, -a, a).astype(_F)
    if code == 2:    # harddistortion
        sign = np.where(v >= 0, _F(1.0), _F(-1.0))
        amp = np.abs(v)
        amp = np.where(amp <= _F(0.8), amp, sign)
        scale = _F(1.0 - 0.8)
        comp = scale * np.sin((amp - _F(0.8)) / scale).astype(_F)
        return ((_F(0.8) + comp) * sign).astype(_F)
    with np.errstate(invalid="ignore"):     # NaN: a ring slot never stored
        q32 = (v * _F(32767.0)).astype(np.int32)       # bitcrusher
    q16 = (q32 & 0xFFFF).astype(np.uint16).view(np.int16)
    return ((q16 >> 9).astype(_F) / _F(64.0)).astype(_F)


def _tail_table(plan):
    """csrc/tail.cu's stage table, decoded as the kernel reads it."""
    from types import SimpleNamespace

    tab = plan.table.cpu().numpy().astype(np.int32)
    ns, n_taps, first, last = (int(v) for v in tab[:4])

    def stage(k):
        w = tab[8 + 8 * k:16 + 8 * k]
        f = w.view(np.float32)
        return SimpleNamespace(kind=int(w[0]), a=int(w[1]), b=int(w[2]),
                               off=int(w[3]), len=int(w[4]), p0=_F(f[5]),
                               p1=_F(f[6]), next=int(w[7]))

    base = 8 + 8 * ns
    offsets = tab[base:base + n_taps]
    weights = tab[base + n_taps:base + 2 * n_taps].view(np.float32)
    return ns, first, last, [stage(k) for k in range(ns)], offsets, weights


def _ring4(buf, s):
    """csrc/tail.cu's ring4 on many slots at once: two aligned 4-float reads
    (the second wrapped at the ring's end) and the select by s & 3."""
    n = len(buf)
    a = s & ~3
    b = np.where(a + 4 == n, 0, a + 4)
    both = np.concatenate([buf[a[:, None] + np.arange(4)],
                           buf[b[:, None] + np.arange(4)]], axis=1)
    return both[np.arange(len(s))[:, None], (s & 3)[:, None] + np.arange(4)]


def emulate_tail(x: np.ndarray, gains, plan, runs: int) -> np.ndarray:
    """csrc/tail.cu's schedule, from the plan's own table: one 'thread
    block' per (channel, run of ``ceil(n_tiles / runs)`` tiles); rings laid
    out and indexed (slot = time mod ring length) as the kernel does, zeroed
    for a run from the signal start and full of NaN otherwise (the walk over
    the halo's tiles must wash them out); the next tile landing in its slots
    before the current one is worked on (a ring too short for it would be
    read after it was overwritten); per tile: the pointwise run before the
    first taps
    stage in place, every taps stage but the last into the next one's ring,
    and the store (last taps stage four positions at a time through ring4,
    then the pointwise run after it)."""
    C, T = x.shape
    S, ring_floats = plan.tile, plan.ring_floats
    ns, first, last, st, offsets, weights = _tail_table(plan)
    n_tiles = -(-T // S)
    per_run = -(-n_tiles // runs)
    out = np.full_like(x, np.nan)

    def pointwise(k, v, t):
        if st[k].kind == 1:
            g = gains[st[k].a, np.minimum(t, T - 1)].astype(_F)
            return np.where(t < T, v * g, v).astype(_F)
        return _map_np(st[k].a, st[k], v)

    def ring_back(s, d, n):
        r = s - d
        return np.where(r < 0, r + n, r)

    for c in range(C):
        for r in range(runs):
            i_out = r * per_run
            i_end = min(n_tiles, i_out + per_run)
            i_first = max(0, i_out - plan.warm_tiles)
            ring = (np.zeros if i_first == 0 else
                    lambda n: np.full(n, np.nan))(ring_floats).astype(_F)
            off1, len1 = (st[first].off, st[first].len) if first >= 0 \
                else (0, ring_floats)

            def load(i):
                if i < i_end:
                    t0 = i * S
                    w = min(S, T - t0)
                    ring[off1 + t0 % len1 + np.arange(w)] = x[c, t0:t0 + w]

            load(i_first)
            for i in range(i_first, i_end):
                load(i + 1)
                t0 = i * S
                width = min(S, T - t0)
                p = np.arange(width)
                ts1 = t0 % len1
                if first > 0:
                    v = ring[off1 + ts1 + p]
                    for k in range(first):
                        v = pointwise(k, v, t0 + p)
                    ring[off1 + ts1 + p] = v
                k = first
                while k >= 0 and k != last:
                    s_, nx = st[k], st[st[k].next]
                    buf = ring[s_.off:s_.off + s_.len]
                    slot = t0 % s_.len + p
                    acc = (s_.p0 * buf[slot]).astype(_F)
                    for j in range(s_.b):
                        v = buf[ring_back(slot, offsets[s_.a + j], s_.len)]
                        acc = (acc + weights[s_.a + j] * v).astype(_F)
                    for j in range(k + 1, s_.next):
                        acc = pointwise(j, acc, t0 + p)
                    ring[nx.off + t0 % nx.len + p] = acc
                    k = s_.next
                if i < i_out:
                    continue
                p4 = np.arange(0, width, 4)
                t4 = t0 + p4[:, None] + np.arange(4)
                if last >= 0:
                    lt = st[last]
                    buf = ring[lt.off:lt.off + lt.len]
                    slot = t0 % lt.len + p4
                    v = _ring4(buf, slot)
                    acc = (lt.p0 * v).astype(_F)
                    for j in range(lt.b):
                        v = _ring4(buf, ring_back(slot, offsets[lt.a + j],
                                                  lt.len))
                        acc = (acc + weights[lt.a + j] * v).astype(_F)
                else:
                    acc = ring[off1 + ts1 + p4[:, None] + np.arange(4)]
                for k in range(last + 1 if last >= 0 else 0, ns):
                    acc = pointwise(k, acc, t4)
                keep = t4 < t0 + width
                out[c, t4[keep]] = acc[keep]
    return out


# ---------------------------------------------------------------------------
# csrc/dynamics.cu in numpy: one thread's walk


def emulate_walk(scalars, x_lane: np.ndarray, entry, audio: bool = True,
                 loud: list | None = None):
    """One lane of csrc/dynamics.cu: walk ``x_lane`` (L,) float32 through
    the cascade ``scalars`` (one tuple per op, as
    ``kernels.dynamics.op_scalars`` gives them) from the per-op ``entry``
    states. Returns (out (L,) float32 or None, exit states). Without
    ``audio`` the last op computes no gain, as in the state-walk kernel.
    ``loud``, one bool per op, is set where the op saw a sample over its
    threshold (the serial walk's kernel notes it)."""
    s = [int(v) for v in entry]
    n_ops = len(scalars)
    out = np.empty(len(x_lane), _F) if audio else None
    for l, v in enumerate(x_lane):
        row = _F(v)
        for j, (thr, pre, ratio, att_step, rel0, rel_step, x_max, end) \
                in enumerate(scalars):
            over = abs(row) > thr
            if over and loud is not None:
                loud[j] = True
            sj = s[j]
            if audio or j + 1 < n_ops:
                if sj <= 0:
                    gain = _F(1.0)
                elif sj < x_max:
                    gain = _F(_F(1.0) + _F(_F(sj) * att_step))
                elif over:
                    gain = ratio
                else:
                    gain = _F(rel0 + _F(_F(_F(sj) - _F(x_max)) * rel_step))
                row = _F(_F(row * pre) * gain)
            if sj < 0:                  # skip consumes itself
                s[j] = 0
            elif sj == 0:               # REST: trigger
                s[j] = 1 if over else 0
            elif sj < x_max:            # ATTACK ignores the mask
                s[j] = sj + 1
            elif over:                  # HOLD stays / RELEASE re-triggers
                s[j] = x_max
            else:                       # release advances; done -> skip
                s[j] = -1 if sj + 1 == end else sj + 1
        if audio:
            out[l] = row
    return out, s


def advance_quiet(sc: tuple, s: int, d: int) -> int:
    """csrc/dynamics.cu's closed form: state ``s`` of the op with scalars
    ``sc`` after ``d`` samples none of which is over its threshold."""
    end = sc[7]
    if d == 0:
        return s
    if s <= 0:
        return 0
    t = s + d
    return t if t < end else (-1 if t == end else 0)


def emulate_serial_walk(scalars, x_chan: np.ndarray, entry, lseg: int,
                        threads: int, guess_offset: int = 0):
    """One channel of csrc/dynamics.cu's serial walk kernel, schedule and
    all: tiles of ``threads`` segments of ``2**lseg`` samples, one 'thread'
    a segment; the first guess is the carried state advanced in closed form;
    every round walks every segment with audio (:func:`emulate_walk`), then
    each segment compares its entry with its left neighbour's exit and takes
    its next entry from the nearest segment to the left where the op saw a
    loud sample, advanced in closed form over the quiet ones between; the
    loop ends with the round in which no entry differed. Returns (out (T,),
    exit states, rounds summed over the tiles). ``guess_offset`` shifts the
    first guess (a wrong guess must only cost rounds)."""
    L, G = 1 << lseg, threads
    n_ops = len(scalars)
    carried = [int(v) for v in entry]
    T = len(x_chan)
    out = np.empty(T, _F)
    rounds = 0
    for t0 in range(0, T, G * L):
        tile = x_chan[t0:t0 + G * L]
        last = (len(tile) - 1) >> lseg
        segs = [tile[g * L:(g + 1) * L] for g in range(last + 1)]
        e = [[advance_quiet(scalars[j], carried[j],
                            g * L + (guess_offset if g else 0))
              for j in range(n_ops)] for g in range(last + 1)]
        while True:
            exits, louds, outs = [], [], []
            for g, seg in enumerate(segs):
                loud = [False] * n_ops
                o, z = emulate_walk(scalars, seg, e[g], loud=loud)
                outs.append(o)
                exits.append(z)
                louds.append(loud if g else [True] * n_ops)
            rounds += 1
            changed = False
            new_e = [e[0]]
            for g in range(1, last + 1):
                changed = changed or exits[g - 1] != e[g]
                row = []
                for j in range(n_ops):
                    h = g - 1
                    while not louds[h][j]:
                        h -= 1
                    row.append(advance_quiet(scalars[j], exits[h][j],
                                             (g - 1 - h) * L))
                new_e.append(row)
            e = new_e
            carried = exits[last]
            if not changed:
                break
        out[t0:t0 + len(tile)] = np.concatenate(outs)
    return out, carried, rounds


def _automaton_rows(sc: tuple, s: np.ndarray, row: np.ndarray,
                    with_gain: bool):
    """One sample of one op on every row at once: csrc/dynamics.cu's
    automaton<> as numpy selects, each product and sum rounded to float32
    on its own. Returns (output, next states)."""
    thr, pre, ratio, att_step, rel0, rel_step, x_max, end = sc
    over = np.abs(row) > thr
    pos = s > 0
    in_att = pos & (s < x_max)
    out = row
    if with_gain:
        s_f = s.astype(_F)
        att_g = _F(1.0) + s_f * att_step
        rel_g = rel0 + (s_f - _F(x_max)) * rel_step
        hi_g = np.where(over, ratio, rel_g)
        gain = np.where(pos, np.where(in_att, att_g, hi_g), _F(1.0))
        out = ((row * pre) * gain).astype(_F)
    sp1 = s + 1
    rel_next = np.where(sp1 == end, -1, sp1)
    hi_next = np.where(over, x_max, rel_next)
    n = np.where(in_att, sp1, hi_next)
    n = np.where(s == 0, over.astype(np.int64), n)
    n = np.where(s < 0, 0, n)
    return out, n


def emulate_tile_walk(scalars, x: np.ndarray, G: int, L: int, entry,
                      audio: bool = True, tile_rows: int = 128,
                      tile_k: int = 32, stages: int = 3):
    """csrc/dynamics.cu's offline walk on x (C, T) float32, cut into G
    segments of L samples a channel, from ``entry`` (n_ops, C*G), lane
    g*C + c: block b takes rows b*tile_rows ... of the (C*G, L) view (row
    c*G + g), tiles of ``tile_k`` samples come through a ring of ``stages``
    slots (a copy lands ``stages - 1`` tiles ahead of the walk, into the slot
    the tile before left; a slot holds NaN until its first copy), each row
    zero-filled past its length (L, or what is left of T in the last
    segment); the walk goes sample by sample over every row of the block at
    once, with audio into one of two output tiles, which the block stores
    at the next tile's barrier, masked to the row's length. Returns (out
    (C, T) float32 or None; NaN where nothing was stored, exit states
    (n_ops, C*G) int32)."""
    C, T = x.shape
    R = C * G
    n_ops = len(scalars)
    flat = np.ascontiguousarray(x, dtype=_F).reshape(-1)
    out = np.full(C * T, np.nan, _F) if audio else None
    exits = np.zeros((n_ops, R), np.int32)
    ntiles = -(-L // tile_k)
    for v0 in range(0, R, tile_rows):
        v = np.arange(v0, min(R, v0 + tile_rows))
        c, g = v // G, v % G
        lanes = g * C + c
        off = c * T + g * L
        length = np.where(g == G - 1, T - g * L, L)
        s = [np.asarray(entry[j], np.int64)[lanes] for j in range(n_ops)]
        ring = np.full((stages, len(v), tile_k), np.nan, _F)
        otile = np.full((2, len(v), tile_k), np.nan, _F)

        def load(t, slot):
            k0 = t * tile_k
            for r in range(len(v)):
                n = max(0, min(tile_k, int(length[r]) - k0))
                ring[slot, r, :n] = flat[off[r] + k0:off[r] + k0 + n]
                ring[slot, r, n:] = 0.0

        def store(t, src):
            k0 = t * tile_k
            for r in range(len(v)):
                n = max(0, min(tile_k, int(length[r]) - k0))
                out[off[r] + k0:off[r] + k0 + n] = src[r, :n]

        for p in range(stages - 1):
            if p < ntiles:
                load(p, p)
        for t in range(ntiles + 1):
            if audio and t > 0:
                store(t - 1, otile[(t - 1) & 1])
                otile[(t - 1) & 1] = np.nan       # free for tile t + 1
            if t == ntiles:
                break
            tn = t + stages - 1
            if tn < ntiles:
                load(tn, tn % stages)
            tile = ring[t % stages]
            for k in range(min(tile_k, L - t * tile_k)):
                row = tile[:, k]
                for j, sc in enumerate(scalars):
                    row, s[j] = _automaton_rows(
                        sc, s[j], row, audio or j + 1 < n_ops)
                if audio:
                    otile[t & 1][:, k] = row
            ring[t % stages] = np.nan             # the next copy's slot
        for j in range(n_ops):
            exits[j, lanes] = s[j]
    return (out.reshape(C, T) if audio else None), exits


# csrc/relayout.cu's tile (TL rows x TR lanes), the floats along a TMA box's
# contiguous axis, and the threads of a block
RELAYOUT_TL, RELAYOUT_TR, RELAYOUT_SUB, RELAYOUT_THREADS = 128, 64, 32, 256


def relayout_box_launch(C: int, T: int, L: int, Rp: int,
                        pointers_aligned: bool = True) -> bool:
    """csrc/relayout.cu ``box_launch``: whether an unpack may send tiles down
    the box path (the tensor map's 16-byte base and row stride, whole
    16-byte vectors along T, L and Rp, at least one tile of channels)."""
    return (T % 4 == 0 and L % 4 == 0 and Rp % 4 == 0 and pointers_aligned
            and C >= RELAYOUT_TR)


def relayout_tiles(C: int, T: int, G: int, L: int, Rp: int,
                   pointers_aligned: bool = True) -> dict:
    """A launch's grid on tile coordinates alone: ``grid`` (row tiles,
    lane tiles) as gridDim (x, y), and for each lane tile ``r0`` its segment
    ``g``, first channel ``c0`` and, for an unpack, ``box`` (True: the box
    path, else the masked path; the same for every row tile of the
    column)."""
    tiles_l = -(-L // RELAYOUT_TL)
    tiles_r = -(-Rp // RELAYOUT_TR)
    ok = relayout_box_launch(C, T, L, Rp, pointers_aligned)
    r0 = np.arange(tiles_r, dtype=np.int64) * RELAYOUT_TR
    g, c0 = r0 // C, r0 % C
    box = ok & (g < G) & (c0 + RELAYOUT_TR <= C)
    return {"grid": (tiles_l, tiles_r), "box_launch": ok, "r0": r0, "g": g,
            "c0": c0, "box": box}


def _swizzled(rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Float offset of element (row, col) of a box of 32-float rows in the
    128-byte swizzle (csrc/relayout.cu ``swz``)."""
    return (rows * RELAYOUT_SUB + (((cols // 4) ^ (rows % 8)) * 4)
            + cols % 4)


def emulate_relayout_pack(x: np.ndarray, G: int, L: int, Rp: int):
    """csrc/relayout.cu's pack, tile by tile, in numpy: each tile of 128
    rows x 64 lanes read lane by lane along time (zeros for pad lanes and
    past a lane's valid samples) and stored row by row along lanes, rows
    past L and lanes past Rp left out. Returns (tm (L, Rp), writes (L, Rp):
    how often each element was stored)."""
    C, T = x.shape
    TL, TR = RELAYOUT_TL, RELAYOUT_TR
    tiles_l, tiles_r = -(-L // TL), -(-Rp // TR)
    tm = np.full((L, Rp), np.nan, np.float32)
    writes = np.zeros((L, Rp), np.int64)
    for lt in range(tiles_l):
        l = lt * TL + np.arange(TL)
        for rt in range(tiles_r):
            r = rt * TR + np.arange(TR)
            gr, c = r // C, r % C
            valid = np.where(r < C * G, np.minimum(L, T - gr * L), 0)
            t = np.minimum(gr[:, None] * L + l[None, :], T - 1)
            tile = np.where(l[None, :] < valid[:, None],
                            x[np.minimum(c, C - 1)[:, None], t], 0.0)
            rm, lm = r < Rp, l < L
            tm[np.ix_(l[lm], r[rm])] = tile[np.ix_(rm, lm)].T
            writes[np.ix_(l[lm], r[rm])] += 1
    return tm, writes


def emulate_relayout_unpack(tm: np.ndarray, C: int, T: int, G: int, L: int,
                            pointers_aligned: bool = True):
    """csrc/relayout.cu's unpack, tile by tile, in numpy: box tiles through
    two TMA boxes of tm seen as (L, Rp) (zeros past L), each thread's two
    4 x 4 blocks read as four 16-byte rows and stored as four transposed
    16-byte vectors along time where l < L and t < T; masked tiles lane by
    lane. Returns (y (C, T), writes (C, T))."""
    TL, TR, SUB = RELAYOUT_TL, RELAYOUT_TR, RELAYOUT_SUB
    Rp = tm.shape[1]
    plan = relayout_tiles(C, T, G, L, Rp, pointers_aligned)
    y = np.full((C, T), np.nan, np.float32)
    writes = np.zeros((C, T), np.int64)
    tmz = np.concatenate([tm, np.zeros((TL, Rp), np.float32)], axis=0)
    # unpack's 4 x 4 blocks: block b = threadIdx + n*THREADS (n = 0, 1)
    # takes lane chunk b % 8 of its sub-tile, row group (b // 8) % 32,
    # sub-tile (b // 8) // 32
    b = np.arange(2 * RELAYOUT_THREADS)
    qb8, kb, s = b % 8, (b // 8) % (TL // 4), (b // 8) // (TL // 4)
    for lt in range(plan["grid"][0]):
        l0 = lt * TL
        for rt in range(plan["grid"][1]):
            r0, g, c0 = (int(plan[k][rt]) for k in ("r0", "g", "c0"))
            if plan["box"][rt]:
                tile = np.full(TL * TR, np.nan, np.float32)
                rows, cols = np.meshgrid(np.arange(TL), np.arange(SUB),
                                         indexing="ij")
                for b in range(TR // SUB):           # rows past L: zeros
                    tile[b * SUB * TL + _swizzled(rows, cols)] = \
                        tmz[l0 + rows, r0 + b * SUB + cols]
                l = l0 + 4 * kb
                m = (l < L) & (g * L + l < T)
                for j in range(4):
                    for i in range(4):
                        v = tile[s * SUB * TL
                                 + _swizzled(4 * kb + i, 4 * qb8 + j)]
                        c = c0 + s * SUB + 4 * qb8 + j
                        t = g * L + l + i
                        y[c[m], t[m]] = v[m]
                        np.add.at(writes, (c[m], t[m]), 1)
                continue
            r = r0 + np.arange(TR)
            l = l0 + np.arange(TL)
            rm = r < C * G
            tile = np.where((l[None, :] < L) & rm[:, None],
                            tmz[l[None, :], np.minimum(r, Rp - 1)[:, None]],
                            0.0)
            gr, c = r // C, r % C
            valid = np.where(rm, np.minimum(L, T - gr * L), 0)
            m = l[None, :] < valid[:, None]
            cc = np.broadcast_to(c[:, None], m.shape)[m]
            tt = (gr[:, None] * L + l[None, :])[m]
            y[cc, tt] = tile[m]
            np.add.at(writes, (cc, tt), 1)
    return y, writes
