"""Helpers shared by the tests of the PyTorch/CUDA port (tests/test_torch_*).

* ``snr_db`` -- signal-to-error ratio.
* ``spec_from_jax`` -- the plain numpy description of JAX effects that
  ``pyaudiodsptools_tpu_torch.convert.chain_from_numpy`` takes. The port
  imports no JAX, so the extraction lives here.
* ``emulate_segconv`` / ``emulate_convpairs`` / ``emulate_tail`` -- numpy
  mirrors of the CUDA kernels' schedules (csrc/segconv.cu and
  csrc/convpairs.cu with their shared csrc/window_fft.cuh, csrc/tail.cu):
  same passes, same tables, same in-place order, float32 throughout. The CUDA sources cannot
  run without a card; the mirrors let the CPU tests hold the kernels'
  ALGORITHMS (twiddle and spectrum tables, digit-reversed order, the in-place
  tap walk, the re-zeroing rule) against the plain versions.
* ``emulate_walk`` -- csrc/dynamics.cu's walk of ONE lane as a scalar numpy
  loop: the single-int automaton written the way the CUDA thread runs it
  (branches instead of selects, one rounded float32 operation at a time), a
  third reading of ``dynamics_pallas._int_automaton`` beside the JAX kernel
  and the port's tensor code.
* ``emulate_serial_walk`` / ``advance_quiet`` -- the serial walk kernel's
  schedule for one channel: tiles, segments, the closed-form first guess, the
  fixpoint rounds with the jump over quiet segments; returns its round count.
* ``emulate_convpairs_step`` -- the step entry point of csrc/convpairs.cu:
  the window gathered from history and block, the kept samples, the next
  history.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def snr_db(golden, ours) -> float:
    golden = np.asarray(golden, dtype=np.float64)
    ours = np.asarray(ours, dtype=np.float64)
    assert golden.shape == ours.shape, (golden.shape, ours.shape)
    err = np.sum((golden - ours) ** 2)
    if err == 0:
        return np.inf
    return 10.0 * np.log10(np.sum(golden ** 2) / err)


def conv_oracle(x: np.ndarray, kernel: np.ndarray, shift: int = 0) -> np.ndarray:
    """float64 ``y[c, m] = conv(x[c], kernel)[m - shift]``, length T."""
    C, T = x.shape
    ref = np.stack([np.convolve(x[c].astype(np.float64), kernel)[:T]
                    for c in range(C)])
    if shift:
        ref = np.concatenate([np.zeros((C, shift)), ref[:, :T - shift]], axis=1)
    return ref


def spec_from_jax(effects) -> list[dict]:
    """One plain dict per JAX effect: array leaves as numpy, static fields
    as they are, ``lti_kernel`` as float64."""
    spec = []
    for e in effects:
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


def emulate_window_fft(z: np.ndarray, plan) -> np.ndarray:
    """One complex window through csrc/window_fft.cuh's passes, with its index
    arithmetic: padded shared memory, per-pass twiddle rows indexed by j, two
    radix-4 levels per pass (one alone if the outer levels are odd in
    number), constant 16th roots, and the innermost pass that runs the last
    forward levels, the spectrum multiply and the first inverse levels on 16
    (or 8) neighbouring points."""
    n = plan.n
    ln = n.bit_length() - 1
    tw = plan.twiddle.cpu().numpy()
    tw = _c64(tw[:, 0] + 1j * tw[:, 1])
    spec = plan.spectrum_dif.cpu().numpy()
    spec = _c64(spec[:, 0] + 1j * spec[:, 1])
    sm = np.full(n + (n >> 4), np.nan + 0j, dtype=np.complex64)
    sm[_pad(np.arange(n))] = _c64(z)

    def one_level(off, lm, forward):
        q = 1 << (lm - 2)
        t = np.arange(1 << (ln - 2))
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

    def two_levels(off, lm, forward):
        lq2 = lm - 4
        q2, q1 = 1 << lq2, 1 << (lq2 + 2)
        t = np.arange(1 << (ln - 4))
        j = t & (q2 - 1)
        i0 = ((t >> lq2) << lm) + j
        w = [tw[off + p * q2 + j] for p in range(6)]
        x = [[sm[_pad(i0 + c * q2 + a * q1)] for c in range(4)]
             for a in range(4)]

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
        for a in range(4):
            for c in range(4):
                sm[_pad(i0 + c * q2 + a * q1)] = x[a][c]

    def center(width):
        """width 4: levels 16 and 4; width 2: level 8 and the radix-2 level."""
        span = 4 * width
        i0 = np.arange(n // span) * span
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

    from pyaudiodsptools_tpu_torch.kernels.segconv import pass_schedule

    offsets, off = [], 0
    for kind, lm in pass_schedule(n):
        offsets.append(off)
        off += (6 << (lm - 4)) if kind == "two" else (3 << (lm - 2))
    passes = list(zip(pass_schedule(n), offsets))
    for (kind, lm), off in passes:
        (two_levels if kind == "two" else one_level)(off, lm, True)
    center(2 if ln & 1 else 4)
    for (kind, lm), off in reversed(passes):
        (two_levels if kind == "two" else one_level)(off, lm, False)
    return sm[_pad(np.arange(n))]


def emulate_segconv(x: np.ndarray, plan) -> np.ndarray:
    """One 'thread block' per (channel, pair of windows): masked gather,
    transform, wrap-free store masked at T."""
    C, T = x.shape
    n, halo, seg, shift = plan.n, plan.halo, plan.seg, plan.shift
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
            z = emulate_window_fft(a + 1j * b, plan)
            for part, s in ((z.real, s0), (z.imag, s0 + 1)):
                if s < n_seg:
                    o = s * seg
                    w = min(seg, T - o)
                    y[c, o:o + w] = part[halo:halo + w]
    y[:, :shift] = 0.0      # the store masks the output delay to silence
    return y


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
    q32 = (v * _F(32767.0)).astype(np.int32)           # bitcrusher
    q16 = (q32 & 0xFFFF).astype(np.uint16).view(np.int16)
    return ((q16 >> 9).astype(_F) / _F(64.0)).astype(_F)


def emulate_tail(x: np.ndarray, gains, table, S: int, threads: int = 64
                 ) -> np.ndarray:
    """One 'thread block' per (channel, tile): load tile + halo, run the
    stage table on the resident window (earlier taps stages in place,
    top-down in chunks of ``threads`` positions: all reads of a chunk, then
    its writes; the last taps stage straight from the window), store."""
    C, T = x.shape
    D = table.halo
    out = np.full_like(x, np.nan)
    last_taps = max((k for k in range(table.n_stages)
                     if table.stages[k].kind == 0), default=-1)
    for c in range(C):
        for t0 in range(0, T, S):
            width = min(S, T - t0)
            W = D + width
            first = t0 - D
            tt = first + np.arange(W)
            w = np.where(tt >= 0, x[c, np.clip(tt, 0, T - 1)], 0).astype(_F)
            for k in range(table.n_stages):
                st = table.stages[k]
                lo = st.lo      # the stage computes [lo, W) only
                if st.kind == 0:
                    # the last taps stage is evaluated while storing, all
                    # reads from the untouched window: one "chunk"
                    step = W if k == last_taps else threads
                    hi = W
                    while hi > lo:
                        j = np.arange(max(hi - step, lo), hi)
                        acc = _F(st.p0) * w[j]
                        for i in range(st.b):
                            jj = j - table.offsets[st.a + i]
                            v = np.where(jj >= 0, w[np.clip(jj, 0, None)], 0)
                            acc = (acc + _F(table.weights[st.a + i])
                                   * v.astype(_F)).astype(_F)
                        if st.zero_after:
                            acc = np.where(first + j < 0, 0, acc).astype(_F)
                        w[j] = acc          # after the chunk's barrier
                        hi -= step
                else:
                    if st.kind == 1:
                        g = gains[st.a, np.clip(tt, 0, T - 1)].astype(_F)
                        v = np.where(tt >= 0, w * g, w).astype(_F)
                    else:
                        v = _map_np(st.a, st, w)
                    if st.zero_after:
                        v = np.where(tt < 0, 0, v).astype(_F)
                    w[lo:] = v[lo:]
            out[c, t0:t0 + width] = w[D:D + width]
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
                        threads: int, guess_offset: int = 0,
                        quiet_jump: bool = True):
    """One channel of csrc/dynamics.cu's serial walk kernel, schedule and
    all: tiles of ``threads`` segments of ``2**lseg`` samples, one 'thread'
    a segment; the first guess is the carried state advanced in closed form;
    every round walks every segment with audio (:func:`emulate_walk`), then
    each segment compares its entry with its left neighbour's exit and takes
    its next entry from the nearest segment to the left where the op saw a
    loud sample, advanced in closed form over the quiet ones between; the
    loop ends with the round in which no entry differed. Returns (out (T,),
    exit states, rounds summed over the tiles). ``guess_offset`` shifts the
    first guess (a wrong guess must only cost rounds). ``quiet_jump=False``
    is the kernel's other instantiation: every next entry is the left
    neighbour's exit."""
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
                    while quiet_jump and not louds[h][j]:
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
