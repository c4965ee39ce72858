"""3-band EQ, biquad (time-domain) form.

Counterpart of ``pyaudiodsptools_tpu/ops/eq3band.py``. Parity target:
pyAudioDspTools ``EffectEQ3Band.py``: RBJ Audio-EQ-Cookbook biquads, a low
shelf, a peaking mid with Q=2.5 and a high shelf, each a direct-form-I
recursion with cross-chunk state of the last 2 outputs and last 3 inputs.

Two reference quirks, handled as the JAX package handles them:

* the reference prepends THREE input samples but only TWO output samples
  before indexing from position 2, so every band filters the input delayed
  by one sample: ``y[n] = b0 x[n-1] + b1 x[n-2] + b2 x[n-3] - a1 y[n-1]
  - a2 y[n-2]``. Replicated exactly;
* the reference hard-codes ``Fs = 44100``; ``cfg.sample_rate`` is honoured.

The recurrence runs in float64 and the result is rounded once to float32.
The JAX package carries f32 pairs (``core/dfloat.py``) only because a TPU has
no float64; the H100 has it, so this port keeps no double-float arithmetic.
Per band: the forcing ``c[n] = b0 x[n-1] + b1 x[n-2] + b2 x[n-3]`` in
parallel; then the all-pole part ``1 / ((1 - p1 z^-1)(1 - p2 z^-1))`` as two
first-order sections in complex128, ``w[n] = c[n] + p1 w[n-1]`` and
``y[n] = w[n] + p2 y[n-1]`` (``p1``, ``p2`` the poles, from the float64
coefficients in long double). Each section runs over chunks of ``CHUNK``
samples as one product with the Toeplitz matrix of ``p^(n-m)``, the chunks
joined by a doubling scan of the scalar carry ``S_k = e_k + p^CHUNK
S_(k-1)``. Every multiplier has a magnitude of at most 1, which keeps the
result within float64 rounding of a per-sample recursion even where the
poles sit next to z = 1 (a low shelf at 0.3 Hz: its poles are 3.3e-5 from
it). The 2x2 companion form (chunk maps of ``(y[n], y[n-1])``) lost up to
100 dB there, growing with the length. There is no TPU kernel behind this
op, so it is plain PyTorch on either device.

Offline, a cascade whose impulse response decays within 2**18 samples (to
1e-9 of its peak) is FIR-ised: the truncated response goes through
``fft_filter.fir`` (the segmented convolution kernel on the card, in
partitions where it is long), and the effect is time-parallel. One that does
not decay takes the float64 recurrence over the whole signal.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import DEFAULT_DEVICE, EngineConfig, resolve_device
from .base import Effect, params_dataclass
from . import fft_filter

# Samples of a chunk of a first-order section: its Toeplitz matrix is CHUNK^2
# complex128 (1 MB a section, two a band).
CHUNK = 256
_FIR_CAP = 1 << 18          # max impulse-response length considered
_FIR_TRUNC = 1e-9           # truncate below this fraction of the peak


def rbj_lowshelf(fs: float, freq: float, gain_db: float, q: float = 1.0):
    """RBJ low-shelf coefficients (EffectEQ3Band.py:45-51,67-72), float64."""
    a = np.sqrt(10.0 ** (gain_db / 20.0))
    w0 = 2 * np.pi * freq / fs
    alpha = np.sin(w0) / 2 * np.sqrt((a + 1 / a) * (1 / q - 1) + 2)
    cos = np.cos(w0)
    b0 = a * ((a + 1) - (a - 1) * cos + 2 * np.sqrt(a) * alpha)
    b1 = 2 * a * ((a - 1) - (a + 1) * cos)
    b2 = a * ((a + 1) - (a - 1) * cos - 2 * np.sqrt(a) * alpha)
    a0 = (a + 1) + (a - 1) * cos + 2 * np.sqrt(a) * alpha
    a1 = -2 * ((a - 1) + (a + 1) * cos)
    a2 = (a + 1) + (a - 1) * cos - 2 * np.sqrt(a) * alpha
    return np.array([b0, b1, b2, a0, a1, a2])


def rbj_peaking(fs: float, freq: float, gain_db: float, q: float = 2.5):
    """RBJ peaking-EQ coefficients (EffectEQ3Band.py:54-58,75-80), float64."""
    a = np.sqrt(10.0 ** (gain_db / 20.0))
    w0 = 2 * np.pi * freq / fs
    alpha = np.sin(w0) / (2 * q)
    cos = np.cos(w0)
    return np.array([1 + alpha * a, -2 * cos, 1 - alpha * a,
                     1 + alpha / a, -2 * cos, 1 - alpha / a])


def rbj_highshelf(fs: float, freq: float, gain_db: float, q: float = 1.0):
    """RBJ high-shelf coefficients (EffectEQ3Band.py:61-65,83-88), float64."""
    a = np.sqrt(10.0 ** (gain_db / 20.0))
    w0 = 2 * np.pi * freq / fs
    alpha = np.sin(w0) / 2 * np.sqrt((a + 1 / a) * (1 / q - 1) + 2)
    cos = np.cos(w0)
    b0 = a * ((a + 1) + (a - 1) * cos + 2 * np.sqrt(a) * alpha)
    b1 = -2 * a * ((a - 1) + (a + 1) * cos)
    b2 = a * ((a + 1) + (a - 1) * cos - 2 * np.sqrt(a) * alpha)
    a0 = (a + 1) - (a - 1) * cos + 2 * np.sqrt(a) * alpha
    a1 = 2 * ((a - 1) - (a + 1) * cos)
    a2 = (a + 1) - (a - 1) * cos - 2 * np.sqrt(a) * alpha
    return np.array([b0, b1, b2, a0, a1, a2])


@params_dataclass(meta_fields=("n_bands", "use_fir", "block_size", "rows",
                               "poles"))
class EQ3BandParams:
    coeffs: torch.Tensor     # (n_bands, 5) float64 on the host: b0 b1 b2 a1 a2
    toeplitz: torch.Tensor   # (n_bands, 2, CHUNK, CHUNK) complex128: the
                             # Toeplitz matrix of p^(n-m) of each pole
    powers: torch.Tensor     # (n_bands, 2, CHUNK) complex128: p^(n+1)
    fir: fft_filter.FIRParams | None   # the FIR-ised offline path, or None
                             # where the response did not decay in the cap
    n_bands: int
    use_fir: bool
    block_size: int
    rows: tuple              # ``coeffs`` as Python floats, per band
    poles: tuple             # (p1, p2) per band, Python complexes (the step
                             # reads these and ``rows`` on every block)


def _impulse_response(rows: np.ndarray) -> np.ndarray | None:
    """float64 impulse response of the delayed-input biquad cascade,
    truncated at 1e-9 of its peak; None if it has not decayed within 2**18
    samples. Checked, as the JAX package checks it, at lengths 2**13,
    2**14, ...: decayed where the last sixteenth is below 1e-9 of the peak.
    The recursion is the plain per-sample one (each band delays its input
    by one sample), run once up to the length that decides."""
    h = np.zeros(_FIR_CAP)
    n_bands = len(rows)
    rows = [tuple(float(v) for v in r) for r in rows]
    xs = [[0.0, 0.0, 0.0] for _ in range(n_bands)]   # x[n-1], x[n-2], x[n-3]
    ys = [[0.0, 0.0] for _ in range(n_bands)]        # y[n-1], y[n-2]
    done = 0
    T = 1 << 13
    while T <= _FIR_CAP:
        for n in range(done, T):
            v = 1.0 if n == 0 else 0.0
            for (b0, b1, b2, a1, a2), x, y in zip(rows, xs, ys):
                out = b0 * x[0] + b1 * x[1] + b2 * x[2] - a1 * y[0] - a2 * y[1]
                x[2], x[1], x[0] = x[1], x[0], v
                y[1], y[0] = y[0], out
                v = out
            h[n] = v
        done = T
        peak = np.abs(h[:T]).max()
        if peak == 0:
            return None
        if np.abs(h[T - T // 16:T]).max() <= _FIR_TRUNC * peak:
            keep = np.nonzero(np.abs(h[:T]) > _FIR_TRUNC * peak)[0]
            return h[: int(keep[-1]) + 1].copy()
        T *= 2
    return None


def poles(a1: float, a2: float) -> tuple[complex, complex]:
    """The roots p1, p2 of ``z^2 + a1 z + a2``. The discriminant is taken in
    long double: where the poles nearly coincide it is the difference of two
    nearly equal numbers, and float64 would leave an error of about 1e-8 in
    the poles."""
    a1l, a2l = np.longdouble(a1), np.longdouble(a2)
    disc = a1l * a1l - 4 * a2l
    if disc < 0:
        re, im = float(-a1l / 2), float(np.sqrt(-disc) / 2)
        return complex(re, im), complex(re, -im)
    root = np.sqrt(disc)
    q = -(a1l + (root if a1l >= 0 else -root)) / 2
    return complex(float(q)), complex(float(a2l / q) if q else 0.0)


def _section_tables(p: complex, L: int) -> tuple[np.ndarray, np.ndarray]:
    """(G, P) of one first-order section over a chunk of L: G[n, m] =
    p^(n-m) for n >= m (lower-triangular Toeplitz), P[n] = p^(n+1)."""
    pows = np.empty(L + 1, dtype=np.complex128)
    pows[0] = 1.0
    for k in range(1, L + 1):
        pows[k] = pows[k - 1] * p
    idx = np.arange(L)
    G = np.where(idx[:, None] >= idx[None, :],
                 pows[np.clip(idx[:, None] - idx[None, :], 0, L)], 0.0)
    return G, pows[1:].copy()


def from_rows(rows, block_size: int, name: str, device=DEFAULT_DEVICE
              ) -> Effect:
    """The EQ effect of a cascade of normalised biquads, (n_bands, 5)
    float64 rows of b0, b1, b2, a1, a2."""
    dev = resolve_device(device)
    rows = np.array(rows, dtype=np.float64)
    h = _impulse_response(rows)
    pole_pairs = [poles(r[3], r[4]) for r in rows]
    tables = [[_section_tables(p, CHUNK) for p in pair] for pair in pole_pairs]
    params = EQ3BandParams(
        coeffs=torch.from_numpy(rows.copy()),
        toeplitz=torch.from_numpy(np.stack(
            [[g for g, _ in band] for band in tables])).to(dev),
        powers=torch.from_numpy(np.stack(
            [[pw for _, pw in band] for band in tables])).to(dev),
        fir=(fft_filter.fir(h, block_size, device=dev).params
             if h is not None else None),
        n_bands=len(rows), use_fir=h is not None, block_size=block_size,
        rows=tuple(tuple(float(v) for v in r) for r in rows),
        poles=tuple(pole_pairs))
    # Decayed cascade: offline = one segmented convolution (parity with the
    # recursion to the 1e-9 truncation level, and time-parallel). Undecayed:
    # the exact float64 recurrence, channel-parallel only.
    return Effect(name=name, params=params, init_state=init_state,
                  step=step, offline=offline_fir if h is not None else offline,
                  time_parallel=h is not None, device=dev,
                  reach=len(h) - 1 if h is not None else 0)


def _normalised(raw) -> list[float]:
    b0, b1, b2, a0, a1, a2 = raw
    return [b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0]


def eq3band(cfg: EngineConfig, low_shelf_hz: float, low_shelf_db: float,
            mid_hz: float, mid_db: float, high_shelf_hz: float,
            high_shelf_db: float, device=DEFAULT_DEVICE) -> Effect:
    """Low shelf -> peaking mid -> high shelf, chained as the reference's
    documented usage chains its three band methods."""
    fs = float(cfg.sample_rate)
    rows = [_normalised(rbj_lowshelf(fs, low_shelf_hz, low_shelf_db)),
            _normalised(rbj_peaking(fs, mid_hz, mid_db)),
            _normalised(rbj_highshelf(fs, high_shelf_hz, high_shelf_db))]
    return from_rows(rows, cfg.block_size, "eq3band", device)


def eq_band(cfg: EngineConfig, kind: str, freq: float, gain_db: float,
            device=DEFAULT_DEVICE) -> Effect:
    """One EQ band as its own effect (``kind`` is "low", "mid" or "high"):
    the reference's ``applylowband`` / ``applymidband`` /
    ``applyhighband``."""
    fs = float(cfg.sample_rate)
    raw = {"low": rbj_lowshelf, "mid": rbj_peaking, "high": rbj_highshelf}[
        kind](fs, freq, gain_db)
    return from_rows([_normalised(raw)], cfg.block_size, f"eq_band_{kind}",
                     device)


STATE_KEYS = ("x1", "x2", "x3", "y1", "y2")


def init_state(params: EQ3BandParams, batch_shape: tuple[int, ...] = ()):
    """Per band: the last 3 raw inputs (x1 newest) and the last 2 outputs
    (y1 newest), float64, ``(n_bands, *batch_shape)`` each: the reference's
    PrevOriginalChunkSample / PrevChunkSample, and the JAX package's fields
    with each (hi, lo) pair as one float64."""
    z = torch.zeros((params.n_bands,) + tuple(batch_shape),
                    dtype=torch.float64, device=params.toeplitz.device)
    return {k: z for k in STATE_KEYS}


def _section(c: torch.Tensor, w0: torch.Tensor, G: torch.Tensor,
             P: torch.Tensor) -> torch.Tensor:
    """complex128 ``w[n] = c[n] + p w[n-1]`` over the last axis of ``c``
    (R, T) from ``w[-1] = w0`` (R,), chunk by chunk (see the module
    docstring): G and P from :func:`_section_tables`."""
    R, T = c.shape
    L = G.shape[-1]
    K = -(-T // L)
    cc = torch.nn.functional.pad(c, (0, K * L - T)).reshape(R, K, L)
    wz = cc @ G.T                                        # zero-entry part
    # S_k = e_k + p^L S_(k-1), S_(-1) = w0: the end values of the chunks
    e = wz[..., L - 1].clone()
    e[:, 0] = e[:, 0] + P[L - 1] * w0
    m, d = P[L - 1], 1
    while d < K:
        e = torch.cat([e[:, :d], e[:, d:] + m * e[:, :-d]], dim=1)
        m, d = m * m, 2 * d
    entry = torch.cat([w0[:, None], e[:, :-1]], dim=1)   # (R, K)
    return (wz + entry[..., None] * P).reshape(R, K * L)[:, :T]


def _allpole(c: torch.Tensor, y1: torch.Tensor, y2: torch.Tensor,
             params: EQ3BandParams, band: int) -> torch.Tensor:
    """float64 ``y[n] = c[n] - a1 y[n-1] - a2 y[n-2]`` over the last axis of
    ``c`` (R, T) from the state (y1, y2) (R,): the band's two first-order
    sections, ``w[-1] = y1 - p2 y2`` and ``y[-1] = y1``."""
    G, P = params.toeplitz[band], params.powers[band]
    p2 = params.poles[band][1]
    cx = c.to(torch.complex128)
    w = _section(cx, (y1 - p2 * y2).to(torch.complex128), G[0], P[0])
    return _section(w, y1.to(torch.complex128), G[1], P[1]).real


def _apply(params: EQ3BandParams, state, x: torch.Tensor):
    """All bands over the last axis of ``x`` (..., T), in float64 from the
    state to the state, rounded to float32 once."""
    batch = x.shape[:-1]
    T = x.shape[-1]
    v = x.to(torch.float64).reshape(-1, T)
    new = {k: [] for k in STATE_KEYS}
    for band in range(params.n_bands):
        st = {k: state[k][band].reshape(-1) for k in STATE_KEYS}
        b0, b1, b2, _, _ = params.rows[band]
        xe = torch.cat([st["x3"][:, None], st["x2"][:, None],
                        st["x1"][:, None], v], dim=-1)   # x[-3] .. x[T-1]
        c = b0 * xe[:, 2:-1] + b1 * xe[:, 1:-2] + b2 * xe[:, :-3]
        y = _allpole(c, st["y1"], st["y2"], params, band)
        ye = torch.cat([st["y2"][:, None], st["y1"][:, None], y], dim=-1)
        for k, col in (("x1", xe[:, -1]), ("x2", xe[:, -2]),
                       ("x3", xe[:, -3]), ("y1", ye[:, -1]),
                       ("y2", ye[:, -2])):
            new[k].append(col.reshape(batch))
        v = y
    state = {k: torch.stack(vs) for k, vs in new.items()}
    return state, v.to(torch.float32).reshape(x.shape)


def step(params: EQ3BandParams, state, block: torch.Tensor):
    return _apply(params, state, block)


def offline_fir(params: EQ3BandParams, blocks: torch.Tensor,
                use_kernels: bool = True) -> torch.Tensor:
    """FIR-ised whole-signal path: the segmented convolution of the
    truncated cascade response."""
    return fft_filter.fir_offline(params.fir, blocks, use_kernels)


def offline(params: EQ3BandParams, blocks: torch.Tensor,
            use_kernels: bool = True) -> torch.Tensor:
    """Whole-signal float64 recurrence from silence (chunks carried by the
    doubling scan over the whole signal)."""
    shape = blocks.shape
    x = blocks.reshape(shape[:-2] + (shape[-2] * shape[-1],))
    _, y = _apply(params, init_state(params, shape[:-2]), x)
    return y.reshape(shape)
