"""Reverb: early-reflection multi-tap delay lines with high-cut damping.

Counterpart of ``pyaudiodsptools_tpu/ops/reverb.py``. Parity target:
pyAudioDspTools ``_EffectReverb.py`` (unexported work in progress in the
reference, exercised by its ModuleTests.py; shipped first-class here as in
the JAX package). Structure:

* two delay lines; line k high-cut filters the input (5000 Hz / 150 Hz, with
  the FFT filter's one-block latency), then writes taps at multiples of
  ``reverb_samples // loops`` with gains ``linspace(0.3, 0.01, loops)``,
  looping ``range(loops - 1)`` like the reference, so the last ramp entry is
  unused;
* both lines are wet-only; the output is their sum (no dry signal).

The whole reverb is linear and time-invariant: ``lti_kernel`` is the two
lines' combined impulse response, so a Chain fuses a reverb with its LTI
neighbours into one FIR, as the JAX package does.

Streaming (``step``) keeps the line structure: each line's high-cut
``fir_step`` (one ``convpairs`` launch on the card), then the
ramp-scaled shifted adds into the line's buffer. Taps whose windows do not
overlap (``time_in_samples`` apart, at least a block) go in ONE strided
in-place add; at a block longer than that the taps are cut into
``ceil(B / time)`` interleaved groups, one add each. No atomics, so a stream
is bit-reproducible.

Offline (:func:`offline_fir`, the JAX package's route): ``fir`` on the
combined kernel (65,033 stripped taps at B=512, 66,825 at B=4096), the
segmented convolution in partitions (4 and 5 launches), the later ones
adding into the output. The benchmark's cell ``reverb1500.offline``
(``BENCHMARK.json``: compressor, gate and this reverb over 64 channels of
10 minutes) measures it on the card, its five launches a render marked as
stages ``reverb.part0`` ... ``reverb.part4`` under tracing; PERF.md's
findings have the numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import DEFAULT_DEVICE, EngineConfig, resolve_device
from .base import Effect, params_dataclass
from . import fft_filter


@params_dataclass(meta_fields=("time_in_samples", "n_taps", "block_size"))
class ReverbLineParams:
    ramp: torch.Tensor       # (loops,) f32 on the host, as the JAX package's
    gains: torch.Tensor      # ramp[:n_taps] on the device: the step's adds
    highcut: fft_filter.FIRParams
    time_in_samples: int
    n_taps: int
    block_size: int


@params_dataclass(meta_fields=("block_size",))
class ReverbParams:
    line1: ReverbLineParams
    line2: ReverbLineParams
    full: fft_filter.FIRParams   # the combined two-line kernel: offline
    block_size: int


LINES = ((100, 5000.0), (50, 150.0))   # (loops, high-cut Hz) of each line


def _ramp(loops: int) -> np.ndarray:
    return np.linspace(0.3, 0.01, num=loops, dtype=np.float32)


def _line(cfg: EngineConfig, reverb_samples: int, loops: int,
          highcut_hz: float, device) -> ReverbLineParams:
    ramp = _ramp(loops)
    return ReverbLineParams(
        ramp=torch.from_numpy(ramp.copy()),
        gains=torch.from_numpy(ramp[:loops - 1].copy()).to(device),
        highcut=fft_filter.highcut(cfg, highcut_hz, device=device).params,
        time_in_samples=reverb_samples // loops,
        n_taps=loops - 1,
        block_size=cfg.block_size,
    )


def _line_kernel(cfg: EngineConfig, time: int, ramp: np.ndarray,
                 n_taps: int, highcut_hz: float) -> np.ndarray:
    """Host-side float64 impulse response of one line: ramp-scaled copies of
    the high-cut sinc kernel at the tap offsets, plus the FFT filter's
    one-block latency (out[m] = conv(x, hk)[m - (B - fl//2)])."""
    B = cfg.block_size
    fl = (B // 2) - 1
    hk = fft_filter.sinc_kernel(highcut_hz, cfg.sample_rate, fl, "blackman")
    s0 = B - fl // 2
    k = np.zeros(time * n_taps + s0 + fl)
    for i in range(n_taps):
        off = time * (i + 1) + s0
        k[off:off + fl] += float(ramp[i]) * hk
    return k


def lines_kernel(cfg: EngineConfig, lines) -> np.ndarray:
    """The lines' impulse responses summed (float64); ``lines`` gives each
    line's (time_in_samples, ramp, n_taps, high-cut Hz)."""
    ks = [_line_kernel(cfg, *line) for line in lines]
    k = np.zeros(max(len(x) for x in ks))
    for x in ks:
        k[:len(x)] += x
    return k


def combined_kernel(cfg: EngineConfig, time_in_ms: float) -> np.ndarray:
    """The two lines' impulse responses summed (float64)."""
    reverb_samples = int((time_in_ms / 1000) * cfg.sample_rate)
    return lines_kernel(cfg, [(reverb_samples // loops, _ramp(loops),
                               loops - 1, hz) for loops, hz in LINES])


def reverb(cfg: EngineConfig, time_in_ms: float = 1500.0,
           device=DEFAULT_DEVICE) -> Effect:
    dev = resolve_device(device)
    reverb_samples = int((time_in_ms / 1000) * cfg.sample_rate)
    k = combined_kernel(cfg, time_in_ms)
    line1, line2 = (_line(cfg, reverb_samples, loops, hz, dev)
                    for loops, hz in LINES)
    params = ReverbParams(
        line1=line1, line2=line2,
        full=fft_filter.fir(k, cfg.block_size, device=dev).params,
        block_size=cfg.block_size)
    return make_effect(params, k, dev)


def make_effect(params: ReverbParams, lti_kernel: np.ndarray,
                device) -> Effect:
    return Effect(name="reverb", params=params, init_state=init_state,
                  step=step, offline=offline, lti_kernel=lti_kernel,
                  reach=len(lti_kernel) - 1, device=resolve_device(device))


def _line_buffer_len(p: ReverbLineParams) -> int:
    """The JAX package's buffer length: the farthest tap plus one block,
    rounded up to whole blocks."""
    B = p.block_size
    raw = p.time_in_samples * p.n_taps + B
    return max(-(-raw // B) * B, B)


def _line_state(p: ReverbLineParams, batch_shape):
    return {
        "filter": fft_filter.fir_init_state(p.highcut, batch_shape),
        "buffer": torch.zeros(tuple(batch_shape) + (_line_buffer_len(p),),
                              dtype=torch.float32, device=p.gains.device),
    }


def init_state(params: ReverbParams, batch_shape: tuple[int, ...] = ()):
    return {"line1": _line_state(params.line1, batch_shape),
            "line2": _line_state(params.line2, batch_shape)}


def tap_groups(time: int, n_taps: int, n: int) -> list[tuple[int, int]]:
    """(first tap, stride) of each group of a line's taps whose windows of
    ``n`` samples, ``time`` apart, do not overlap: one group of every tap
    where ``n <= time``, else ``g = ceil(n / time)`` groups, taps r, r + g,
    r + 2g, ..."""
    g = n_taps if time == 0 else max(1, -(-n // time))
    return [(r, g) for r in range(min(g, n_taps))]


def _line_step(p: ReverbLineParams, st, block: torch.Tensor):
    fstate, filtered = fft_filter.fir_step(p.highcut, st["filter"], block)
    n = block.shape[-1]
    buf = st["buffer"]
    L = buf.shape[-1]
    R = filtered.numel() // n
    flat = filtered.reshape(R, 1, n)
    # the buffer and one block of silence, into which every tap adds its
    # scaled copy of the filtered block: a new tensor, the old state stays
    ext = torch.nn.functional.pad(buf.reshape(R, L), (0, n))
    time = p.time_in_samples
    for first, g in tap_groups(time, p.n_taps, n):
        gains = p.gains[first::g]
        # the group's windows as one view: tap k at time * (k + 1)
        view = ext.as_strided((R, len(gains), n), (L + n, time * g, 1),
                              ext.storage_offset() + time * (first + 1))
        view.addcmul_(flat, gains.reshape(1, -1, 1))
    out = ext[:, :n].reshape(block.shape)
    new_buf = ext[:, n:].reshape(buf.shape)
    return {"filter": fstate, "buffer": new_buf}, out


def step(params: ReverbParams, state, block: torch.Tensor):
    st1, wet1 = _line_step(params.line1, state["line1"], block)
    st2, wet2 = _line_step(params.line2, state["line2"], block)
    return {"line1": st1, "line2": st2}, (wet1 + wet2).to(torch.float32)


def offline_fir(params: ReverbParams, blocks: torch.Tensor,
                use_kernels: bool = True) -> torch.Tensor:
    """One FIR of the combined kernel, the segmented convolution in
    partitions (one launch each on the card)."""
    return fft_filter.fir_offline(params.full, blocks, use_kernels)


offline = offline_fir
