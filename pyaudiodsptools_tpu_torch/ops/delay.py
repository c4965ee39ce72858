"""Delay: multi-tap echo with a feedback gain ramp.

Counterpart of ``pyaudiodsptools_tpu/ops/delay.py``. The device is linear
time-invariant:

    y[n] = x[n] (dry, unless wet) + sum_k ramp[k] * x[n - time*(k+1)]

so the offline path is a handful of shifted adds over the full signal.
Streaming keeps the reference's sliding buffer as explicit state. The
feedback ramp is ``linspace(0.5, 0.1, feedback_loops)``.

The optional pre-filters are the standard FFT filters (with their 1-block
latency) applied to the input first: offline they ride the segmented
convolution, streaming the FIR step, each with its own history in the state.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import DEFAULT_DEVICE, EngineConfig, resolve_device
from .base import Effect, params_dataclass
from . import fft_filter


@params_dataclass(meta_fields=("time_in_samples", "feedback_loops", "wet",
                               "block_size", "use_lowcut", "use_highcut"))
class DelayParams:
    ramp: torch.Tensor                   # (feedback_loops,) f32, on the host
    lowcut: fft_filter.FIRParams | None
    highcut: fft_filter.FIRParams | None
    time_in_samples: int
    feedback_loops: int
    wet: bool
    block_size: int
    use_lowcut: bool
    use_highcut: bool


def delay(cfg: EngineConfig, time_in_ms: float = 500.0, feedback_loops: int = 2,
          lowcut_hz: float = 40.0, highcut_hz: float = 12000.0,
          use_lowcut_filter: bool = False, use_highcut_filter: bool = False,
          wet: bool = False, device=DEFAULT_DEVICE) -> Effect:
    dev = resolve_device(device)
    time_in_samples = int(time_in_ms * (cfg.sample_rate / 1000))
    ramp = np.linspace(0.5, 0.1, num=feedback_loops, dtype=np.float32)
    params = DelayParams(
        ramp=torch.from_numpy(ramp.copy()),
        lowcut=(fft_filter.lowcut(cfg, lowcut_hz, device=dev).params
                if use_lowcut_filter else None),
        highcut=(fft_filter.highcut(cfg, highcut_hz, device=dev).params
                 if use_highcut_filter else None),
        time_in_samples=time_in_samples,
        feedback_loops=feedback_loops,
        wet=wet,
        block_size=cfg.block_size,
        use_lowcut=use_lowcut_filter,
        use_highcut=use_highcut_filter,
    )
    # Effective impulse response (the op is LTI): dry tap (unless wet) plus
    # ramp[k] at time*(k+1), convolved with any enabled pre-filters' kernels.
    eff_kernel = tap_kernel(ramp, time_in_samples, wet)
    for enabled, hz, invert in ((use_lowcut_filter, lowcut_hz, True),
                                (use_highcut_filter, highcut_hz, False)):
        if enabled:
            fl = (cfg.block_size // 2) - 1
            k_f = fft_filter.sinc_kernel(hz, cfg.sample_rate, fl, "blackman",
                                         invert)
            shifted = np.concatenate(
                [np.zeros(cfg.block_size - fl // 2), k_f])
            eff_kernel = np.convolve(eff_kernel, shifted)
    return make_effect(params, eff_kernel, dev)


def tap_kernel(ramp: np.ndarray, time_in_samples: int, wet: bool) -> np.ndarray:
    """float64 impulse response of the bare tap train."""
    loops = len(ramp)
    k = np.zeros(time_in_samples * loops + 1)
    if not wet:
        k[0] = 1.0
    for i in range(loops):
        k[time_in_samples * (i + 1)] += np.float64(ramp[i])
    return k


def make_effect(params: DelayParams, lti_kernel, device) -> Effect:
    dev = resolve_device(device)

    def init_on_device(params: DelayParams,
                       batch_shape: tuple[int, ...] = ()):
        return init_state(params, batch_shape, dev)

    return Effect(name="delay", params=params, init_state=init_on_device,
                  step=step, offline=offline, lti_kernel=lti_kernel,
                  reach=len(lti_kernel) - 1, device=dev)


def _buffer_len(params: DelayParams) -> int:
    # time*(loops+2) like the reference, but also large enough for the
    # farthest tap plus one block, rounded up to whole blocks.
    B = params.block_size
    raw = max(params.time_in_samples * (params.feedback_loops + 2),
              params.time_in_samples * params.feedback_loops + B)
    return max(-(-raw // B) * B, B)


def init_state(params: DelayParams, batch_shape: tuple[int, ...],
               device):
    """The zeroed sliding buffer, on ``device`` (the effect's own: see
    :func:`make_effect`), and the enabled pre-filters' histories."""
    state = {"buffer": torch.zeros(
        tuple(batch_shape) + (_buffer_len(params),), dtype=torch.float32,
        device=device)}
    if params.use_lowcut:
        state["lowcut"] = fft_filter.fir_init_state(params.lowcut, batch_shape)
    if params.use_highcut:
        state["highcut"] = fft_filter.fir_init_state(params.highcut,
                                                     batch_shape)
    return state


def step(params: DelayParams, state, block: torch.Tensor):
    new_state = {}
    if params.use_lowcut:
        new_state["lowcut"], block = fft_filter.fir_step(
            params.lowcut, state["lowcut"], block)
    if params.use_highcut:
        new_state["highcut"], block = fft_filter.fir_step(
            params.highcut, state["highcut"], block)
    n = block.shape[-1]
    buf = state["buffer"].clone()
    # Write input * ramp[k] at offsets time*(k+1).
    for k in range(params.feedback_loops):
        start = params.time_in_samples * (k + 1)
        buf[..., start:start + n] += block * params.ramp[k]
    head = buf[..., :n]
    out = head if params.wet else block + head
    # Slide the buffer left by one block and zero-fill.
    new_state["buffer"] = torch.cat([buf[..., n:], torch.zeros_like(block)],
                                    dim=-1)
    return new_state, out.to(torch.float32)


def offline(params: DelayParams, blocks: torch.Tensor,
            use_kernels: bool = True) -> torch.Tensor:
    if params.use_lowcut:
        blocks = fft_filter.fir_offline(params.lowcut, blocks, use_kernels)
    if params.use_highcut:
        blocks = fft_filter.fir_offline(params.highcut, blocks, use_kernels)
    nb, B = blocks.shape[-2], blocks.shape[-1]
    n = nb * B
    x = blocks.reshape(blocks.shape[:-2] + (n,))
    acc = torch.zeros_like(x) if params.wet else x.clone()
    # y = x + sum_k ramp[k] * shift(x, time*(k+1)): pure shifted adds.
    for k in range(params.feedback_loops):
        d = params.time_in_samples * (k + 1)
        if d >= n:
            continue
        acc[..., d:] += x[..., :n - d] * params.ramp[k]
    return acc.reshape(blocks.shape).to(torch.float32)
