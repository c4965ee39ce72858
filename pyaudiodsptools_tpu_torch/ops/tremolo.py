"""Tremolo: sinusoidal LFO amplitude modulation.

Counterpart of ``pyaudiodsptools_tpu/ops/tremolo.py``. The reference
precomputes one LFO period (``sr / lfo_hz`` samples, the length taken through
float32 rounding) and consumes it from a rolling copy. The consumed gain for
absolute phase p is ``lfo[p mod L]`` -- EXCEPT for a reference quirk: when
the rolling copy's remaining length hits exactly the chunk size, the phase
freezes and that LFO segment repeats for all later chunks. The
``phase``/``avail`` carry replicates this; the offline path precomputes the
per-block phase schedule on the host once per (LFO length, blocks, block
size) and keeps it on the device, so that a render copies nothing from the
host (a captured render, ``engine/graph.py``, replays it).

As in the JAX package, the carry is two 0-d ``int32`` tensors on the
effect's device and a step advances them with tensor operations: a step
reads nothing back, so a CUDA graph that captures it
(``engine/graph.py``) replays the LFO's advance instead of freezing the
position it had at capture.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.config import DEFAULT_DEVICE, EngineConfig, resolve_device
from .base import Effect, host_scalar, params_dataclass


@params_dataclass(meta_fields=("lfo_length", "block_size"))
class TremoloParams:
    lfo: torch.Tensor       # one LFO period, float32, (lfo_length,), on device
    omega: torch.Tensor     # 2*pi*lfo_hz/sample_rate, host scalar
    depth: torch.Tensor     # host scalar
    lfo_length: int
    block_size: int


def tremolo(cfg: EngineConfig, depth: float = 0.4, lfo_hz: float = 4.5,
            device=DEFAULT_DEVICE) -> Effect:
    dev = resolve_device(device)
    sr = cfg.sample_rate
    # Length via float32 rounding of sr/lfo_hz, as the reference does.
    length = int(np.arange(np.float32(sr / lfo_hz)).shape[0])
    t = np.arange(length)
    lfo = np.float32(
        (((np.sin(2 * np.pi * lfo_hz * t / sr) / 2) + 0.5) * depth) + (1 - depth)
    )
    params = TremoloParams(lfo=torch.from_numpy(lfo).to(dev),
                           omega=host_scalar(np.float32(2 * np.pi * lfo_hz / sr)),
                           depth=host_scalar(np.float32(depth)),
                           lfo_length=length,
                           block_size=cfg.block_size)
    return Effect(name="tremolo", params=params, init_state=init_state,
                  step=step, offline=offline, device=dev,
                  block_indexed=True)


def init_state(params: TremoloParams, batch_shape: tuple[int, ...] = ()):
    """LFO position: absolute phase into the periodic stream plus the rolling
    copy's remaining length (which controls the freeze quirk), 0-d int32
    tensors on the LFO's device: the LFO is shared across channels."""
    dev = params.lfo.device
    return {"phase": torch.zeros((), dtype=torch.int32, device=dev),
            "avail": torch.full((), params.lfo_length, dtype=torch.int32,
                                device=dev)}


def _advance(L: int, phase: int, avail: int, n: int) -> tuple[int, int]:
    """One chunk's worth of the reference's append/consume logic, on host
    ints (the offline phase schedule)."""
    if avail < n:
        avail += L * (-(-(n - avail) // L))
    if avail == n:
        return phase, avail  # frozen: the slice [-0:] keeps the whole copy
    return (phase + n) % L, avail - n


def _advance_tensors(L: int, phase: torch.Tensor, avail: torch.Tensor,
                     n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_advance` on the 0-d int32 carry, branch-free (the JAX
    package's ``_advance``): nothing is read back."""
    appends = (torch.clamp(n - avail, min=0) + (L - 1)) // L
    avail = avail + appends * L
    frozen = avail == n
    return (torch.where(frozen, phase, (phase + n) % L),
            torch.where(frozen, avail, avail - n))


def step(params: TremoloParams, state, block: torch.Tensor):
    n = block.shape[-1]
    phase = state["phase"]
    idx = (phase + torch.arange(n, dtype=torch.int32, device=block.device)
           ) % params.lfo_length
    gains = params.lfo[idx]
    phase, avail = _advance_tensors(params.lfo_length, phase,
                                    state["avail"], n)
    return {"phase": phase, "avail": avail}, (block * gains).to(torch.float32)


def phase_schedule(params: TremoloParams, num_blocks: int,
                   n: int | None = None) -> np.ndarray:
    """Host-side exact simulation of the per-block phase sequence, including
    the freeze quirk. The result is cached (it depends on three ints only)
    and must be treated as read-only."""
    n = params.block_size if n is None else n
    return _phase_schedule(params.lfo_length, num_blocks, n)


@functools.lru_cache(maxsize=64)
def _phase_schedule(L: int, num_blocks: int, n: int) -> np.ndarray:
    phase, avail = 0, L
    phases = np.empty(num_blocks, dtype=np.int64)
    for i in range(num_blocks):
        phases[i] = phase
        phase, avail = _advance(L, phase, avail, n)
    phases.setflags(write=False)
    return phases


_device_schedules: dict[tuple[int, int, int, str], torch.Tensor] = {}


def device_phase_schedule(L: int, num_blocks: int, n: int,
                          device) -> torch.Tensor:
    """:func:`_phase_schedule` as an int64 tensor on ``device``, copied there
    once per key and device and kept (as ``kernels/segconv.pass_twiddles``
    keeps its tables): a render reads it and copies nothing from the host,
    which a CUDA graph could not replay. Nothing is evicted, because a
    captured render reads the tensor at every replay; a key is three ints
    and the tensor one int a block."""
    device = torch.device(device)
    key = (L, num_blocks, n, str(device))
    sched = _device_schedules.get(key)
    if sched is None:
        sched = torch.from_numpy(
            _phase_schedule(L, num_blocks, n).copy()).to(device)
        _device_schedules[key] = sched
    return sched


def gain_row(params: TremoloParams, nb: int, n: int,
             device=None, first_block: int = 0) -> torch.Tensor:
    """The whole render's per-sample gain as one flat (nb*n,) f32 row --
    shared by ``offline`` and the fused tail kernel (kernels/tail.py). With
    ``first_block``, the row of blocks ``first_block .. first_block+nb-1``
    of a longer render (a time shard's).

    Arithmetic LFO, as in the JAX package: f32 ``sin`` of the mod-L index
    times omega (periodicity is only exact when sr/lfo_hz is an integer,
    hence the explicit mod).

    A fresh tensor per call, computed on the device from device tensors
    alone, as the JAX package computes the row per render; only the phase
    schedule is cached (:func:`device_phase_schedule`)."""
    device = params.lfo.device if device is None else torch.device(device)
    L = params.lfo_length
    phases = device_phase_schedule(L, first_block + nb, n,
                                   device)[first_block:]
    idx = (phases[:, None] + torch.arange(n, device=device)[None, :]) % L
    ph = idx.to(torch.float32) * params.omega
    gains = (torch.sin(ph) * 0.5 + 0.5) * params.depth + (1.0 - params.depth)
    return gains.reshape(-1)


def offline(params: TremoloParams, blocks: torch.Tensor,
            use_kernels: bool = True, first_block: int = 0) -> torch.Tensor:
    nb, n = blocks.shape[-2], blocks.shape[-1]
    gains = gain_row(params, nb, n, blocks.device,
                     first_block).reshape(nb, n)
    return (blocks * gains).to(torch.float32)
