"""Stateless waveshapers: Saturator, SoftClipper, HardDistortion, BitCrusher.

Counterpart of ``pyaudiodsptools_tpu/ops/waveshapers.py`` (``_saturate``,
``_softclip``, ``_harddist``, ``_bitcrush``); the formulas and their quirks
are the same:

* Saturator -- fold to magnitude, rational knee above ``10^(thr/20)`` with
  exponent 2 ('soft') or 1 ('hard'), ceiling replace >1.0 with
  ``(coeff+1)/2``, restore sign, makeup gain.
* SoftClipper -- ``-(|x|-1)^drive + 1`` on magnitudes, sign restored.
* HardDistortion -- linear below 0.8, then sinusoidal compression; the
  SIGNED hard limit is substituted before the sine, and 0 counts as positive
  (so silence maps to about 0.951).
* BitCrusher -- int32 cast, wrap to int16, FLOOR division by 512, /64.

All are pure elementwise maps; ``step`` runs the plain function, and so
does ``offline`` on a CPU tensor or with ``use_kernels=False``. The fused
tail kernel (``kernels/tail.py``) carries the same four maps in CUDA C++: a
run of two or more tail effects fuses into one of its passes, and a lone
waveshaper's ``offline`` on a CUDA tensor is one launch of it with a
one-stage ``map`` plan (a single pass over the signal, where the plain
function makes about ten).
"""

from __future__ import annotations

import torch

from ..core.config import DEFAULT_DEVICE, EngineConfig, resolve_device
from .base import Effect, host_scalar, params_dataclass


def _stateless(name: str, params, fn, device) -> Effect:
    def init_state(params, batch_shape=()):
        return ()

    def step(params, state, block):
        return state, fn(params, block)

    effect = Effect(name=name, params=params, init_state=init_state,
                    step=step, device=resolve_device(device))
    # imported here: kernels/tail imports this module
    from ..kernels import tail

    return effect._replace(offline=tail.map_offline(effect))


# --------------------------------------------------------------------------
# Saturator


@params_dataclass(meta_fields=("mode",))
class SaturatorParams:
    coeff: torch.Tensor      # 10^(threshold_db/20), host scalar
    makeup: torch.Tensor     # 10^(makeup_db/20), host scalar
    mode: int                # soft=2, hard=1


def saturator(cfg: EngineConfig, threshold_db: float = -20.0,
              makeup_gain_db: float = 2.0, mode: str = "hard",
              device=DEFAULT_DEVICE) -> Effect:
    params = SaturatorParams(
        coeff=host_scalar(10.0 ** (threshold_db / 20.0)),
        makeup=host_scalar(10.0 ** (makeup_gain_db / 20.0)),
        mode={"soft": 2, "hard": 1}[mode],
    )
    return _stateless("saturator", params, _saturate, device)


def _saturate(p: SaturatorParams, x: torch.Tensor) -> torch.Tensor:
    neg = x < 0
    a = torch.abs(x)
    over = a - p.coeff
    ratio = over / (1.0 - p.coeff)
    if p.mode == 2:
        ratio = ratio * ratio
    shaped = p.coeff + over / (1.0 + ratio)
    a = torch.where(a > p.coeff, shaped, a)
    a = torch.where(a > 1.0, (p.coeff + 1.0) / 2.0, a)
    return (p.makeup * torch.where(neg, -a, a)).to(x.dtype)


# --------------------------------------------------------------------------
# SoftClipper


@params_dataclass
class SoftClipperParams:
    drive: torch.Tensor  # user drive + 1, host scalar


def softclipper(cfg: EngineConfig, drive: float = 0.44,
                device=DEFAULT_DEVICE) -> Effect:
    return _stateless("softclipper",
                      SoftClipperParams(drive=host_scalar(drive + 1.0)),
                      _softclip, device)


def _softclip(p: SoftClipperParams, x: torch.Tensor) -> torch.Tensor:
    neg = x < 0
    a = torch.clamp(torch.abs(x), -1.0, 1.0)
    a = -1.0 * torch.pow(torch.abs(a - 1.0), p.drive) + 1.0
    return torch.where(neg, -a, a).to(x.dtype)


# --------------------------------------------------------------------------
# HardDistortion


@params_dataclass
class HardDistortionParams:
    pass


def harddistortion(cfg: EngineConfig, device=DEFAULT_DEVICE) -> Effect:
    return _stateless("harddistortion", HardDistortionParams(), _harddist,
                      device)


def _harddist(p: HardDistortionParams, x: torch.Tensor) -> torch.Tensor:
    hard_limit, linear_limit = 1.0, 0.8
    sign = torch.where(x >= 0, 1.0, -1.0).to(torch.float32)
    amplitude = torch.abs(x)
    # Above the linear region the SIGNED hard limit is substituted before
    # the sine shaping -- a reference quirk, replicated.
    amplitude = torch.where(amplitude <= linear_limit, amplitude,
                            hard_limit * sign)
    scale = hard_limit - linear_limit
    compression = scale * torch.sin(
        (amplitude - linear_limit).to(torch.float32) / scale)
    return ((linear_limit + compression) * sign).to(torch.float32)


# --------------------------------------------------------------------------
# BitCrusher


@params_dataclass
class BitCrusherParams:
    pass


def bitcrusher(cfg: EngineConfig, device=DEFAULT_DEVICE) -> Effect:
    return _stateless("bitcrusher", BitCrusherParams(), _bitcrush, device)


def _bitcrush(p: BitCrusherParams, x: torch.Tensor) -> torch.Tensor:
    # int32 intermediate so out-of-range samples wrap to int16 like numpy's
    # C cast instead of saturating.
    q = (x * 32767.0).to(torch.int32).to(torch.int16)
    q = torch.div(q, 512, rounding_mode="floor")
    return (q / 64.0).to(torch.float32)
