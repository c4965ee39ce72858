"""Compressor and Gate: threshold-triggered envelope automatons.

Counterpart of ``pyaudiodsptools_tpu/ops/dynamics.py``, whose module
docstring derives the automaton from the reference's nested while-loops. In
short: the gain at each sample depends only on the over-threshold mask of
the INPUT and on a small state, never on the output.

* Modes: REST (gain 1) -> on a trigger ATTACK (ramp ``attack_env[x]``,
  advancing unconditionally, ignoring the mask) -> HOLD at the full ratio
  while over -> RELEASE (ramp ``release_env[y]`` on non-over samples).
* A re-trigger during RELEASE re-enters HOLD at the full ratio for that same
  sample.
* When a release completes, exactly one sample is never examined (gain 1
  even if over threshold): the ``skip`` bit.
* The Gate is the same machine with the signal pre-scaled by ``depth`` and
  ramps running 1.0 <-> 1/depth; its mask still comes from the unscaled
  input.

Three paths:

* :func:`step` is the streaming step: one walk of the block from the carried
  4-field state (mode, x, y, skip) through ``kernels/dynamics.cascade_step``
  (on a CUDA tensor one launch of hand-written CUDA that reads and writes the
  four fields itself, on a CPU tensor its plain version), the counterpart of
  the JAX package's
  kernel-backed step (``dynamics_pallas.dynamics_pallas``). Its ramps are
  arithmetic, within 2 ulp of the tables.
* :func:`step_faithful` is the exact counterpart of the JAX package's scan
  ``step``: gains gathered from the float32 ``numpy.linspace`` tables, a
  Python loop over the block's samples vectorised over the batch (a few
  dozen small PyTorch calls per SAMPLE). The tests hold the walks to it; no
  effect runs it.
* :func:`offline` renders a whole signal through the speculative
  segment-parallel walks of ``kernels/dynamics.py``. A lone compressor or
  gate takes this path too; the JAX package's bare ``offline`` falls to a
  serial scan instead.

Params: ``threshold`` and ``pre_gain`` are host scalars, and so are the two
ramps (float32 tensors on the HOST, a few thousand entries): the kernels take
the ramps' end points and slopes by value in their launch arguments, read
from the params once when the effect is built.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import DEFAULT_DEVICE, EngineConfig, resolve_device
from .base import Effect, host_scalar, params_dataclass

REST, ATTACK, HOLD, RELEASE = 0, 1, 2, 3


@params_dataclass(meta_fields=("x_max", "y_max"))
class DynamicsParams:
    threshold: torch.Tensor     # 10^(threshold_db/20), host scalar
    pre_gain: torch.Tensor      # 1.0 (compressor) or depth (gate), host scalar
    attack_env: torch.Tensor    # (x_max,) float32 ramp 1.0 -> end gain, host
    release_env: torch.Tensor   # (y_max,) float32 ramp end gain -> 1.0, host
    x_max: int
    y_max: int


def compressor(cfg: EngineConfig, threshold_db: float = -15.0,
               ratio: float = 0.60, attack_ms: float = 3.1,
               release_ms: float = 30.1, device=DEFAULT_DEVICE) -> Effect:
    """CreateCompressor parity. ``ratio`` is a gain multiplier in (0, 1), not
    a classic N:1 ratio."""
    x_max = cfg.ms_to_samples(attack_ms)
    y_max = cfg.ms_to_samples(release_ms)
    params = DynamicsParams(
        threshold=host_scalar(np.float32(10.0 ** (threshold_db / 20.0))),
        pre_gain=host_scalar(1.0),
        attack_env=torch.from_numpy(
            np.linspace(1.0, ratio, num=x_max, dtype=np.float32)),
        release_env=torch.from_numpy(
            np.linspace(ratio, 1.0, num=y_max, dtype=np.float32)),
        x_max=x_max, y_max=y_max)
    return make_effect("compressor", params, device)


def gate(cfg: EngineConfig, threshold_db: float = -5.0, depth: float = 0.1,
         attack_ms: float = 3.1, release_ms: float = 200.1,
         device=DEFAULT_DEVICE) -> Effect:
    """CreateGate parity. The envelope lengths follow ``cfg.sample_rate``
    (the reference hard-codes 44100 Hz), as in the JAX package."""
    x_max = cfg.ms_to_samples(attack_ms)
    y_max = cfg.ms_to_samples(release_ms)
    inv = 1.0 / depth
    params = DynamicsParams(
        threshold=host_scalar(np.float32(10.0 ** (threshold_db / 20.0))),
        pre_gain=host_scalar(np.float32(depth)),
        attack_env=torch.from_numpy(
            np.linspace(1.0, inv, num=x_max, dtype=np.float32)),
        release_env=torch.from_numpy(
            np.linspace(inv, 1.0, num=y_max, dtype=np.float32)),
        x_max=x_max, y_max=y_max)
    return make_effect("gate", params, device)


def make_effect(name: str, params: DynamicsParams, device) -> Effect:
    from ..kernels.dynamics import op_scalars

    dev = resolve_device(device)
    own_params = params
    own_scalars = [op_scalars(params)]      # read from the params once

    def init_on_device(params: DynamicsParams,
                       batch_shape: tuple[int, ...] = ()):
        return init_state(params, batch_shape, dev)

    def step_with_scalars(params: DynamicsParams, state, block: torch.Tensor):
        return step(params, state, block,
                    own_scalars if params is own_params else None)

    return Effect(name=name, params=params, init_state=init_on_device,
                  step=step_with_scalars, offline=offline,
                  time_parallel=False, device=dev)


def init_state(params: DynamicsParams, batch_shape: tuple[int, ...], device):
    """REST everywhere, on ``device`` (the effect's own: :func:`make_effect`)."""
    shape = tuple(batch_shape)
    return {
        "mode": torch.full(shape, REST, dtype=torch.int32, device=device),
        "x": torch.zeros(shape, dtype=torch.int32, device=device),
        "y": torch.zeros(shape, dtype=torch.int32, device=device),
        "skip": torch.zeros(shape, dtype=torch.bool, device=device),
    }


def _automaton_step(x_max: int, y_max: int, attack_env, release_env, carry,
                    over):
    """One sample: (carry, over-mask) -> (carry, gain). Branchless,
    elementwise over any batch shape; the transitions are those of the JAX
    package's ``_automaton_step``, in its order."""
    mode, x, y, skip = carry
    ratio_gain = attack_env[x_max - 1]

    att_g = attack_env[torch.clamp(x, max=x_max - 1).long()]
    rel_g = release_env[torch.clamp(y, max=y_max - 1).long()]

    is_rest = mode == REST
    is_att = mode == ATTACK
    is_hold = mode == HOLD
    is_rel = mode == RELEASE
    live = ~skip
    one = torch.ones_like(att_g)

    gain = torch.where(
        is_att, att_g,
        torch.where(is_hold | is_rel, torch.where(over, ratio_gain, rel_g),
                    one))
    gain = torch.where(skip, one, gain)

    # REST: a trigger starts the attack at env[0] (== 1.0), x advances to 1.
    trig = is_rest & over & live
    n_mode = torch.where(trig, HOLD if x_max == 1 else ATTACK, mode)
    n_x = torch.where(trig, 1, x)

    # ATTACK: advance unconditionally; finish -> HOLD.
    adv = is_att & live
    n_x = torch.where(adv, x + 1, n_x)
    n_mode = torch.where(adv & (x + 1 >= x_max), HOLD, n_mode)

    # HOLD: stays while over; a non-over sample is the first release sample.
    to_rel = is_hold & ~over & live
    # RELEASE non-over: the ramp advances.
    rel_adv = (is_rel & ~over & live) | to_rel
    n_y = torch.where(rel_adv, y + 1, y)
    n_x = torch.where(rel_adv, 0, n_x)
    n_mode = torch.where(rel_adv, RELEASE, n_mode)
    # Release completes: back to REST, and the next sample is skipped.
    done = rel_adv & (y + 1 >= y_max)
    n_mode = torch.where(done, REST, n_mode)
    n_x = torch.where(done, 0, n_x)
    n_y = torch.where(done, 0, n_y)
    n_skip = done

    # RELEASE re-trigger: that sample already got ratio_gain; re-enter HOLD.
    re_trig = is_rel & over & live
    n_mode = torch.where(re_trig, HOLD, n_mode)
    n_x = torch.where(re_trig, x_max, n_x)
    n_y = torch.where(re_trig, 0, n_y)

    # skip consumes itself.
    n_skip = n_skip & live
    return (n_mode, n_x, n_y, n_skip), gain


def step(params: DynamicsParams, state, block: torch.Tensor, scalars=None):
    """The streaming step: one serial walk of the block from ``state``.
    ``scalars`` are the walk's scalars of ``params`` where the caller has
    read them before (an effect's own ``step`` has)."""
    from ..kernels.dynamics import cascade_step, op_scalars

    (new_state,), out = cascade_step(scalars or [op_scalars(params)],
                                     (params,), (state,), block)
    return new_state, out


def step_faithful(params: DynamicsParams, state, block: torch.Tensor):
    """The table-driven per-sample step (see the module docstring): the
    tests' reference for the walks."""
    dev = block.device
    attack_env = params.attack_env.to(dev)
    release_env = params.release_env.to(dev)
    over = torch.abs(block) > params.threshold
    carry = (state["mode"], state["x"], state["y"], state["skip"])
    gains = []
    for i in range(block.shape[-1]):
        carry, g = _automaton_step(params.x_max, params.y_max, attack_env,
                                   release_env, carry, over[..., i])
        gains.append(g)
    gains = torch.stack(gains, dim=-1) if gains \
        else torch.ones_like(block)
    out = (block * params.pre_gain * gains).to(torch.float32)
    mode, x, y, skip = carry
    return {"mode": mode.to(torch.int32), "x": x.to(torch.int32),
            "y": y.to(torch.int32), "skip": skip}, out


def offline(params: DynamicsParams, blocks: torch.Tensor,
            use_kernels: bool = True) -> torch.Tensor:
    """Whole-signal render from REST through the speculative walks: the
    automaton is chunk-size independent, so the blocks are one signal."""
    from ..kernels.dynamics import offline_blocks

    return offline_blocks([params], blocks, use_kernels)
